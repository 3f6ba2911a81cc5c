"""The port's checkpoints, on the CPU: the reference's own checkpoint
tests on the port (round trip, the hypothesis property, no tmp file left,
retention, a missing checkpoint, the shape check), and the file format
across the packages — a checkpoint the JAX package writes restores in the
port bit for bit, and the reverse, bf16 leaves, the int32 step and the
manifest included."""
import pathlib
import tempfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")       # optional test dep: skip, not error
from hypothesis import given, settings, strategies as st

from repro.train.checkpoint import latest_step as jlatest
from repro.train.checkpoint import restore_checkpoint as jrestore
from repro.train.checkpoint import save_checkpoint as jsave
from repro_torch.train import (latest_step, restore_checkpoint,
                               save_checkpoint)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [tree]


def _state():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.randn((2, 2),
                                        generator=torch.Generator()
                                        .manual_seed(0)).to(torch.bfloat16),
                       "step": torch.tensor(7, dtype=torch.int32)}}


def test_roundtrip_identity(tmp_path):
    state = _state()
    save_checkpoint(tmp_path, 5, state)
    restored, step = restore_checkpoint(tmp_path, state)
    assert step == 5
    for a, b in zip(_leaves(state), _leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@given(st.lists(st.floats(-1e6, 1e6, width=32), min_size=1, max_size=32),
       st.integers(0, 10**6))
@settings(max_examples=25, deadline=None)
def test_roundtrip_property(vals, step):
    state = {"w": torch.tensor(vals, dtype=torch.float32),
             "h": torch.tensor(vals, dtype=torch.float32).to(torch.bfloat16)}
    with tempfile.TemporaryDirectory() as td:
        save_checkpoint(td, step, state)
        restored, s = restore_checkpoint(td, state)
        assert s == step
        for k in state:
            assert torch.equal(restored[k], state[k])


def test_no_tmp_files_left(tmp_path):
    save_checkpoint(tmp_path, 1, {"w": torch.ones(3)})
    assert not list(pathlib.Path(tmp_path).glob("*.tmp"))


def test_retention(tmp_path):
    for s in range(6):
        save_checkpoint(tmp_path, s, {"w": torch.ones(3)}, keep=3)
    ckpts = sorted(pathlib.Path(tmp_path).glob("step_*.npz"))
    assert [c.name for c in ckpts] == [f"step_{s:08d}.npz" for s in (3, 4, 5)]
    assert latest_step(tmp_path) == 5


def test_restore_missing_returns_none(tmp_path):
    state, step = restore_checkpoint(tmp_path, {"w": torch.ones(3)})
    assert state is None and step is None


def test_restore_shape_checked(tmp_path):
    save_checkpoint(tmp_path, 1, {"w": torch.ones((4, 4))})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(tmp_path, {"w": torch.ones((2, 4))})


def test_restore_picks_step_and_places_like(tmp_path):
    """An older step on request; each leaf takes ``state_like``'s dtype."""
    for s in (1, 2):
        save_checkpoint(tmp_path, s, {"w": torch.full((3,), float(s))})
    got, step = restore_checkpoint(tmp_path, {"w": torch.zeros(
        3, dtype=torch.float64)}, step=1)
    assert step == 1 and got["w"].dtype == torch.float64
    assert torch.equal(got["w"], torch.ones(3, dtype=torch.float64))


def _pair_state(seed=0):
    """The same values as a JAX tree and a torch tree: f32, bf16, int32."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((3, 5)).astype(np.float32)
    h = rng.standard_normal((2, 7)).astype(ml_dtypes.bfloat16)
    jstate = {"params": {"blocks": {"s0": {"w": jnp.asarray(f),
                                           "h": jnp.asarray(h)}}},
              "opt": {"step": jnp.int32(9)}}
    tstate = {"params": {"blocks": {"s0": {
        "w": torch.from_numpy(f.copy()),
        "h": torch.from_numpy(h.astype(np.float32)).to(torch.bfloat16)}}},
        "opt": {"step": torch.tensor(9, dtype=torch.int32)}}
    return jstate, tstate


def _bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def test_reference_checkpoint_restores_in_port(tmp_path):
    jstate, tstate = _pair_state()
    jsave(tmp_path, 3, jstate)
    like = {"params": {"blocks": {"s0": {k: torch.zeros_like(v) for k, v in
                                         tstate["params"]["blocks"]["s0"]
                                         .items()}}},
            "opt": {"step": torch.zeros((), dtype=torch.int32)}}
    got, step = restore_checkpoint(tmp_path, like)
    assert step == 3 == latest_step(tmp_path)
    for a, b in zip(_leaves(got), _leaves(tstate)):
        assert a.dtype == b.dtype
        assert np.array_equal(_bits(a), _bits(b))


def test_port_checkpoint_restores_in_reference(tmp_path):
    jstate, tstate = _pair_state(1)
    save_checkpoint(tmp_path, 4, tstate)
    like = jax.tree.map(jnp.zeros_like, jstate)
    got, step = jrestore(tmp_path, like)
    assert step == 4 == jlatest(tmp_path)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jstate)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        if a.dtype == ml_dtypes.bfloat16:
            a, b = a.view(np.uint16), b.view(np.uint16)
        assert np.array_equal(a, b)


def test_file_keys_and_types_equal_reference(tmp_path):
    """The two packages write the same keys, dtypes and bytes."""
    jstate, tstate = _pair_state(2)
    jsave(tmp_path / "j", 1, jstate)
    save_checkpoint(tmp_path / "t", 1, tstate)
    with np.load(tmp_path / "j" / "step_00000001.npz") as j, \
            np.load(tmp_path / "t" / "step_00000001.npz") as t:
        assert sorted(j.files) == sorted(t.files) == [
            "opt/step", "params/blocks/s0/h", "params/blocks/s0/w"]
        for k in j.files:
            assert j[k].dtype == t[k].dtype and j[k].shape == t[k].shape
            assert np.array_equal(j[k], t[k])
    assert (tmp_path / "j" / "manifest.json").read_text() == (
        tmp_path / "t" / "manifest.json").read_text()
