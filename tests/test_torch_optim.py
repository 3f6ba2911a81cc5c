"""The port's AdamW against the JAX package's, on the CPU: the schedule,
three steps on a random tree of float32 and bfloat16 leaves with and
without clipping, and the optimizer state's ZeRO specs for every config.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance, max-abs-normalised: 1e-6 for the parameters, ``m``, ``v``,
``master`` and the gradient norm (float32 on both sides; the port's
in-place update folds the decay and the bias correction into its
multiplies, a rounding or two apart). A bf16 parameter is the f32 master
rounded: held at one bf16 step where a rounding tie could tip.
"""
import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.dist.sharding import P as JP
from repro.dist.sharding import Rules as JRules
from repro.dist.sharding import sanitize_specs as jsanitize
from repro.dist.sharding import zero_spec as jzero
from repro.models import init_params as jinit
from repro.models import param_specs as jparam_specs
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_update as jadamw
from repro.optim import init_opt_state as jinit_opt
from repro.optim import lr_at as jlr_at
from repro.optim import opt_state_specs as jopt_specs
from repro_torch.configs import get_arch, reduced
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.dist.sharding import P, Rules, sanitize_specs, zero_spec
from repro_torch.models import init_params, param_specs
from repro_torch.models.model import ShapeDtype
from repro_torch.optim import (AdamWConfig, adamw_update, init_opt_state,
                               lr_at, opt_state_specs)
from torch_port_helpers import rel_err

SCHED = dict(peak_lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)


@pytest.mark.parametrize("step", [0, 3, 10, 40, 55, 99, 100, 250])
def test_lr_schedule_equals_reference(step):
    """Warm-up, the start of the decay, mid-decay and past the end."""
    got, want = lr_at(AdamWConfig(**SCHED), step), float(
        jlr_at(JAdamW(**SCHED), step))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def draw(shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"w": draw((4, 8)), "blocks": {"b": draw((3, 5)),
                                          "h": draw((16,))}}


HALF = ("blocks", "h")          # the bf16 leaf


def _cast(tree, path=()):
    if isinstance(tree, dict):
        return {k: _cast(v, path + (k,)) for k, v in tree.items()}
    return tree.astype(ml_dtypes.bfloat16) if path == HALF else tree


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(tree.copy())


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return np.asarray(tree, np.float32)


def _pairs(a, b, path=()):
    if isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k], path + (k,))
    else:
        yield path, a, b


@pytest.mark.parametrize("clip", [1e9, 0.5])
def test_three_steps_equal_reference(clip):
    """Three updates with new gradients each step, f32 and bf16 leaves;
    ``clip`` 0.5 clips every step (the gradients' norm is about 24)."""
    cfg = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10,
               clip_norm=clip, weight_decay=0.1)
    params = _cast(_tree(0))
    jp, tp = jax_tree(params), _torch(params)
    js, ts = jinit_opt(jp), init_opt_state(tp)
    for step in range(3):
        g = _cast(_tree(step + 1, scale=3.0))
        jp, js, jn = jadamw(jp, jax_tree(g), js, JAdamW(**cfg))
        tp, ts, tn = adamw_update(tp, _torch(g), ts, AdamWConfig(**cfg))
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        if clip < 1:
            assert float(tn) > clip
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for name in ("m", "v", "master"):
            for path, got, want in _pairs(_np(ts[name]), _np(js[name])):
                assert rel_err(got, want) <= 1e-6, (step, name, path)
        for path, got, want in _pairs(_np(tp), _np(jp)):
            if path == HALF:
                assert tp["blocks"]["h"].dtype == torch.bfloat16
                assert np.max(np.abs(got - want)) <= 2 ** -8 * np.max(
                    np.abs(want)), step
            else:
                assert rel_err(got, want) <= 1e-6, (step, path)


def jax_tree(tree):
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def test_adamw_matches_numpy_reference():
    """The reference's own numpy check, on the port."""
    cfg = AdamWConfig(peak_lr=1e-2, warmup_steps=0, clip_norm=1e9,
                      weight_decay=0.1)
    w = np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32)
    g = np.random.default_rng(1).standard_normal((4, 8)).astype(np.float32)
    g = g / np.linalg.norm(g) * 0.1          # below clip
    params = {"w": torch.from_numpy(w.copy())}
    new_p, new_s, _ = adamw_update(params, {"w": torch.from_numpy(g)},
                                   init_opt_state(params), cfg)
    lr = lr_at(cfg, 1)
    m = (1 - cfg.b1) * g
    v = (1 - cfg.b2) * g * g
    w_ref = w - lr * ((m / (1 - cfg.b1)) / (np.sqrt(v / (1 - cfg.b2))
                                            + cfg.eps) + cfg.weight_decay * w)
    np.testing.assert_allclose(new_p["w"].numpy(), w_ref, rtol=1e-5)
    np.testing.assert_allclose(new_s["m"]["w"].numpy(), m, rtol=1e-5)
    np.testing.assert_allclose(new_s["v"]["w"].numpy(), v, rtol=1e-5)


def test_global_norm_clip_and_state_types():
    cfg = AdamWConfig(clip_norm=1.0, warmup_steps=0, weight_decay=0.0,
                      peak_lr=1.0)
    params = {"w": torch.zeros((4,)), "h": torch.ones((8,),
                                                       dtype=torch.bfloat16)}
    state = init_opt_state(params)
    assert state["master"]["h"].dtype == torch.float32
    assert state["step"].dtype == torch.int32 and state["step"].dim() == 0
    new_p, new_s, gnorm = adamw_update(
        params, {"w": torch.full((4,), 100.0),
                 "h": torch.zeros((8,), dtype=torch.bfloat16)}, state, cfg)
    assert float(gnorm) == pytest.approx(200.0)
    assert new_p["h"].dtype == torch.bfloat16
    assert new_s["master"]["h"].dtype == torch.float32


class FakeMesh:
    """The reference's ``Rules`` reads only a mesh's axis names and sizes
    (its own optimizer test builds one the same way)."""
    axis_names = ("data", "model")

    def __init__(self, shape):
        self.shape = dict(zip(self.axis_names, shape))


def _shape_tree(tree):
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    return ShapeDtype(tuple(tree.shape), None)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
@pytest.mark.parametrize("name", sorted(JARCHS))
def test_opt_state_specs_equal_reference(name, shape):
    """Every config, reduced (the port's own init shapes, pad_to the model
    axis so the vocab and experts divide) and at its published widths (the
    reference's abstract shapes): ``sanitize_specs`` then
    ``opt_state_specs`` under a data x model ``Rules``."""
    import jax
    jrules = JRules(FakeMesh(shape), "train")
    trules = Rules(VirtualMesh(shape, axes=("data", "model"), device="cpu"),
                   "train")
    for cfg in (jreduced(JARCHS[name], pad_to=shape[1]), JARCHS[name]):
        sds = jax.eval_shape(lambda k: jinit(k, cfg), jax.random.PRNGKey(0))
        want = jopt_specs(jsanitize(jparam_specs(cfg, jrules), sds,
                                    jrules.mesh), sds, jrules)
        tcfg = dataclasses.replace(get_arch(name), **{
            f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
        if cfg is JARCHS[name]:
            shapes = _shape_tree(sds)
        else:
            shapes = _shape_tree(init_params(torch.Generator().manual_seed(0),
                                             tcfg, device="cpu"))
            assert shapes == _shape_tree(sds)
        got = opt_state_specs(sanitize_specs(param_specs(tcfg, trules),
                                             shapes, trules.mesh),
                              shapes, trules)
        assert sorted(got) == ["m", "master", "step", "v"]
        assert got["step"] == P() == JP()
        for k in ("m", "v", "master"):
            flat = list(_pairs(got[k], jax.tree.map(
                tuple, want[k], is_leaf=lambda s: isinstance(s, JP))))
            assert flat and all(tuple(a) == b for _, a, b in flat), k


def test_zero_spec_adds_data_axis():
    """The reference's ``zero_spec`` cases, on the port's."""
    rules = Rules(VirtualMesh((4, 2), axes=("data", "model"), device="cpu"))
    assert zero_spec(P(None, "model"), (64, 32), rules) == P("data", "model")
    assert zero_spec(P("data", None), (64, 32), rules) == P("data", None)
    assert zero_spec(P(None, "model"), (3, 32), rules) == P(None, "model")
    jrules = JRules(FakeMesh((4, 2)), "train")
    for spec, shape in (((None, "model"), (64, 32)), (("data", None),
                                                      (64, 32))):
        assert tuple(zero_spec(P(*spec), shape, rules)) == tuple(
            jzero(JP(*spec), shape, jrules))
