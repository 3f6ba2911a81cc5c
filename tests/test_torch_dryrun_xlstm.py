"""The dry run's xLSTM cells (``repro_torch/launch/dryrun.py``:
``loops_over_tokens``, ``scaled_count``) on the CPU, on meta, at the
reduced xLSTM (``mlstm_chunk`` 8).

The sLSTM loop runs once a token and the mLSTM loop once a chunk, so a
full trace at ``train_4k`` or ``prefill_32k`` walks every token; the dry
run counts short traces and scales them in the loops' trip counts. Held
here: the train step's traffic is affine in the length (each loop takes
its slices once: no select or slice backward per token), the scaled
count equals a full trace at a held-out length and depth (FLOPs, bytes,
ops and peak live bytes, exactly) for a train and a prefill step with no
mesh and on a (2, 2) mesh, ``run_cell`` takes the scaled path for an
xLSTM cell and writes the reference's keys, the meta cache of
``core/op_count.py`` changes no count, and phase ``dryrun``'s CPU form
holds the new ``train_xlstm`` step to its scaled count.
"""
import collections
import dataclasses
import os
import sys

import pytest

from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import op_count as oc
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import StepOptions
from torch_train_helpers import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
MESH = ((2, 2), ("data", "model"))
W = 8                                    # reduced() mlstm_chunk


def xlstm(units):
    base = reduced(get_arch("xlstm-350m"))
    assert base.mlstm_chunk == W
    return dataclasses.replace(base, num_layers=units * base.repeat_unit)


def kinds_of(cfg, shape, opts, monkeypatch):
    """The trace's count and its ops by kind, as ``op_count`` sees them."""
    seen = collections.Counter()
    run = oc._Counter.__torch_dispatch__

    def counted(self, func, types, args=(), kwargs=None):
        seen[str(func.overloadpacket)] += 1
        return run(self, func, types, args, kwargs)
    with monkeypatch.context() as m:
        m.setattr(oc._Counter, "__torch_dispatch__", counted)
        count = dryrun._trace(cfg, shape, None, opts)
    return count, seen


def test_train_traffic_is_affine_in_the_length(monkeypatch):
    """Bytes at S, 2S and 3S lie on a line, and no select or slice
    backward runs once a token: their counts grow by at most one a
    chunk (the mLSTM carry's last-position select, of a chunk's size)."""
    cfg = xlstm(1)
    got = {S: kinds_of(cfg, ShapeConfig("t", S, 4, "train"),
                       StepOptions(), monkeypatch) for S in (16, 32, 48)}
    b = {S: c.bytes for S, (c, _) in got.items()}
    assert b[32] - b[16] == b[48] - b[32] > 0
    for op in ("aten.select_backward", "aten.slice_backward"):
        n = [got[S][1][op] for S in (16, 32, 48)]
        assert n[2] - n[1] == n[1] - n[0] <= 16 // W, (op, n)
    assert got[48][1]["aten.unbind"] > 0        # each loop's slices


SCALED = {
    # held-out length and depth; the loss chunk 16 makes S chunk the loss
    # where the short traces (16, 24 tokens) do not
    "train": (ShapeConfig("t", 48, 4, "train"), 3,
              StepOptions(loss_chunk=16), None),
    "train_2x2": (ShapeConfig("t", 48, 4, "train"), 3,
                  StepOptions(loss_chunk=16), MESH),
    "train_no_remat": (ShapeConfig("t", 40, 4, "train"), 3,
                       StepOptions(remat=False), None),
    "prefill": (ShapeConfig("p", 56, 4, "prefill"), 4, StepOptions(), None),
    "prefill_2x2": (ShapeConfig("p", 56, 4, "prefill"), 4, StepOptions(),
                    MESH),
}


@pytest.mark.parametrize("case", SCALED)
def test_scaled_count_equals_full_trace(case):
    shape, units, opts, mesh = SCALED[case]
    cfg = xlstm(units)
    mesh = make_mesh(*mesh, device="meta") if mesh else None
    assert dryrun.loops_over_tokens(cfg, shape)
    got, traces = dryrun.scaled_count(cfg, shape, mesh, opts)
    full = dryrun._trace(cfg, shape, mesh, opts)
    assert traces == 7
    assert (got.flops, got.bytes, got.ops, got.peak_bytes) == \
        (full.flops, full.bytes, full.ops, full.peak_bytes)


def test_only_token_loop_stacks_are_scaled():
    train = ShapeConfig("t", 48, 4, "train")
    assert dryrun.loops_over_tokens(xlstm(1), train)
    assert not dryrun.loops_over_tokens(xlstm(1), ShapeConfig(
        "d", 48, 4, "decode"))
    assert not dryrun.loops_over_tokens(xlstm(1), ShapeConfig(
        "t", 20, 4, "train"))                  # not whole chunks
    for arch in ("recurrentgemma-9b", "llama3.2-1b", "whisper-large-v3"):
        assert not dryrun.loops_over_tokens(reduced(get_arch(arch)), train)
    for S in (44, 16):                 # not whole chunks; under three
        with pytest.raises(ValueError, match="whole chunks"):
            dryrun.scaled_count(xlstm(1), ShapeConfig("t", S, 4, "train"),
                                None, StepOptions())


def test_run_cell_takes_the_scaled_path(monkeypatch):
    """``run_cell`` on an xLSTM train cell (the reduced config on (2, 2))
    counts through ``scaled_count`` and writes the reference's keys."""
    cfg = xlstm(3)
    calls = []
    scaled = dryrun.scaled_count

    def spy(*a, **k):
        calls.append(a[1].seq_len)
        return scaled(*a, **k)
    monkeypatch.setattr(dryrun, "scaled_count", spy)
    monkeypatch.setattr(dryrun, "get_arch", lambda a: cfg)
    monkeypatch.setattr(dryrun, "get_shape",
                        lambda s: ShapeConfig(s, 48, 4, "train"))
    d = dryrun.run_cell("xlstm-350m", "train_4k", False,
                        mesh=make_mesh(*MESH, device="meta"), verbose=False)
    assert calls == [48]
    assert set(d) == {"arch", "shape", "mesh", "n_chips", "lower_s",
                      "compile_s", "memory", "roofline", "model_flops",
                      "useful_flops_ratio", "collective_schedule"}
    assert set(d["memory"]) == {"argument_bytes", "output_bytes",
                                "temp_bytes", "alias_bytes", "peak_bytes",
                                "analytic_peak_bytes", "fits_hbm",
                                "fits_hbm_analytic"}
    assert (d["mesh"], d["n_chips"]) == ("2x2", 4)
    full = dryrun._trace(cfg, ShapeConfig("t", 48, 4, "train"),
                         make_mesh(*MESH, device="meta"),
                         StepOptions(flash_threshold=2048, loss_chunk=512))
    assert d["roofline"]["flops"] == full.flops / 4
    assert d["roofline"]["bytes"] == full.bytes / 4
    assert d["memory"]["temp_bytes"] == full.peak_bytes // 4


CACHE = {
    "llama_train": ("llama3.2-1b", ShapeConfig("t", 32, 4, "train"), None),
    "whisper_train": ("whisper-large-v3", ShapeConfig("t", 16, 2, "train"),
                      None),
    "granite_train_2x2": ("granite-moe-3b-a800m",
                          ShapeConfig("t", 16, 4, "train"), MESH),
    "xlstm_prefill": ("xlstm-350m", ShapeConfig("p", 24, 2, "prefill"),
                      None),
}


@pytest.mark.parametrize("case", CACHE)
def test_meta_cache_changes_no_count(case, monkeypatch):
    """A trace with ``_Counter``'s meta cache and one that runs every
    op's meta function: the same FLOPs, bytes, ops, collectives, peak
    and per-site peaks (``_unsafe_view``'s shared storage, a host 0-d
    optimizer step beside meta tensors)."""
    arch, shape, mesh = CACHE[case]
    cfg = reduced(get_arch(arch))
    mesh = make_mesh(*mesh, device="meta") if mesh else None
    opts = StepOptions()
    dryrun._trace(cfg, shape, mesh, opts)      # the mesh's tables made
    got = []
    for cached in (True, False):
        with monkeypatch.context() as m:
            if not cached:
                m.setattr(oc._Counter, "_run",
                          lambda self, func, args, kwargs: func(*args,
                                                                **kwargs))
            c = dryrun._trace(cfg, shape, mesh, opts, sites=True)
        got.append((c.flops, c.bytes, c.ops, c.peak_bytes, len(c.events),
                    c.site_peaks))
    assert got[0] == got[1]


def test_chip_smoke_dryrun_phase_takes_the_xlstm_step(monkeypatch):
    """Phase ``dryrun``'s CPU form builds ``train_xlstm`` (the reduced
    xLSTM, two units, 4 x 32) and holds its scaled count to the count on
    the device and to the dry run's full trace."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    steps = chip_smoke._dryrun_steps("cpu", True)
    label, build, scaled = steps[-1]
    assert label.startswith("train_xlstm") and scaled is not None
    cfg, shape = scaled
    assert dryrun.loops_over_tokens(cfg, shape)
    held = []
    run = chip_smoke._scaled_held

    def spy(*a):
        held.append(a[0])
        return run(*a)
    monkeypatch.setattr(chip_smoke, "_scaled_held", spy)
    fn, args, meta_fn = build()
    chip_smoke._held_to_card(label, fn, args, meta_fn, "cpu", "cpu", scaled)
    assert held == [label]


def test_flash_blocks_are_taken_once(monkeypatch):
    """The blocked attention of a train step past ``flash_threshold``
    (``models/layers.py::_flash_attention``) takes its query and key
    blocks by one split each: its output and gradients equal the dense
    attention's, and its backward writes no zeroed gradient of a whole
    input per block (no slice backward)."""
    import torch
    from repro_torch.models import layers
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 32, 2, 2, 8), generator=g, requires_grad=True)
    k = torch.randn((2, 32, 2, 8), generator=g, requires_grad=True)
    v = torch.randn((2, 32, 2, 8), generator=g, requires_grad=True)
    pos = torch.arange(32)
    args = (pos, pos, "attn", 0, 0, True, 8 ** -0.5)
    seen = collections.Counter()
    run = oc._Counter.__torch_dispatch__

    def counted(self, func, types, a=(), kw=None):
        seen[str(func.overloadpacket)] += 1
        return run(self, func, types, a, kw)
    monkeypatch.setattr(oc._Counter, "__torch_dispatch__", counted)
    with oc.op_count():
        out = layers._flash_attention(q, k, v, *args, kv_block=8, q_block=8)
        grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    want = layers._dense_attention(q, k, v, *args)
    wgrads = torch.autograd.grad(want.square().sum(), (q, k, v))
    assert torch.allclose(out, want, atol=1e-5)
    for a, b in zip(grads, wgrads):
        assert torch.allclose(a, b, atol=1e-4)
    assert seen["aten.slice_backward"] == 0 and seen["aten.split"] > 0


def test_step_time_on_the_cpu():
    """``launch/step_time.py``, the full-depth step record's script, at the
    reduced xLSTM on the CPU: its record's keys and one timed step."""
    import json
    from repro_torch.launch import step_time
    rec = json.loads(json.dumps(step_time.step_time(xlstm(1), 16, 2, steps=1,
                                                    device="cpu")))
    assert set(rec) == {"arch", "layers", "batch", "seq", "ms", "times_ms",
                        "max_memory_allocated", "card"}
    assert rec["layers"] == 2 and len(rec["times_ms"]) == 1
    assert rec["ms"] > 0 and rec["max_memory_allocated"] is None
