"""The serving-tier suite at 4 ranks (port of
``tests/scripts/serving_suite.py``): the acceptance gate of the kernelized
serving path.

* The ``serving_step`` cascade reaches l3 for the TokenWeave, FLUX and
  DeepEP (NVL) points at the reduced instance (96 tokens a rank, d 128,
  f = fs = 192; l2 through ``moe_dispatch.cu`` on the card).
* The two-stream kernel: the shared-expert FFN is issued against the open
  dispatch window (on the CPU the probe's marks ``dispatch_issued``,
  ``shared_ffn``, ``dispatch_drained`` in that order; on the card, where
  the second stream has CTAs of its own, the probe build's marks with
  ``shared_ffn`` before ``dispatch_drained`` and its log held to the
  window contract) and the output is within 2e-3 of the routed + shared
  oracle.
* At the full serving shape (4 x 256 tokens, d 7168, f = fs 2048): four
  modeled rows through :func:`~repro_torch.suites.common.write_rows`,
  each point valid, its timeline's critical path equal to
  ``analytic_cost`` and its cost no more than the host's. On the
  reference's ``V5E`` the rows are the reference's checked-in
  ``BENCH_serving.json``.
* The reduced llama4 engine (4 experts, top-1, capacity 16) on a data
  mesh of 4 under ``moe_backend="pallas"`` emits the host body's greedy
  tokens through ``serve`` (``Scheduler(token_budget=16, max_batch=4)``):
  3 decode steps, 12 tokens, 4 finished.
* The reduced llama3.2-1b ``prefill_remote`` over a 2-rank shuttle mesh
  (``kv_shuttle.cu`` on the card) hands over the cache bit for bit, for
  the chained and the fused-counter shuttles.
* Rank 3 dropped at step 1 through ``ElasticController`` and
  ``Engine.degrade``: the pallas degrade onto 2 ranks raises (the kernel
  takes one expert a data rank; by design the port never falls back on
  its own), the engine switches to the xla body in the open and degrades,
  and all four requests complete: 12 tokens, 1 degrade, survivors (0, 1,
  2).

    PYTHONPATH=src python -m repro_torch.suites.serving --device cuda \
        [--chip v5e] [--out build/suites/BENCH_serving.json]
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core.cascade import Candidate, CascadeEvaluator, _full_f32
from repro_torch.core.design_space import CONSERVATIVE, EXPERT_SYSTEMS
from repro_torch.core.hardware import H100, extract_hardware_context
from repro_torch.core.trace import (ScheduleProbe, schedule_timeline,
                                    validate_trace)
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.dist.sharding import Rules
from repro_torch.models import StepOptions, init_params
from repro_torch.serve import Engine, Request, Scheduler, ServeConfig
from repro_torch.suites import common
from repro_torch.train import ElasticController
from repro_torch.workloads import get_workload

ARTIFACT = "BENCH_serving.json"
FLUX = EXPERT_SYSTEMS["FLUX"]
REDUCED = dict(n_dev=4, tokens_per_rank=96, d=128, f=192, f_shared=192)
POINTS = ("TokenWeave", "FLUX", "DeepEP (NVL)")
ROWS = (("host_sequential", CONSERVATIVE),
        ("tokenweave_stream_split", EXPERT_SYSTEMS["TokenWeave"]),
        ("deepep_nvl_deferred", EXPERT_SYSTEMS["DeepEP (NVL)"]),
        ("flux_two_stream", FLUX))
MARKS = ["dispatch_issued", "shared_ffn", "dispatch_drained"]


def cascade(mesh, hw):
    """The three overlap points of the reduced serving step to l3;
    ``{point: (level, l2 ms)}``."""
    ev = CascadeEvaluator(get_workload("serving_step", **REDUCED), mesh, hw)
    out = {}
    for name in POINTS:
        res = ev.evaluate(Candidate(directive=EXPERT_SYSTEMS[name]))
        common.require(res.level == 3 and res.score > 0,
                       f"cascade {name}: level {res.level}: "
                       f"{res.diagnostic}")
        out[name] = (res.level, res.record.levels_s["l2"] * 1e3)
    return out


def two_stream(mesh):
    """The kernel's second stream inside the send window, against the
    routed + shared oracle. On the CPU the probe records the reference's
    order of marks. On the card the second stream runs on CTAs of its own
    from the launch on, so the marks come in the order of their times and
    ``shared_ffn`` may precede ``dispatch_issued``: what the reference's
    order asserts, the shared FFN running while dispatch sends are in
    flight, is that it opens before ``dispatch_drained``, and the probe
    build's log is held to the window contract (``check_log``). Returns
    (error, marks)."""
    from repro_torch.kernels import moe_dispatch as kern
    w = get_workload("serving_step", **REDUCED)
    x, w1, w2, s1, s2 = w.example_inputs(7, mesh)
    probe = ScheduleProbe()
    k = w.kernel_knobs(FLUX)
    knobs = dict(counts=[int(c) for c in w._counts(x.shape[1])],
                 block_tokens=k["block_tokens"], tight=k["tight"],
                 pipelined=k["pipelined"], barrier=k["barrier"],
                 tile_fused=k["tile_fused"], combine_tile=k["combine_tile"],
                 contexts=k["contexts"], wire_i8=False, shared=(x, s1, s2))
    with torch.no_grad(), _full_f32(mesh.device):
        ref = w.reference(x, w1, w2, s1, s2)
        y, ys = kern.moe_dispatch_combine(x, w1, w2, probe=probe, **knobs)
        if x.device.type == "cuda":
            _, events, starts = kern.moe_dispatch_logged(x, w1, w2, **knobs)
            kern.check_log(events, starts, kern.make_schedule(
                knobs["counts"], knobs["block_tokens"], knobs["tight"]),
                d=x.shape[2], **dict(knobs, shared=True))
    err = float((y + ys - ref).abs().max() / (ref.abs().max() + 1e-9))
    common.require(err < 2e-3, f"two-stream kernel: rel err {err:.3e}")
    if x.device.type == "cuda":
        common.require(sorted(probe.marks) == sorted(MARKS)
                       and probe.marks[-1] == "dispatch_drained",
                       f"two-stream marks {probe.marks}: the shared FFN "
                       "opened after the dispatch window drained")
    else:
        common.require(probe.marks == MARKS, f"two-stream marks {probe.marks}")
    return err, list(probe.marks)


def rows(hw, path):
    """The full serving shape's four modeled rows, written as the
    ``bench-rows/v1`` table at ``path``; returns the payload."""
    w = get_workload("serving_step")
    host = w.analytic_cost(CONSERVATIVE, hw)
    out = []
    for name, d in ROWS:
        common.require(w.check(d, hw) == [], f"{name}: {w.check(d, hw)}")
        tl = schedule_timeline(w, d, hw)
        validate_trace(tl.to_dict())
        cost = w.analytic_cost(d, hw)
        common.require(abs(tl.critical_path_s - cost) < 1e-6,
                       f"{name}: critical path {tl.critical_path_s!r} s, "
                       f"analytic_cost {cost!r}")
        common.require(cost <= host + 1e-12,
                       f"{name}: {cost!r} s over the host's {host!r}")
        out.append((f"serving_step/{name}", cost * 1e6,
                    f"tokens_per_s={w.n_dev * w.T / cost:.0f}"))
    bench = common.write_rows(path, out)
    common.require(len(bench["rows"]) == 4, "not four rows")
    return bench


def moe_config():
    return reduced(get_arch("llama4-maverick-400b-a17b"), num_experts=4,
                   experts_per_token=1, pad_to=2, capacity_factor=16.0)


def requests(n_new=4):
    return [Request(i, (1 + i, 2 + i, 3 + i, 4 + i), max_new_tokens=n_new)
            for i in range(4)]


def serve_run(cfg, params, device, opts, on_step=None):
    eng = Engine(cfg, params, ServeConfig(max_seq=32, seed=0, opts=opts),
                 rules=Rules(VirtualMesh(4, device=device, axis="data"),
                             "decode"))
    s = Scheduler(token_budget=16, max_batch=4, metrics=eng.metrics)
    for r in requests():
        s.submit(r)
    return eng.serve(s, on_step=on_step), eng


def engine(device):
    """The pallas engine's tokens against the host body's. Returns its
    counters."""
    cfg = moe_config()
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg,
                         device=device)
    host, _ = serve_run(cfg, params, device, StepOptions(remat=False))
    pal, eng = serve_run(cfg, params, device, StepOptions(
        remat=False, moe_backend="pallas", moe_overlap=True))
    common.require(sorted(pal) == [0, 1, 2, 3], f"served {sorted(pal)}")
    for rid in host:
        common.require(torch.equal(host[rid], pal[rid]),
                       f"request {rid}: pallas {pal[rid].tolist()} != host "
                       f"{host[rid].tolist()}")
    c = eng.metrics.snapshot()["counters"]
    common.require(c["serve.decode_steps"] == 3
                   and c["serve.tokens_generated"] == 12
                   and c["sched.finished"] == 4, f"counters {c}")
    return cfg, params, c


def handoff(device):
    """``prefill_remote`` through the 2-rank shuttle, both realizations,
    bit for bit against the engine's own handoff."""
    lcfg = reduced(get_arch("llama3.2-1b"))
    lparams = init_params(torch.Generator(device=device).manual_seed(0),
                          lcfg, device=device)
    leng = Engine(lcfg, lparams, ServeConfig(max_seq=16, seed=0))
    batch = {"tokens": torch.arange(1, 9, dtype=torch.int32,
                                    device=device).reshape(2, 4)}
    mesh2 = VirtualMesh(2, device=device)
    ref = leng.prefill_remote(batch)
    for kw in ({"chained": True},
               {"fused": True, "counter": True, "kv_chunk": 8}):
        h = leng.prefill_remote(batch, shuttle_mesh=mesh2, **kw)
        for blk in ref["cache"]:
            for leaf in ref["cache"][blk]:
                common.require(torch.equal(ref["cache"][blk][leaf],
                                           h["cache"][blk][leaf]),
                               f"handoff {kw}: {blk}.{leaf} differs")
    toks = leng.decode_from_handoff(h, 4)
    common.require(tuple(toks.shape) == (2, 4), f"tokens {tuple(toks.shape)}")
    return len(ref["cache"])


def degraded(cfg, params, device):
    """Rank 3 dropped at step 1: the pallas degrade must refuse 2 ranks,
    the xla body takes over, every request completes."""
    ctl = ElasticController(4)
    seen = {}

    def on_step(step_no, eng):
        if step_no != 1:
            return
        ctl.drop(3)
        live = len(ctl.live_ranks) // 2 * 2      # even data-parallel width
        try:
            eng.degrade(live)
        except ValueError as err:
            seen["refused"] = str(err).split(";")[0]
        eng.scfg.opts = dataclasses.replace(eng.scfg.opts, moe_backend="xla")
        eng.degrade(live)

    out, eng = serve_run(cfg, params, device, StepOptions(
        remat=False, moe_backend="pallas", moe_overlap=True), on_step=on_step)
    common.require("refused" in seen, "the pallas engine degraded onto 2 "
                   "ranks; the kernel cannot take that width")
    common.require(sorted(out) == [0, 1, 2, 3]
                   and all(len(out[r]) == 4 for r in out),
                   f"degraded serve: {out}")
    c = eng.metrics.snapshot()["counters"]
    common.require(c["serve.degrades"] == 1
                   and c["serve.tokens_generated"] == 12, f"counters {c}")
    common.require(ctl.live_ranks == (0, 1, 2), f"live {ctl.live_ranks}")
    return seen["refused"]


def run(device="cuda", *, small=False, chip=H100, out=None):
    """The suite on ``device``, the cascade and the rows priced on ``chip``;
    the rows go to ``out`` (default ``build/suites/BENCH_serving.json``).
    Returns a summary: the rows, the cascade's levels and l2 ms, the
    two-stream error and marks, the engine's counters, the refusal."""
    del small                     # one size: the reference suite's
    dev = common.resolve_device(device)
    mesh = VirtualMesh(4, device=dev)
    hw = extract_hardware_context(mesh, chip)
    path = common.artifact_path(out, ARTIFACT)
    t0 = time.perf_counter()
    levels = cascade(mesh, hw)
    err, marks = two_stream(mesh)
    bench = rows(hw, path)
    cfg, params, counters = engine(dev)
    blocks = handoff(dev)
    refused = degraded(cfg, params, dev)
    return {"artifact": bench, "out": str(path), "chip": chip.name,
            "device": str(dev), "cascade": levels, "two_stream_err": err,
            "marks": marks, "engine": counters, "handoff_blocks": blocks,
            "degrade_refused": refused, "wall_s": time.perf_counter() - t0}


if __name__ == "__main__":
    raise SystemExit(common.main(run, doc=__doc__))
