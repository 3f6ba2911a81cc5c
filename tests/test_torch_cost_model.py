"""The port's roofline cost model (``repro_torch/core/cost_model.py``) and
the count it reads (``repro_torch/core/op_count.py``) against the JAX
package, on the CPU.

* The reference's seven tests of ``tests/test_cost_model.py`` run on the
  same inputs through both packages with equal numbers. The port reads
  ``VirtualMesh`` recorder events where the reference reads HLO text, so
  the HLO lines are given to the port as the events that stand for them
  (kind, per-rank operand and result bytes, the mesh axes of the group).
* The recorder's reader against the reference's HLO parser: the MoE
  layer (reduced llama4-maverick, all-to-all experts with a shared
  expert; reduced granite-moe, replicated experts) on (4,) and (2, 2)
  meshes, in float32, against ``parse_collectives`` of the compiled
  module of the same layer at 4 host devices (one JAX subprocess).
* ``op_count`` on a reduced llama3.2-1b train step (remat off) equals a
  matmul count done by hand, exactly, and is at most the reference's
  ``cost_analysis()["flops"]`` for the same step at one device (XLA also
  counts element-wise ops; the ratio is printed). With remat the count
  adds one forward of the blocks at most.
* The count on meta equals the count on the CPU: FLOPs, bytes and
  collectives.

Every comparison is exact (``==``) unless a tolerance is named.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import cost_model as ref
from repro.core.hardware import V5E as REF_V5E
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import cost_model as port
from repro_torch.core.hardware import H100, V5E
from repro_torch.core.op_count import op_count
from repro_torch.dist.mesh import CollectiveEvent, VirtualMesh, record
from repro_torch.dist.sharding import Rules
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import input_specs, stand_ins
from repro_torch.models import StepOptions
from repro_torch.models.moe import moe_apply, moe_init
from torch_port_helpers import run_jax_devices
from torch_train_helpers import one_torch_thread  # noqa: F401 (autouse)

HLO = """
HloModule test
%psum.1 = f32[16,4096,2048]{2,1,0} all-reduce(f32[16,4096,2048]{2,1,0} %x), replica_groups=[16,16]<=[256], use_global_device_ids=true, to_apply=%add
%ag.1 = bf16[256,1024]{1,0} all-gather(bf16[16,1024]{1,0} %y), replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}, dimensions={0}
%rs = bf16[16,1024]{1,0} reduce-scatter(bf16[256,1024]{1,0} %z), replica_groups=[1,512]<=[512], dimensions={0}
%a2a-start = (bf16[32,128,64]{2,1,0}, bf16[32,128,64]{2,1,0}) all-to-all-start(bf16[32,128,64]{2,1,0} %w), replica_groups=[16,32]<=[512]
%cp = f32[8,128]{1,0} collective-permute(f32[8,128]{1,0} %v), source_target_pairs={{0,1},{1,2}}
%prom = bf16[4,4]{1,0} all-reduce(bf16[4,4]{1,0} %u), replica_groups=[2,2]<=[4], to_apply=%add.clone_promoted
"""


def _ev(kind, axis, operand, result):
    return CollectiveEvent(kind=kind, axis=axis, shape=(), dtype="",
                           payload_bytes=operand, result_bytes=result)


# HLO's lines as the recorder's events, each on a mesh whose axis has the
# line's group: operand and result bytes as the HLO types read (the
# all-to-all-start's result is a tuple of two buffers); a group of 512 is
# every axis of a 2 x 16 x 16 ("pod", "data", "model") mesh
MESH_16 = VirtualMesh((16, 16), axes=("data", "model"), device="meta")
MESH_32 = VirtualMesh((16, 32), axes=("data", "model"), device="meta")
POD_MESH = VirtualMesh((2, 16, 16), axes=("pod", "data", "model"),
                       device="meta")
A2A = 32 * 128 * 64 * 2
EVENTS = [(_ev("all-reduce", "model", 16 * 4096 * 2048 * 4,
               16 * 4096 * 2048 * 4), MESH_16),
          (_ev("all-gather", "model", 16 * 1024 * 2, 256 * 1024 * 2),
           MESH_16),
          (_ev("reduce-scatter", ("pod", "data", "model"), 256 * 1024 * 2,
               16 * 1024 * 2), POD_MESH),
          (_ev("all-to-all", "model", A2A, 2 * A2A), MESH_32)]
PERMUTE = _ev("collective-permute", "x", 8 * 128 * 4, 8 * 128 * 4)
PROMOTED = _ev("all-reduce", "x", 4 * 4 * 2, 4 * 4 * 2)
MESH_2 = VirtualMesh(2, device="meta")


def _parse(pairs, chips_per_pod=256):
    return [port.parse_collectives([ev], mesh, chips_per_pod)[0]
            for ev, mesh in pairs]


def _key(o):
    return (o.kind, o.payload_bytes, o.group_size, o.crosses_pod,
            o.wire_bytes)


def test_parse_finds_all_kinds():
    want = sorted(o.kind for o in ref.parse_collectives(HLO, 256))
    got = _parse(EVENTS + [(PERMUTE, MESH_2), (PROMOTED, MESH_2)])
    assert sorted(o.kind for o in got) == want


def test_wire_factors():
    for kind in ref.COLLECTIVE_OPS:
        for n in (1, 2, 3, 16, 512):
            assert port._wire_factor(kind, n) == ref._wire_factor(kind, n)
    assert port.COLLECTIVE_OPS == ref.COLLECTIVE_OPS


def test_payload_and_groups():
    """Kind, payload (the larger of operand and result), group size, the
    pod crossing and the wire bytes of the first four HLO lines. The
    permute: the reference reads no group from ``source_target_pairs``
    (group 1, no wire); the port's event names its axis, here of 2."""
    want = ref.parse_collectives(HLO, chips_per_pod=256)
    assert [_key(o) for o in _parse(EVENTS)] == [_key(o) for o in want[:4]]
    cp = _parse([(PERMUTE, MESH_2)])[0]
    assert (cp.kind, cp.payload_bytes) == (want[4].kind,
                                           want[4].payload_bytes)
    assert (want[4].group_size, want[4].wire_bytes) == (1, 0.0)
    assert (cp.group_size, cp.wire_bytes) == (2, cp.payload_bytes)


def test_promoted_bf16_correction():
    """The reference halves the wire of an all-reduce XLA:CPU promoted to
    f32; a torch event carries the type it sends, so the port has nothing
    to correct: its wire is the payload times the factor."""
    prom = ref.parse_collectives(HLO, chips_per_pod=256)[5]
    got = _parse([(PROMOTED, MESH_2)])[0]
    assert prom.payload_bytes == got.payload_bytes
    assert prom.wire_bytes == got.wire_bytes * 0.5
    assert got.wire_bytes == 32 * port._wire_factor("all-reduce", 2)


def _reports(flops, byts, colls):
    r = ref.RooflineReport(flops=flops, bytes_accessed=byts, collectives=[
        ref.CollectiveOp(*c) for c in colls], chip=REF_V5E)
    p = port.RooflineReport(flops=flops, bytes_accessed=byts, collectives=[
        port.CollectiveOp(*c) for c in colls], chip=V5E)
    return r, p


TERMS = ("compute_s", "memory_s", "memory_corrected_s", "ici_wire_bytes",
         "dcn_wire_bytes", "collective_s", "dominant", "step_time_s",
         "serial_time_s")


def test_roofline_terms_and_dominance():
    r, p = _reports(197e12, 819e9 / 2,
                    [("all-reduce", 10 * 2**30, 16, False, 100e9)])
    assert p.compute_s == pytest.approx(1.0)
    assert p.memory_s == pytest.approx(0.5)
    assert p.dominant == "collective"
    for t in TERMS:
        assert getattr(p, t) == getattr(r, t), t
    summ = p.summary()
    assert summ.pop("opaque") == {}
    assert summ == r.summary()


def test_dcn_charged_at_dcn_bw():
    r, p = _reports(0, 0, [("all-reduce", 0, 512, True, 25e9)])
    assert p.collective_s == r.collective_s == pytest.approx(1.0)


def test_extrapolate_linear():
    c1 = [("all-reduce", 8, 4, False, 4.0)]
    c2 = c1 + [("all-gather", 16, 4, False, 12.0)]
    r1, p1 = _reports(10.0, 100.0, c1)
    r2, p2 = _reports(14.0, 130.0, c2)
    r, p = r1.extrapolate(r2, repeats=5), p1.extrapolate(p2, repeats=5)
    assert (p.flops, p.bytes_accessed) == (r.flops, r.bytes_accessed) \
        == (26.0, 220.0)
    assert [_key(c) for c in p.collectives] == [_key(c) for c in
                                                r.collectives]
    assert len(p.collectives) == 1 + 4


def test_port_report_defaults_to_h100():
    p = port.RooflineReport(flops=989e12, bytes_accessed=3.35e12,
                            collectives=[])
    assert p.chip is H100
    assert p.compute_s == pytest.approx(1.0)
    assert p.memory_s == pytest.approx(1.0)
    assert p.convert_overhead == 0.0 and p.memory_corrected_s == p.memory_s


# ------------------------------------------------ the recorder against HLO

MOE_CASES = {
    "llama4_4": ("llama4-maverick-400b-a17b",
                 dict(num_experts=4, experts_per_token=1, pad_to=2), (4,),
                 ("data",)),
    "llama4_2x2": ("llama4-maverick-400b-a17b",
                   dict(num_experts=4, experts_per_token=1, pad_to=2),
                   (2, 2), ("data", "model")),
    "granite_2x2": ("granite-moe-3b-a800m", {}, (2, 2), ("data", "model")),
    "granite_4": ("granite-moe-3b-a800m", {}, (4,), ("data",)),
}
MOE_B, MOE_S = 8, 12

REFERENCE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import make_mesh
from repro.configs import get_arch, reduced
from repro.core.cost_model import parse_collectives
from repro.dist.sharding import Rules
from repro.models.moe import moe_apply, moe_init, moe_param_specs
CASES, B, S = %r, %r, %r
out = {}
for name, (arch, over, shape, axes) in CASES.items():
    cfg = reduced(get_arch(arch), dtype="float32", **over)
    mesh = make_mesh(shape, axes)
    rules = Rules(mesh, "decode")
    p = moe_init(jax.random.PRNGKey(0), cfg, jnp.float32)
    psh = jax.tree.map(lambda s: NamedSharding(mesh, s),
                       moe_param_specs(cfg, rules),
                       is_leaf=lambda x: isinstance(x, P))
    xsh = NamedSharding(mesh, P(rules.axes("batch"), None, None))
    f = jax.jit(lambda p, x: moe_apply(p, x, cfg, rules),
                in_shardings=(psh, xsh))
    hlo = f.lower(p, jnp.zeros((B, S, cfg.d_model))).compile().as_text()
    out[name] = np.array([(o.payload_bytes, o.group_size, o.wire_bytes,
                           ["all-reduce", "all-to-all", "all-gather"].index(
                               o.kind))
                          for o in parse_collectives(hlo)],
                         np.float64).reshape(-1, 4)
np.savez(sys.argv[2], **out)
""" % (MOE_CASES, MOE_B, MOE_S)
KINDS = ["all-reduce", "all-to-all", "all-gather"]


@pytest.fixture(scope="module")
def hlo_ops(tmp_path_factory):
    out = run_jax_devices(REFERENCE, {}, str(tmp_path_factory.mktemp(
        "cost_model_ref")))
    return {name: sorted((KINDS[int(k)], int(p), int(g), w)
                         for p, g, w, k in rows)
            for name, rows in out.items()}


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_collectives_against_reference_hlo(hlo_ops, case):
    """Kind, payload and group size of every collective the port's MoE
    layer runs, against the compiled module's. XLA merges the two
    all-reduces of llama4's (2, 2) layer (the ff partials and the shared
    expert's) into one; there, and wherever the count of a kind differs,
    the total payload and wire bytes of each kind are compared."""
    arch, over, shape, axes = MOE_CASES[case]
    cfg = reduced(get_arch(arch), dtype="float32", **over)
    mesh = make_mesh(shape, axes, device="cpu")
    p = moe_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    with record() as events:
        moe_apply(p, torch.zeros(MOE_B, MOE_S, cfg.d_model), cfg,
                  Rules(mesh, "decode"))
    got = sorted((o.kind, o.payload_bytes, o.group_size, o.wire_bytes)
                 for o in port.parse_collectives(events, mesh))
    want = hlo_ops[case]
    print(case, "port", got, "reference", want)

    def per_kind(ops):
        return {k: (sum(o[1] for o in ops if o[0] == k),
                    sum(o[3] for o in ops if o[0] == k),
                    {o[2] for o in ops if o[0] == k}) for k in KINDS}

    def counts(ops):
        return [sum(o[0] == k for o in ops) for k in KINDS]

    if counts(got) == counts(want):
        assert got == want
    else:
        assert case == "llama4_2x2"
        assert per_kind(got) == per_kind(want)


# ------------------------------------------------------ the count of a step

SHAPE = ShapeConfig("t", 16, 2, "train")


def _llama(layers=2):
    return reduced(get_arch("llama3.2-1b"), num_layers=layers)


def _count(cfg, opts, shape=SHAPE, mesh=None, device="meta", warm=False):
    fn, sds, _, _ = input_specs(cfg, shape, mesh, opts)
    args = stand_ins(sds, device)
    if warm:                       # a mesh's index tables made once
        fn(*stand_ins(sds, device))
    with op_count() as c:
        fn(*args)
    return c


def _matmul_flops(cfg, B, S):
    """One forward's matmul FLOPs of a reduced llama by hand: the q, k, v
    and o projections, scores and the weighted values (dense attention
    over all S x S), SwiGLU's three projections per layer, and the tied
    LM head."""
    T, d, H, Hkv, hd = B * S, cfg.d_model, cfg.num_heads, \
        cfg.num_kv_heads, cfg.hd
    ff, Vp = cfg.d_ff, cfg.vocab_padded
    layer = 2 * T * d * (H + 2 * Hkv) * hd + 2 * T * H * hd * d \
        + 2 * (2 * B * H * S * S * hd) + 3 * (2 * T * d * ff)
    return cfg.num_layers * layer + 2 * T * d * Vp, cfg.num_layers * layer


def test_op_count_matches_hand_count_and_reference_flops():
    cfg = _llama()
    fwd, blocks = _matmul_flops(cfg, SHAPE.global_batch, SHAPE.seq_len)
    plain = _count(cfg, StepOptions(remat=False))
    assert plain.flops == 3 * fwd           # forward + both gradients
    remat = _count(cfg, StepOptions())
    assert 3 * fwd < remat.flops <= 3 * fwd + blocks

    import jax
    from repro.configs import get_arch as ref_arch, reduced as ref_reduced
    from repro.configs.base import ShapeConfig as RefShape
    from repro.launch.specs import input_specs as ref_specs
    from repro.models import StepOptions as RefOpts
    rcfg = ref_reduced(ref_arch("llama3.2-1b"), num_layers=2)
    fn, sds, _, _ = ref_specs(rcfg, RefShape("t", SHAPE.seq_len,
                                             SHAPE.global_batch, "train"),
                              None, RefOpts(remat=False, scan_layers=False))
    xla = jax.jit(fn).lower(*sds).compile().cost_analysis()["flops"]
    print(f"op_count {plain.flops:.6e} FLOP, the reference's cost_analysis "
          f"{xla:.6e}: ratio {plain.flops / xla:.4f}")
    assert plain.flops <= xla


CPU_CASES = {
    "llama_train": (lambda: _llama(), SHAPE, None),
    "llama_decode": (lambda: _llama(), ShapeConfig("d", 16, 2, "decode"),
                     None),
    "granite_train_2x2": (lambda: reduced(get_arch("granite-moe-3b-a800m")),
                          ShapeConfig("t", 16, 4, "train"),
                          ((2, 2), ("data", "model"))),
}


@pytest.mark.parametrize("case", CPU_CASES)
def test_meta_count_equals_cpu_count(case):
    make, shape, mesh = CPU_CASES[case]
    cfg = make()
    got = {}
    for device in ("meta", "cpu"):
        m = make_mesh(*mesh, device=device) if mesh else None
        c = _count(cfg, StepOptions(), shape, m, device, warm=True)
        got[device] = (c.flops, c.bytes,
                       [dataclasses.astuple(e) for e in c.events])
    assert got["meta"] == got["cpu"]
    assert got["meta"][0] > 0 and got["meta"][1] > 0
    assert bool(got["meta"][2]) == (mesh is not None)


# -------------------------------------------------------- op_count's rules

def test_op_count_bytes_views_in_place_and_peak():
    """A view moves nothing; ``a + b`` reads both and writes one; a
    broadcast operand is read once; ``copy_`` reads its source and writes
    its target; an in-place op reads and writes its target. A storage made
    in the pass adds its bytes to the live count until it dies."""
    a, b = torch.ones(64, 32), torch.ones(32)
    dst = torch.empty(64, 32)
    with op_count(held=(a, b, dst)) as c:
        a.view(32, 64).t()
        assert c.bytes == 0
        y = a + b
        assert c.bytes == 4 * (64 * 32 + 32 + 64 * 32)
        dst.copy_(y)
        assert c.bytes == 4 * (64 * 32 + 32 + 64 * 32) + 4 * 2 * 64 * 32
        before = c.bytes
        dst.mul_(2.0)
        assert c.bytes == before + 4 * 2 * 64 * 32
        held = 4 * (2 * 64 * 32 + 32)
        assert c.live_bytes == held + 4 * 64 * 32
        del y
        assert c.live_bytes == held
        z = torch.ones(10, 10) @ torch.ones(10, 10)
        assert c.flops == 2 * 10 * 10 * 10
    assert c.peak_bytes == held + 4 * 64 * 32
    del z


def test_op_count_leaves_collectives_out_and_names_opaque_kernels():
    """The ops inside a ``VirtualMesh`` collective count no FLOPs and no
    bytes (the event carries them); a kernel whose launch counter moves in
    the pass is named in ``opaque`` and counts nothing."""
    from repro_torch.kernels import moe_dispatch
    mesh = VirtualMesh(4, device="cpu")
    t = torch.ones(4, 8, 16)

    def step(t):
        moe_dispatch.LAUNCHES["test"] += 1
        return mesh.psum(t)

    rep = port.roofline_from_trace(step, (t,), mesh=mesh)
    moe_dispatch.LAUNCHES.pop("test")
    assert (rep.flops, rep.bytes_accessed) == (0, 0)
    assert rep.opaque == {"moe_dispatch": 1}
    assert [_key(o) for o in rep.collectives] == [
        ("all-reduce", 8 * 16 * 4, 4, False,
         8 * 16 * 4 * port._wire_factor("all-reduce", 4))]
    assert np.isclose(rep.collective_s, rep.ici_wire_bytes / H100.ici_link_bw)
