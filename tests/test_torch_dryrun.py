"""The port's dry run (``repro_torch/launch/{specs,dryrun,report}.py``)
against the JAX package's, on the CPU.

One JAX subprocess at 4 host devices gives the reference's side:
``input_specs`` for every arch (reduced) and every shape kind on a
("data", "model") mesh of (2, 2) (each leaf's shape, type and spec),
``jax.eval_shape(init_params)`` of every arch at its published size, and
``memory_analysis().argument_size_in_bytes`` of a reduced train step
compiled on that mesh. The port's side runs in this process on the meta
device. Every comparison is exact.

Also: depth extrapolation (depths 1 and 2) against a full-depth trace of
a reduced llama3.2-1b at every step kind, and of granite-moe on the mesh
(the reference's claim at ``src/repro/launch/dryrun.py:35-41``, which it
states and does not test); ``report.py``'s tables against the reference's
on the same artifacts; the ``dryrun`` and ``examples`` phases of
``chip_smoke.py`` in their CPU forms.
"""
import dataclasses
import json
import os
import sys

import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, get_arch, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.cost_model import roofline_from_trace
from repro_torch.launch import dryrun, report
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import input_specs, stand_ins
from repro_torch.models import StepOptions, init_params, param_shapes
from torch_port_helpers import run_jax_devices
from torch_train_helpers import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
MESH = ((2, 2), ("data", "model"))
SMALL_TRAIN = (16, 8)              # seq, batch of the compiled train step
MEMORY_ARCHS = ("llama3.2-1b", "granite-moe-3b-a800m")


def cells():
    return [(a, s) for a in sorted(ARCHS) for s in SHAPES
            if s != "long_500k" or ARCHS[a].supports_long_context]


REFERENCE = """
import json, sys
import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import make_mesh
from repro.configs import ARCHS, get_arch, get_shape, reduced
from repro.configs.base import ShapeConfig
from repro.launch.specs import input_specs
from repro.models import init_params
CELLS, MESH, SMALL, MEM = %r, %r, %r, %r
mesh = make_mesh(*MESH)

def spec(s):
    out = [list(e) if isinstance(e, tuple) else e for e in s]
    while out and out[-1] is None:
        out.pop()
    return out

def flat(tree, path, out, fn):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(v, path + "/" + k, out, fn)
    else:
        out[path] = fn(tree)
    return out

specs = {}
for a, s in CELLS:
    _, sds, sp, donate = input_specs(reduced(get_arch(a)), get_shape(s), mesh)
    leaves = {}
    for i, (t, p) in enumerate(zip(sds, sp)):
        shapes = flat(t, str(i), {}, lambda x: [list(x.shape), str(x.dtype)])
        ps = flat(p, str(i), {}, spec)
        for k in shapes:
            leaves[k] = shapes[k] + [ps[k]]
    specs[a + "|" + s] = [leaves, list(donate)]
full = {a: flat(jax.eval_shape(lambda k: init_params(k, cfg),
                               jax.random.PRNGKey(0)), "", {},
                lambda x: [list(x.shape), str(x.dtype)])
        for a, cfg in ARCHS.items()}
args = {}
for a in MEM:
    fn, sds, sp, donate = input_specs(reduced(get_arch(a)), ShapeConfig(
        "t", SMALL[0], SMALL[1], "train"), mesh)
    sh = jax.tree.map(lambda p: NamedSharding(mesh, p), sp,
                      is_leaf=lambda x: isinstance(x, P))
    with jax.set_mesh(mesh):
        c = jax.jit(fn, in_shardings=sh, donate_argnums=donate).lower(
            *sds).compile()
    args[a] = c.memory_analysis().argument_size_in_bytes
blob = json.dumps({"specs": specs, "full": full, "args": args}).encode()
np.savez(sys.argv[2], blob=np.frombuffer(blob, np.uint8))
""" % (cells(), MESH, SMALL_TRAIN, MEMORY_ARCHS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = run_jax_devices(REFERENCE, {}, str(tmp_path_factory.mktemp(
        "dryrun_ref")))
    return json.loads(out["blob"].tobytes().decode())


def _spec(s):
    out = [list(e) if isinstance(e, tuple) else e for e in s]
    while out and out[-1] is None:
        out.pop()
    return out


def _flat(tree, path, fn):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + "/" + k, fn))
        return out
    return {path: fn(tree)}


def _dtype(d):
    return str(d).replace("torch.", "")


@pytest.mark.parametrize("arch,shape", cells())
def test_input_specs_equal_reference(ref, arch, shape):
    """Every argument leaf's shape, type and spec, and the donated
    arguments, for the reduced arch at the shape kind on (2, 2)."""
    mesh = make_mesh(*MESH, device="meta")
    _, sds, specs, donate = input_specs(reduced(get_arch(arch)),
                                        SHAPES[shape], mesh)
    got = {}
    for i, (t, sp) in enumerate(zip(sds, specs)):
        shapes = _flat(t, str(i), lambda x: [list(x.shape), _dtype(x.dtype)])
        ps = _flat(sp, str(i), _spec)
        for k in shapes:
            got[k] = shapes[k] + [ps[k]]
    leaves, want_donate = ref["specs"][f"{arch}|{shape}"]
    assert got == leaves
    assert list(donate) == want_donate


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_shapes_equal_reference_without_a_draw(ref, arch, monkeypatch):
    """The shape-only path at the published size against the reference's
    ``jax.eval_shape(init_params)``, with every random draw refused; at the
    reduced size against the port's own ``init_params``."""
    def refuse(*a, **k):
        raise AssertionError("param_shapes drew a number")
    cfg = get_arch(arch)
    with monkeypatch.context() as m:
        for name in ("randn", "rand", "normal"):
            m.setattr(torch, name, refuse)
        got = _flat(param_shapes(cfg), "",
                    lambda x: [list(x.shape), _dtype(x.dtype)])
    assert got == ref["full"][arch]
    small = reduced(cfg)
    drawn = init_params(torch.Generator().manual_seed(0), small,
                        device="cpu")
    assert _flat(param_shapes(small), "", lambda x: (x.shape, x.dtype)) == \
        _flat(drawn, "", lambda x: (tuple(x.shape), x.dtype))


@pytest.mark.parametrize("arch", MEMORY_ARCHS)
def test_argument_bytes_equal_reference(ref, arch):
    """Per-device argument bytes of a reduced train step on (2, 2): each
    leaf's bytes over its shard count, against XLA's argument size (no
    padding: every sharded dim divides)."""
    mesh = make_mesh(*MESH, device="meta")
    _, sds, specs, _ = input_specs(reduced(get_arch(arch)), ShapeConfig(
        "t", SMALL_TRAIN[0], SMALL_TRAIN[1], "train"), mesh)
    assert dryrun.device_bytes(sds, specs, mesh) == ref["args"][arch]


EXTRAPOLATE = {
    "llama_train": ("llama3.2-1b", ShapeConfig("t", 16, 2, "train"), None),
    "llama_prefill": ("llama3.2-1b", ShapeConfig("p", 16, 2, "prefill"),
                      None),
    "llama_decode": ("llama3.2-1b", ShapeConfig("d", 16, 2, "decode"), None),
    "granite_train_2x2": ("granite-moe-3b-a800m",
                          ShapeConfig("t", 16, 4, "train"), MESH),
}


@pytest.mark.parametrize("case", EXTRAPOLATE)
def test_depth_extrapolation_equals_full_trace(case):
    """R = 4 repeats: the traces at depths 1 and 2, extrapolated, equal
    the full-depth trace in FLOPs, bytes and collectives."""
    arch, shape, mesh = EXTRAPOLATE[case]
    base = reduced(get_arch(arch))
    mesh = make_mesh(*mesh, device="meta") if mesh else None
    reps = {}
    for k in (1, 2, 4):
        cfg = dataclasses.replace(base, num_layers=k * base.repeat_unit)
        fn, sds, _, _ = input_specs(cfg, shape, mesh, StepOptions())
        fn(*stand_ins(sds))               # the mesh's index tables made
        reps[k] = roofline_from_trace(fn, stand_ins(sds), mesh)
    got = reps[1].extrapolate(reps[2], 4)
    assert (got.flops, got.bytes_accessed) == (reps[4].flops,
                                               reps[4].bytes_accessed)
    key = sorted((c.kind, c.payload_bytes, c.group_size, c.wire_bytes)
                 for c in got.collectives)
    assert key == sorted((c.kind, c.payload_bytes, c.group_size,
                          c.wire_bytes) for c in reps[4].collectives)
    assert bool(key) == (mesh is not None)


def test_meta_pallas_refused():
    with pytest.raises(ValueError, match="meta"):
        dryrun.run_cell("llama4-maverick-400b-a17b", "decode_32k", False,
                        {"moe_backend": "pallas"}, verbose=False)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Two decode cells and a skipped one, as ``dryrun.main`` writes them."""
    out = tmp_path_factory.mktemp("dryrun_torch")
    for arch, shape in (("llama3.2-1b", "decode_32k"),
                        ("granite-moe-3b-a800m", "decode_32k"),
                        ("llama3.2-1b", "long_500k")):
        d = dryrun.run_cell(arch, shape, False, verbose=False)
        (out / f"{arch}__{shape}__single.json").write_text(json.dumps(d))
    return out


def test_artifacts_have_the_reference_keys(artifacts):
    d = json.loads((artifacts / "granite-moe-3b-a800m__decode_32k__single"
                    ".json").read_text())
    assert set(d) == {"arch", "shape", "mesh", "n_chips", "lower_s",
                      "compile_s", "memory", "roofline", "model_flops",
                      "useful_flops_ratio", "collective_schedule"}
    assert set(d["memory"]) == {"argument_bytes", "output_bytes",
                                "temp_bytes", "alias_bytes", "peak_bytes",
                                "analytic_peak_bytes", "fits_hbm",
                                "fits_hbm_analytic"}
    assert (d["mesh"], d["n_chips"]) == ("16x16", 256)
    assert d["roofline"]["n_collectives"] > 0
    assert d["roofline"]["convert_overhead_bytes"] == 0.0
    assert d["roofline"]["memory_corrected_s"] >= d["roofline"]["memory_s"]


def test_report_renders_like_reference(artifacts, monkeypatch):
    from repro.launch import report as ref_report
    monkeypatch.setattr(ref_report, "ARTIFACTS", artifacts)
    assert report.roofline_table("16x16", artifacts) == \
        ref_report.roofline_table("16x16")
    assert report.dryrun_table(artifacts) == ref_report.dryrun_table()
    assert "llama3.2-1b | decode_32k" in report.roofline_table(
        directory=artifacts)


def test_chip_smoke_dryrun_and_examples_phases_on_the_cpu(tmp_path):
    """Both phases' CPU forms: the dry run's two cells at decode_32k and
    the four steps at the reduced size (meta and CPU counts equal), and
    every example at its smallest arguments with the lint clean."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    chip_smoke.phase_dryrun("cpu", small=True)
    assert chip_smoke.phase_examples("cpu", small=True,
                                     root=tmp_path / "ex") == {}
