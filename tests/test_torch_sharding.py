"""The port's mesh, sharding rules and reductions against the JAX package,
on the CPU.

The reference runs once, in one subprocess with 4 JAX host devices: every
collective of a two-axis ``("data", "model")`` mesh of shape (2, 2) under
``shard_map`` on one seeded input (a (4, 4, 3, 8) float32 array, one
(4, 3, 8) block a device), ``compressed_psum`` and ``hierarchical_psum``
(the latter on a ``("pod", "data")`` mesh), and, on four mesh shapes,
``Rules(...).table``, ``param_spec``, ``param_specs``, ``sanitize_specs``
and ``zero_spec`` over every config's whole-size parameter shapes
(``jax.eval_shape``: nothing is allocated), ``moe_param_specs`` and
``cache_specs``. The port's :class:`VirtualMesh` holds the same blocks
stacked on its rank axis.

Tolerances: the collectives move or add float32 values, so a permutation
or a gather is held bit for bit and a sum within 1e-6, max-abs-normalised
(the same additions in another order). The int8 reductions quantize the
same values by the same formula and are held within 1e-6 of the
reference; the reference's own bound on them (its collectives suite: 2%
of the exact sum, max-abs-normalised) is held too. Specs are compared
entry by entry.
"""
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.launch import mesh as jmesh
from repro.models import init_params as jinit
from repro_torch.configs import get_arch, reduced
from repro_torch.dist import mesh as vmesh
from repro_torch.dist.collectives import compressed_psum, hierarchical_psum
from repro_torch.dist.sharding import (P, Rules, from_shards, local_shards,
                                       replicated, sanitize_specs, tree_map,
                                       zero_spec)
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import cache_specs, param_specs, params_from_numpy
from repro_torch.models.model import ShapeDtype
from repro_torch.models.moe import moe_param_specs
from torch_port_helpers import rel_err, run_jax_devices

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "4": ((4,), ("data",)),
          "pod2x2": ((2, 2), ("pod", "data"))}
ARCHS = sorted(JARCHS)
CACHE = (8, 64)                   # cache_specs' batch and sequence length
PARAM_SPEC_CASES = [((8, 64, 6), ("batch", "seq_kv", "heads")),
                    ((3, 64, 8), ("batch", "ff", "vocab")),
                    ((48, 16, 6), ("experts_model", None, "experts_data")),
                    ((4, 8), ("zero", "batch"))]

REFERENCE = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.configs import ARCHS
from repro.dist.collectives import compressed_psum, hierarchical_psum
from repro.dist.sharding import Rules, sanitize_specs, zero_spec
from repro.models import cache_specs, init_params, param_specs
from repro.models.moe import moe_param_specs
MESHES, CACHE, CASES = %r, %r, %r
x = jnp.asarray(np.load(sys.argv[1])["x"])
out, doc = {}, {}
ALL = ("data", "model")

def run(fn, m, axes=ALL):
    spec = P(axes)
    f = shard_map(lambda b: jnp.asarray(fn(b[0]))[None], mesh=m,
                  in_specs=spec, out_specs=spec, check_vma=False)
    return np.asarray(jax.jit(f)(x))

mesh = make_mesh((2, 2), ALL)
lax = jax.lax
for name, ax in (("data", "data"), ("model", "model"), ("all", ALL)):
    out[f"index_{name}"] = run(lambda b: lax.axis_index(ax), mesh)
    out[f"psum_{name}"] = run(lambda b: lax.psum(b, ax), mesh)
    out[f"a2a_{name}"] = run(lambda b: lax.all_to_all(b, ax, 0, 0,
                                                      tiled=True), mesh)
    out[f"gather_{name}"] = run(lambda b: lax.all_gather(b, ax), mesh)
    out[f"tiled_{name}"] = run(lambda b: lax.all_gather(b, ax, tiled=True),
                               mesh)
out["ppermute_data"] = run(lambda b: lax.ppermute(b, "data", [(0, 1)]), mesh)
out["ppermute_all"] = run(lambda b: lax.ppermute(b, ALL, [(0, 2), (3, 1)]),
                          mesh)
out["cpsum_all"] = run(lambda b: compressed_psum(b, ALL), mesh)
out["cpsum_model_g3"] = run(lambda b: compressed_psum(b, "model",
                                                      group_size=3), mesh)
pod = make_mesh((2, 2), ("pod", "data"))
out["hpsum"] = run(lambda b: hierarchical_psum(b), pod, ("pod", "data"))
out["hpsum_dcn"] = run(lambda b: hierarchical_psum(b, compress_dcn=True),
                       pod, ("pod", "data"))
out["psum_pod"] = run(lambda b: lax.psum(b, ("pod", "data")), pod,
                      ("pod", "data"))

def js(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

def tree_js(t):
    return jax.tree.map(js, t, is_leaf=lambda s: isinstance(s, P))

def shapes(t):
    return jax.tree.map(lambda a: [list(a.shape), str(a.dtype)], t)

sds = {name: jax.eval_shape(lambda c=cfg: init_params(jax.random.PRNGKey(0),
                                                       c))
       for name, cfg in ARCHS.items()}
doc["shapes"] = {name: shapes(t) for name, t in sds.items()}
for mname, (shape, axes) in MESHES.items():
    m = make_mesh(shape, axes)
    doc[f"mesh/{mname}"] = [list(m.axis_names), dict(m.shape)]
    for kind in ("train", "decode"):
        for lc in (False, True):
            r = Rules(m, kind, long_context=lc)
            doc[f"table/{mname}/{kind}/{lc}"] = {
                k: list(v) if isinstance(v, tuple) else v
                for k, v in r.table.items()}
            doc[f"param_spec/{mname}/{kind}/{lc}"] = [
                js(r.param_spec(s, *names)) for s, names in CASES]
            doc[f"sizes/{mname}/{kind}/{lc}"] = {
                k: r.size(k) for k in r.table}
    r = Rules(m, "train")
    d = Rules(m, "decode", long_context=True)
    for name, cfg in ARCHS.items():
        ps = param_specs(cfg, r)
        clean = sanitize_specs(ps, sds[name], m)
        zero = jax.tree.map(lambda s, a: zero_spec(s, a.shape, r), clean,
                            sds[name], is_leaf=lambda s: isinstance(s, P))
        key = f"{mname}/{name}"
        doc["param_specs/" + key] = tree_js(ps)
        doc["sanitized/" + key] = tree_js(clean)
        doc["zero/" + key] = tree_js(zero)
        if cfg.is_moe:
            doc["moe/" + key] = tree_js(moe_param_specs(cfg, r))
        for rr, tag in ((r, "train"), (d, "decode_lc")):
            csh, csp = cache_specs(cfg, *CACHE, rr)
            doc[f"cache/{tag}/{key}"] = [shapes(csh), tree_js(csp)]
out["doc"] = np.array(json.dumps(doc))
np.savez(sys.argv[2], **out)
""" % (MESHES, CACHE, PARAM_SPEC_CASES)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    x = np.random.default_rng(0).standard_normal((4, 4, 3, 8)).astype(
        np.float32)
    out = run_jax_devices(REFERENCE, {"x": x},
                          str(tmp_path_factory.mktemp("sharding_ref")))
    out["doc"] = json.loads(str(out["doc"]))
    out["x"] = torch.from_numpy(x)
    return out


def vm(name="2x2"):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, device="cpu")


def js(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def tree_js(t):
    return tree_map(js, t)


# ------------------------------------------------------------- the mesh


@pytest.mark.parametrize("name", ["data", "model", "all"])
def test_axis_index_and_psum_equal_shard_map(ref, name):
    m, x = vm(), ref["x"]
    ax = ("data", "model") if name == "all" else name
    assert m.axis_index(ax).tolist() == ref[f"index_{name}"].tolist()
    with vmesh.record() as events:
        got = m.psum(x, ax)
    assert rel_err(got, ref[f"psum_{name}"]) <= 1e-6
    assert [(ev.kind, ev.axis) for ev in events] == [("all-reduce", ax)]


@pytest.mark.parametrize("name", ["data", "model", "all"])
def test_all_to_all_and_all_gather_equal_shard_map(ref, name):
    """Per rank a (4, 3, 8) block: the all-to-all splits it into k chunks
    (the port's (n, k, ...) layout) and the gather stacks or tiles the k
    partners' blocks; both are permutations, held bit for bit."""
    m, x = vm(), ref["x"]
    ax = ("data", "model") if name == "all" else name
    k = m.size(ax)
    with vmesh.record() as events:
        a2a = m.all_to_all(x.reshape(4, k, 4 // k, 3, 8), ax)
        stacked = m.all_gather(x, tiled=False, axis=ax)
        tiled = m.all_gather(x, axis=ax)
    assert torch.equal(a2a.reshape(4, 4, 3, 8),
                       torch.from_numpy(ref[f"a2a_{name}"]))
    assert torch.equal(stacked, torch.from_numpy(ref[f"gather_{name}"]))
    assert torch.equal(tiled, torch.from_numpy(ref[f"tiled_{name}"]))
    assert [ev.kind for ev in events] == ["all-to-all", "all-gather",
                                          "all-gather"]
    assert events[0].shape == (k, 4 // k, 3, 8)


def test_ppermute_over_one_and_two_axes_equals_shard_map(ref):
    m, x = vm(), ref["x"]
    assert torch.equal(m.ppermute(x, [(0, 1)], axis="data"),
                       torch.from_numpy(ref["ppermute_data"]))
    assert torch.equal(m.ppermute(x, [(0, 2), (3, 1)],
                                  axis=("data", "model")),
                       torch.from_numpy(ref["ppermute_all"]))


def test_one_axis_mesh_keeps_its_defaults():
    """``VirtualMesh(n, axis=)`` as every earlier caller builds it: its
    collectives need no axis, and a two-axis mesh's do."""
    m = vmesh.VirtualMesh(3, device="cpu", axis="data")
    assert m.axis == "data" and m.axis_names == ("data",) \
        and m.shape == {"data": 3} and repr(m).startswith("VirtualMesh(n=3")
    t = torch.arange(9.0).reshape(3, 3, 1)
    assert torch.equal(m.all_to_all(t), t.transpose(0, 1))
    assert torch.equal(m.psum(t, "data")[1], t.sum(0))
    two = vm()
    assert two.axis is None and two.n == 4
    with pytest.raises(ValueError, match="name the one"):
        two.all_gather(t[:1].expand(4, 3, 1))
    with pytest.raises(ValueError, match="no axis"):
        two.psum(t[:1].expand(4, 3, 1), "pod")
    with pytest.raises(ValueError, match="axis name"):
        vmesh.VirtualMesh((2, 2), axes=("data",), device="cpu")


def test_local_shards_cut_each_rank_its_block():
    m = vm()
    t = torch.arange(4 * 3 * 6.0).reshape(4, 3, 6)
    got = local_shards(t, P("data", None, "model"), m)
    for r in range(4):
        d, mm = divmod(r, 2)
        assert torch.equal(got[r], t[2 * d:2 * d + 2, :, 3 * mm:3 * mm + 3])
    assert local_shards(t, P(None), m).stride(0) == 0        # a view
    with pytest.raises(ValueError, match="does not shard"):
        local_shards(t, P(None, "model"), m)


@pytest.mark.parametrize("spec", [P(), P("data"), P(None, "model"),
                                  P("data", None, "model"),
                                  P("model", None, "data"),
                                  P(("data", "model")), P(("model", "data"))])
@pytest.mark.parametrize("shape,axes", [((2, 2), ("data", "model")),
                                        ((1, 4), ("data", "model")),
                                        ((4, 2), ("data", "model"))])
def test_from_shards_inverts_local_shards(shape, axes, spec):
    """``from_shards`` puts every rank's block back where ``local_shards``
    cut it, on meshes whose ranks span the spec's axes in order, in
    another order, or only in part; ``replicated`` says whether the spec
    cuts anything there."""
    m = make_mesh(shape, axes, device="cpu")
    t = torch.arange(8 * 4 * 8.0).reshape(8, 4, 8)
    shards = local_shards(t, spec, m)
    assert torch.equal(from_shards(shards, spec, m), t)
    cut = [a for e in spec if e is not None
           for a in ((e,) if isinstance(e, str) else e) if m.shape[a] > 1]
    assert replicated(spec, m) == (not cut)
    assert shards.shape[1:] == tuple(
        d // math.prod(m.shape[a] for a in (
            (e,) if isinstance(e, str) else e or ()))
        for d, e in zip(t.shape, list(spec) + [None] * 3))


# ---------------------------------------------------------- reductions


def test_compressed_psum_equals_reference(ref):
    """Within 1e-6 of the reference's (the same quantization), and within
    its own 2% of the exact sum."""
    m, x = vm(), ref["x"]
    for key, got in (("cpsum_all", compressed_psum(x, m, ("data", "model"))),
                     ("cpsum_model_g3", compressed_psum(x, m, "model",
                                                        group_size=3))):
        assert rel_err(got, ref[key]) <= 1e-6
    exact = m.psum(x, ("data", "model"))
    assert 0 < rel_err(compressed_psum(x, m, ("data", "model")), exact) \
        <= 2e-2


def test_hierarchical_psum_equals_reference(ref):
    m, x = vm("pod2x2"), ref["x"]
    assert rel_err(hierarchical_psum(x, m), ref["hpsum"]) <= 1e-6
    assert rel_err(hierarchical_psum(x, m), ref["psum_pod"]) <= 1e-6
    got = hierarchical_psum(x, m, compress_dcn=True)
    assert rel_err(got, ref["hpsum_dcn"]) <= 1e-6
    assert rel_err(got, ref["psum_pod"]) <= 2e-2


# ----------------------------------------------------- meshes and rules


@pytest.mark.parametrize("name", list(MESHES))
def test_make_mesh_shape_and_axes_equal_reference(ref, name):
    axes, shape = ref["doc"][f"mesh/{name}"]
    m = vm(name)
    assert list(m.axis_names) == axes and m.shape == shape


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shape_and_axes_equal_reference(monkeypatch,
                                                        multi_pod):
    """The reference builds its mesh from the machine's devices; its shape
    and axes are read here from the call it makes, with the device list
    stubbed (this process has one device)."""
    monkeypatch.setattr(jmesh.jax, "devices", lambda: [None] * 512)
    monkeypatch.setattr(jmesh, "_make_mesh",
                        lambda shape, axes, devices: (tuple(shape), axes))
    shape, axes = jmesh.make_production_mesh(multi_pod=multi_pod)
    m = make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert m.axis_names == axes and tuple(m.shape.values()) == shape
    assert m.n == (512 if multi_pod else 256)


@pytest.mark.parametrize("lc", [False, True])
@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("name", list(MESHES))
def test_rules_table_sizes_and_param_spec_equal_reference(ref, name, kind,
                                                          lc):
    r = Rules(vm(name), kind, long_context=lc)
    key = f"{name}/{kind}/{lc}"
    table = {k: list(v) if isinstance(v, tuple) else v
             for k, v in r.table.items()}
    assert table == ref["doc"]["table/" + key]
    assert {k: r.size(k) for k in r.table} == ref["doc"]["sizes/" + key]
    assert [js(r.param_spec(s, *names)) for s, names in PARAM_SPEC_CASES] \
        == ref["doc"]["param_spec/" + key]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", list(MESHES))
def test_param_specs_sanitized_and_zero_equal_reference(ref, name, arch):
    """Over the whole-size parameter shapes the reference's
    ``jax.eval_shape(init_params)`` gives (records with ``.shape``)."""
    doc, m = ref["doc"], vm(name)
    cfg, r = get_arch(arch), Rules(m, "train")
    sds = tree_map(lambda s: ShapeDtype(tuple(s[0]), s[1]),
                   doc["shapes"][arch])
    ps = param_specs(cfg, r)
    clean = sanitize_specs(ps, sds, m)
    zero = tree_map(lambda s, a: zero_spec(s, a.shape, r), clean, sds)
    key = f"{name}/{arch}"
    assert tree_js(ps) == doc["param_specs/" + key]
    assert tree_js(clean) == doc["sanitized/" + key]
    assert tree_js(zero) == doc["zero/" + key]
    if cfg.is_moe:
        assert tree_js(moe_param_specs(cfg, r)) == doc["moe/" + key]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", list(MESHES))
def test_cache_specs_equal_reference(ref, name, arch):
    m, cfg = vm(name), get_arch(arch)
    for r, tag in ((Rules(m, "train"), "train"),
                   (Rules(m, "decode", long_context=True), "decode_lc")):
        shapes, specs = cache_specs(cfg, *CACHE, r)
        got = [tree_map(lambda s: [list(s.shape),
                                   str(s.dtype).replace("torch.", "")],
                        shapes), tree_js(specs)]
        assert got == ref["doc"][f"cache/{tag}/{name}/{arch}"]


def test_granite_reference_tree_crosses_unchanged():
    """granite-moe's tree at its published expert count (40, padded to 48
    for the mesh, top-8) at narrow widths: ``params_from_numpy`` takes it
    leaf for leaf, shapes and types as ``jax.eval_shape(init_params)``
    gives them, and the 8 padded experts' router columns cross as they
    are (routing masks them to -inf)."""
    over = dict(num_experts=40, experts_per_token=8, pad_to=16)
    jcfg = jreduced(JARCHS["granite-moe-3b-a800m"], **over)
    cfg = reduced(get_arch("granite-moe-3b-a800m"), **over)
    assert cfg.num_experts_padded == jcfg.num_experts_padded == 48
    sds = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32).astype(a.dtype), sds)
    got = params_from_numpy(tree, cfg, device="cpu")
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), sds)
    assert tree_map(lambda t: (tuple(t.shape),
                               str(t.dtype).replace("torch.", "")),
                    got) == want
    router = got["blocks"]["s0"]["moe"]["router"]
    assert router.shape[-1] == 48 and router.dtype == torch.float32
    assert torch.equal(router, torch.from_numpy(np.asarray(
        tree["blocks"]["s0"]["moe"]["router"], np.float32)))
