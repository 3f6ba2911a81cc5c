"""The port's MoE under a two-axis mesh — granite-moe's replicated expert
body and llama4-maverick's ff-sharded all-to-all and gathered bodies —
against the JAX package, on the CPU.

Configs, in float32: ``reduced(granite-moe-3b-a800m)`` (8 experts, top-2,
``ep_mode="replicated"``: experts over the model axis), the same at
granite's published expert count (40 padded to 48, top-8: the 8 padded
experts take no token) and ``reduced(llama4-maverick, num_experts=4,
experts_per_token=1, pad_to=2)`` (``alltoall``: experts over the data
axis, each expert's ff over the model axis, a shared expert). Meshes:
``("data", "model")`` of shape (1, 4) and (2, 2), and ``("data",)`` of 4.
Capacities: the config's own (1.5 and 1.25: tokens are dropped, and every
sharded body sizes capacity from each data rank's tokens, as the
reference's does) and 16 (nothing is dropped). Batches of 8 shard over
every mesh; batches of 3 do not shard over 2 or 4 data ranks (granite's
body then runs the whole batch on every rank; llama4's takes the gathered
body).

The reference runs once, in one subprocess with 4 JAX host devices, and
writes its weights and logits; the port takes the weights through
``params_from_numpy``. Tolerance, max-abs-normalised: 1e-4 (the same
float32 arithmetic in another library, the ranks' partials summed in
another order). Greedy tokens are held at capacity 16, the engine's
cached decode against the reference's no-cache loop over ``forward`` on
the (2, 2) mesh (with nothing dropped every mesh computes the same
function).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.dist.sharding import Rules
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import StepOptions, forward, params_from_numpy
from repro_torch.models.model import lm_logits, with_kernel_weights
from repro_torch.serve import Engine, ServeConfig
from torch_port_helpers import rel_err, run_jax_devices

ARCHS = {"granite": ("granite-moe-3b-a800m", {}),
         "granite48": ("granite-moe-3b-a800m",
                       dict(num_experts=40, experts_per_token=8, pad_to=16)),
         "llama4": ("llama4-maverick-400b-a17b",
                    dict(num_experts=4, experts_per_token=1, pad_to=2))}
MESHES = {"1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4": ((4,), ("data",))}
B, S, NEW = 8, 12, 3
BATCHES = {"granite": (8, 3), "granite48": (8,), "llama4": (8, 3)}
GREEDY = ("granite", "llama4")

REFERENCE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.configs import get_arch, reduced
from repro.dist.sharding import Rules
from repro.models import forward, init_params
from repro.models.model import lm_logits
ARCHS, MESHES, BATCHES, GREEDY, NEW = %r, %r, %r, %r, %r
toks = jnp.asarray(np.load(sys.argv[1])["tokens"])
out = {}

def fwd(cfg, r):
    return jax.jit(lambda p, t: lm_logits(
        p, forward(p, {"tokens": t}, cfg, r)[0], cfg, r))

for arch, (name, over) in ARCHS.items():
    base = reduced(get_arch(name), dtype="float32", **over)
    params = init_params(jax.random.PRNGKey(0), base)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out[f"{arch}/param/" + "/".join(p.key for p in path)] = \\
            np.asarray(leaf)
    for cf in (base.capacity_factor, 16.0):
        cfg = reduced(get_arch(name), dtype="float32", capacity_factor=cf,
                      **over)
        for mname, (shape, axes) in MESHES.items():
            f = fwd(cfg, Rules(make_mesh(shape, axes), "decode"))
            for b in BATCHES[arch]:
                out[f"{arch}/{cf}/{mname}/{b}"] = np.asarray(f(params,
                                                               toks[:b]))
    if arch in GREEDY:            # no-cache greedy loop at capacity 16
        f, seq = fwd(cfg, Rules(make_mesh(*MESHES["2x2"]), "decode")), toks
        for _ in range(NEW):
            nxt = jnp.argmax(f(params, seq)[:, -1], -1)
            seq = jnp.concatenate([seq, nxt[:, None].astype(seq.dtype)], 1)
        out[f"{arch}/greedy"] = np.asarray(seq[:, toks.shape[1]:])
np.savez(sys.argv[2], **out)
""" % (ARCHS, MESHES, BATCHES, GREEDY, NEW)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    toks = np.random.default_rng(0).integers(0, 256, (B, S)).astype(
        np.int32)
    out = run_jax_devices(REFERENCE, {"tokens": toks},
                          str(tmp_path_factory.mktemp("moe_tp_ref")))
    trees = {arch: {} for arch in ARCHS}
    for key, v in out.items():
        arch, kind, *parts = key.split("/")
        if kind == "param":
            node = trees[arch]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    out["trees"], out["tokens"] = trees, torch.from_numpy(toks).long()
    return out


def config(arch, cf=None):
    name, over = ARCHS[arch]
    cfg = reduced(get_arch(name), dtype="float32", **over)
    return cfg if cf is None else dataclasses.replace(cfg,
                                                      capacity_factor=cf)


def rules(mesh):
    return Rules(make_mesh(*MESHES[mesh], device="cpu"), "decode")


def logits(params, toks, cfg, r, opts=None):
    x, _ = forward(params, {"tokens": toks}, cfg, r, opts)
    return lm_logits(params, x, cfg)


CASES = [(arch, cf, mesh, b) for arch in ARCHS for cf in ("own", 16.0)
         for mesh in MESHES for b in BATCHES[arch]]


@pytest.mark.parametrize("arch,cf,mesh,b", CASES)
def test_sharded_forward_equals_reference(ref, arch, cf, mesh, b):
    """granite through ``_replicated_body`` (experts over the model axis,
    psum; no model axis: every expert on every rank), llama4 through the
    ff-sharded ``_alltoall_body`` or, for a batch that does not shard,
    ``_gathered_body``."""
    cfg = config(arch, None if cf == "own" else cf)
    params = params_from_numpy(ref["trees"][arch], cfg, device="cpu")
    got = logits(params, ref["tokens"][:b], cfg, rules(mesh))
    assert torch.isfinite(got).all()
    assert rel_err(got, ref[f"{arch}/{cfg.capacity_factor}/{mesh}/{b}"]) \
        <= 1e-4


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", GREEDY)
def test_engine_greedy_equals_reference(ref, arch, mesh):
    cfg = config(arch, 16.0)
    params = params_from_numpy(ref["trees"][arch], cfg, device="cpu")
    eng = Engine(cfg, params, ServeConfig(max_seq=S + NEW + 1),
                 rules=rules(mesh))
    got = eng.generate({"tokens": ref["tokens"]}, NEW)
    assert np.array_equal(got.numpy(), ref[f"{arch}/greedy"])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_pallas_raises_where_the_kernel_cannot_run(ref, arch, mesh):
    """The kernel takes alltoall experts over one data axis, one a rank,
    and no model axis: every other mesh and config raises, never taking a
    host body. llama4 on the data-only mesh is its deployment."""
    cfg = config(arch)
    params = with_kernel_weights(
        params_from_numpy(ref["trees"][arch], cfg, device="cpu"), cfg)
    opts = StepOptions(moe_backend="pallas")
    if arch == "llama4" and mesh == "4":
        got = logits(params, ref["tokens"], cfg, rules(mesh), opts)
        assert rel_err(got, ref[f"llama4/{cfg.capacity_factor}/4/8"]) <= 1e-4
        return
    with pytest.raises(ValueError, match="not eligible"):
        logits(params, ref["tokens"], cfg, rules(mesh), opts)
    eng = Engine(cfg, params, ServeConfig(max_seq=S + 2, opts=opts),
                 rules=rules(mesh))
    with pytest.raises(ValueError, match="not eligible"):
        eng.generate({"tokens": ref["tokens"]}, 1)


def test_chip_smoke_serve_tp_on_the_cpu():
    """Phase ``serve_tp`` at a tiny size: granite on the (1, 4) and (4,)
    meshes (2 layers, narrow widths, 2 new tokens) with the handoff's
    plain version, llama4 on (4, 2) against (4,), pallas raising."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    got = chip_smoke.phase_serve_tp("cpu", small=True)
    assert got == {}                  # no kv launches without a card
    cfg = chip_smoke.tp_engine_config()
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.num_experts, cfg.num_experts_padded, cfg.experts_per_token,
            cfg.moe_d_ff, cfg.vocab_size, cfg.capacity_factor, cfg.ep_mode,
            cfg.dtype) == (32, 1536, 24, 8, 40, 48, 8, 512, 49155, 1.5,
                           "replicated", "bfloat16")
    assert chip_smoke.tp_serve_shape() == (8, 512, 32)
    recs = chip_smoke.phase_tp_kernels("cpu", iters=1, small=True)
    assert [(r["_path"], r["_key"][1:]) for r in recs] == [
        ("serve_tp", (2 * 8 * 19 * 2, 16, "bfloat16"))]
    assert recs[0]["max_abs_err"] == 0.0      # the plain version



@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_weights_keep_whole_what_the_specs_replicate(arch, mesh):
    """Each body's weights: a group whose ``moe_param_specs`` cut nothing
    on the mesh is the params' own tensors, named in ``"whole"``; any
    other is cut to one shard a rank."""
    from repro_torch.dist.sharding import replicated
    from repro_torch.models import init_params
    from repro_torch.models.moe import _rank_weights, moe_param_specs
    cfg, r = config(arch), rules(mesh)
    blocks = init_params(torch.Generator().manual_seed(0), cfg,
                         device="cpu")["blocks"]
    p = next(b["moe"] for b in blocks.values() if "moe" in b)
    p = {k: (v[0] if torch.is_tensor(v) else {a: b[0] for a, b in v.items()})
         for k, v in p.items()}                  # one layer of the stack
    specs = moe_param_specs(cfg, r)
    w = _rank_weights(p, cfg, r)
    groups = {"experts": {k: (p[k], specs[k]) for k in ("wg", "wu", "wd")}}
    if cfg.shared_expert:
        groups["shared"] = {k: (v, specs["shared"][k])
                            for k, v in p["shared"].items()}
    for g, leaves in groups.items():
        whole = all(replicated(s, r.mesh) for _, s in leaves.values())
        assert (g in w["whole"]) == whole
        for k, (t, _) in leaves.items():
            if whole:
                assert w[g][k] is t
            else:
                assert w[g][k].shape[0] == r.mesh.n
    assert ("experts" in w["whole"]) == (arch != "llama4" and mesh == "4")


def test_record_routes_logs_every_layer_routing():
    """``record_routes`` sees each MoE layer's routing once a call, on a
    mesh (a leading rank axis) and with none; on the CPU granite's (1, 4)
    routing equals the no-mesh one."""
    from repro_torch.models import init_params
    from repro_torch.models.moe import record_routes
    cfg = config("granite")
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(1))
    with record_routes() as local:
        logits(params, toks, cfg, None)
    with record_routes() as tp:
        logits(params, toks, cfg, rules("1x4"))
    assert len(local) == len(tp) == cfg.num_layers
    for (ll, li), (tl, ti) in zip(local, tp):
        assert ll.shape == (1, B * S, cfg.num_experts_padded)
        assert ti.shape == (4, B * S, cfg.experts_per_token)
        assert torch.equal(li[0], ti[0])
    with record_routes() as none:
        pass
    assert none == []


def _smoke():
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("where", ["lp", "lx"])
def test_chip_smoke_hold_streams_fails_on_nan(where):
    """A NaN in either engine's logits fails the stream hold (a NaN error
    compares false with any limit)."""
    cs = _smoke()
    g = torch.Generator().manual_seed(0)
    lp = torch.randn(2, 3, 16, generator=g)
    toks = lp.argmax(-1)
    assert cs._hold_streams("t", toks, lp, toks, lp.clone()).max() == 0
    lx = lp.clone()
    (lp if where == "lp" else lx)[1, 2, toks[1, 2]] = float("nan")
    with pytest.raises(SystemExit, match="disagree"):
        cs._hold_streams("t", toks, lp, toks, lx)


def test_chip_smoke_route_splits_name_the_tokens_and_margins():
    """Where two recorded routings differ: the step, the MoE layer, the
    token row and each engine's k-th-against-(k+1)-th logit margin."""
    cs = _smoke()
    la = torch.tensor([[[3.0, 2.0, 1.0, 0.5], [4.0, 1.0, 1.1, 0.0]]])
    lb = la.clone()
    lb[0, 1, 1] = 1.2                              # row 1 takes expert 1
    route = [(la, la.topk(2).indices)]
    other = [(lb, lb.topk(2).indices)]
    got = cs._route_splits([route, route], [route, other], 2)
    assert got[0] == []
    assert [(s[0], s[1]) for s in got[1]] == [(0, 1)]
    assert got[1][0][2] == pytest.approx(1.1 - 1.0)
    assert got[1][0][3] == pytest.approx(1.2 - 1.1)
