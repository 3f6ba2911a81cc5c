"""The port's MoE layers in the model and the engine, against the JAX
package, on the CPU.

Config: ``reduced(llama4-maverick, num_experts=4, experts_per_token=1,
pad_to=2)`` in float32, at the config's capacity factor 1.25 (tokens are
dropped: the sharded bodies size capacity from each rank's tokens) and at
16 (nothing is dropped). The reference runs once, in one subprocess with
4 JAX host devices (``Rules`` over a 4-rank ``data`` mesh), and writes its
weights and outputs; the port takes the weights through
``params_from_numpy`` and runs on a ``VirtualMesh(4)`` data mesh, where
``moe_backend="pallas"`` computes the kernel's plain version: through
``_pallas_body`` for a batch that shards over the 4 ranks, through
``_padded_body`` for any other (the reference's gathered body there).

Tolerances, max-abs-normalised: 1e-4 in float32 (the same arithmetic in
another library, summed in another order). Greedy tokens are held at
capacity 16: at 1.25 a decode step (2 tokens a rank) and a forward over
the whole sequence drop different tokens, by the capacity rule itself,
so no cache-based decode equals a no-cache loop there.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jarch
from repro.dist.sharding import Rules as JRules
from repro.configs import reduced as jreduced
from repro.models import init_params as jinit
from repro_torch.configs import get_arch, reduced
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.dist.sharding import Rules
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (StepOptions, forward, init_params,
                                params_from_numpy)
from repro_torch.models import moe as tmoe
from repro_torch.models.model import lm_logits, with_kernel_weights
from repro_torch.serve import Engine, Request, Scheduler, ServeConfig
from torch_port_helpers import first_repeat, rel_err, run_jax_devices

ARCH = "llama4-maverick-400b-a17b"
OVER = dict(num_experts=4, experts_per_token=1, pad_to=2, dtype="float32")
CAPS = (1.25, 16.0)
B, S, NEW = 8, 12, 4
PADDED = (2, 3, 5)             # batches that do not shard over 4 ranks

REFERENCE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.configs import get_arch, reduced
from repro.dist.sharding import Rules
from repro.models import forward, init_params
from repro.models.model import lm_logits
from repro.models.moe import moe_apply
inputs = np.load(sys.argv[1])
toks, xs = jnp.asarray(inputs["tokens"]), jnp.asarray(inputs["x"])
rules = Rules(make_mesh((4,), ("data",)), "decode")
out = {}

def fwd(cfg, r):
    return jax.jit(lambda p, t: lm_logits(
        p, forward(p, {"tokens": t}, cfg, r)[0], cfg, r))

for cf in (1.25, 16.0):
    cfg = reduced(get_arch("llama4-maverick-400b-a17b"), num_experts=4,
                  experts_per_token=1, pad_to=2, capacity_factor=cf,
                  dtype="float32")
    params = init_params(jax.random.PRNGKey(0), cfg)
    out[f"sharded_{cf}"] = np.asarray(fwd(cfg, rules)(params, toks))
    out[f"local_{cf}"] = np.asarray(fwd(cfg, None)(params, toks))
    out[f"gathered_{cf}"] = np.asarray(fwd(cfg, rules)(params, toks[:2]))
    moe = jax.tree.map(lambda a: a[0], params["blocks"]["s1"]["moe"])
    layer = jax.jit(lambda m, x: moe_apply(m, x, cfg, rules))
    for b in %s:               # batches that do not shard: the gathered body
        out[f"moe_{cf}_{b}"] = np.asarray(layer(moe, xs[:b]))
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    out["param/" + "/".join(p.key for p in path)] = np.asarray(leaf)
f, seq = fwd(cfg, rules), toks
for _ in range(%d):            # no-cache greedy loop over forward, cf 16
    nxt = jnp.argmax(f(params, seq)[:, -1], -1)
    seq = jnp.concatenate([seq, nxt[:, None].astype(seq.dtype)], 1)
out["greedy"] = np.asarray(seq[:, toks.shape[1]:])
np.savez(sys.argv[2], **out)
""" % (PADDED, NEW)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    x = rng.standard_normal((max(PADDED), 3, 64)).astype(np.float32)
    out = run_jax_devices(REFERENCE, {"tokens": toks, "x": x},
                          str(tmp_path_factory.mktemp("moe_ref")))
    tree = {}
    for key, v in out.items():
        if key.startswith("param/"):
            node, parts = tree, key.split("/")[1:]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    out["tree"], out["tokens"] = tree, torch.from_numpy(toks).long()
    out["x"] = torch.from_numpy(x)
    return out


def config(cf=1.25, **over):
    return reduced(get_arch(ARCH), capacity_factor=cf, **dict(OVER, **over))


def data_rules(n=4):
    return Rules(VirtualMesh(n, device="cpu", axis="data"), "decode")


def logits(params, toks, cfg, rules, opts=None):
    if opts is not None and opts.moe_backend == "pallas":
        params = with_kernel_weights(params, cfg)
    x, _ = forward(params, {"tokens": toks}, cfg, rules, opts)
    return lm_logits(params, x, cfg)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("cf", CAPS)
def test_sharded_logits_equal_reference(ref, cf, backend, overlap):
    """The 4-rank forward through ``_alltoall_body`` or ``_pallas_body``
    (its plain version here), with and without the two-stream split,
    equals the reference's 4-device forward."""
    cfg = config(cf)
    params = params_from_numpy(ref["tree"], cfg, device="cpu")
    got = logits(params, ref["tokens"], cfg, data_rules(),
                 StepOptions(moe_backend=backend, moe_overlap=overlap))
    assert rel_err(got, ref[f"sharded_{cf}"]) <= 1e-4


@pytest.mark.parametrize("cf", CAPS)
def test_local_and_gathered_logits_equal_reference(ref, cf):
    """``rules=None`` (``_local_moe``) and a batch of 2 that does not
    shard over 4 ranks (``_gathered_body``) equal the reference's; at the
    config's capacity the sharded and local forwards differ, as the
    reference's do (capacity per rank against global)."""
    cfg = config(cf)
    params = params_from_numpy(ref["tree"], cfg, device="cpu")
    toks = ref["tokens"]
    assert rel_err(logits(params, toks, cfg, None), ref[f"local_{cf}"]) <= 1e-4
    assert rel_err(logits(params, toks[:2], cfg, data_rules()),
                   ref[f"gathered_{cf}"]) <= 1e-4
    apart = rel_err(ref[f"sharded_{cf}"], ref[f"local_{cf}"])
    assert (apart > 1e-2) if cf == 1.25 else (apart <= 1e-4)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_greedy_generate_equals_reference_forward_loop(ref, backend):
    cfg = config(16.0)
    params = params_from_numpy(ref["tree"], cfg, device="cpu")
    opts = StepOptions(moe_backend=backend, moe_overlap=True)
    eng = Engine(cfg, params, ServeConfig(max_seq=S + NEW + 1, opts=opts),
                 rules=data_rules())
    got = eng.generate({"tokens": ref["tokens"]}, NEW)
    assert np.array_equal(got.numpy(), ref["greedy"])


def test_pallas_raises_where_the_kernel_cannot_run(ref):
    """``backend="pallas"`` never takes another body: a batch that does not
    shard runs the kernel's padded layout and gives the reference's
    gathered answer; two experts a rank and a mesh with no data axis
    raise, and so do weights whose kernel operands were not built once
    beforehand, a model axis (ff tensor parallelism) and the replicated
    expert-parallel mode, which the xla bodies run."""
    cfg = config()
    params = params_from_numpy(ref["tree"], cfg, device="cpu")
    pallas = StepOptions(moe_backend="pallas")
    toks = ref["tokens"]
    with pytest.raises(ValueError, match="with_kernel_weights"):
        forward(params, {"tokens": toks}, cfg, data_rules(), pallas)
    with pytest.raises(ValueError, match="with_kernel_weights"):
        forward(params, {"tokens": toks[:2]}, cfg, data_rules(), pallas)
    assert rel_err(logits(params, toks[:2], cfg, data_rules(), pallas),
                   ref["gathered_1.25"]) <= 1e-4
    with pytest.raises(ValueError, match="not eligible"):
        logits(params, toks, cfg, data_rules(2), pallas)
    no_data = Rules(VirtualMesh(4, device="cpu"), "decode")
    with pytest.raises(ValueError, match="not eligible"):
        logits(params, toks, cfg, no_data, pallas)
    assert torch.equal(logits(params, toks, cfg, no_data),
                       logits(params, toks, cfg, None))
    with pytest.raises(ValueError, match="not eligible"):
        logits(params, toks, cfg, None, pallas)      # no mesh to shard over
    with pytest.raises(ValueError, match="backend"):
        logits(params, toks, cfg, data_rules(),
               StepOptions(moe_backend="triton"))
    model = Rules(VirtualMesh(4, device="cpu", axis="model"), "decode")
    with pytest.raises(ValueError, match="not eligible"):
        logits(with_kernel_weights(params, cfg), toks, cfg, model, pallas)
    assert rel_err(logits(params, toks, cfg, model),
                   logits(params, toks, cfg, None)) <= 1e-5
    rep = dataclasses.replace(cfg, ep_mode="replicated")
    with pytest.raises(ValueError, match="not eligible"):
        logits(with_kernel_weights(params, rep), toks, rep, data_rules(),
               pallas)
    assert torch.isfinite(logits(params, toks, rep, data_rules())).all()
    assert torch.isfinite(logits(params, toks, rep, None)).all()


def test_int8_wire_agrees_across_backends(ref):
    """The int8 dispatch of the all-to-all body and the kernel's int8 wire
    (its plain version) quantize the same rows alike. (Without the
    two-stream split: under it the all-to-all body keeps each rank's own
    rows off the wire, unquantized, as the reference's does.)"""
    cfg = config(16.0)
    params = params_from_numpy(ref["tree"], cfg, device="cpu")
    outs = [logits(params, ref["tokens"], cfg, data_rules(),
                   StepOptions(moe_backend=b, moe_quantize=True))
            for b in ("xla", "pallas")]
    assert rel_err(outs[1], outs[0]) <= 1e-5
    assert rel_err(outs[0], ref["sharded_16.0"]) <= 5e-2


def test_serve_prefills_a_rank_a_request_and_matches_generate(ref):
    """Under rules, ``serve`` prefills same-length admissions dp at a time
    (the batch shards, as the kernel needs), and its tokens equal
    ``generate``'s for the same prompts at the config's capacity; a
    leftover single prefill of 1 < dp requests is served under pallas
    through the padded layout, with the xla engine's tokens."""
    cfg = config()
    params = params_from_numpy(ref["tree"], cfg, device="cpu")
    opts = StepOptions(moe_backend="pallas", moe_overlap=True)
    prompts = ref["tokens"][:4]
    eng = Engine(cfg, params, ServeConfig(max_seq=S + NEW + 1, opts=opts),
                 rules=data_rules())
    want = eng.generate({"tokens": prompts}, NEW)
    sched = Scheduler(token_budget=4 * S, max_batch=4, metrics=eng.metrics)
    for rid in range(4):
        sched.submit(Request(rid, prompts[rid].tolist(), max_new_tokens=NEW))
    done = eng.serve(sched)
    assert all(torch.equal(done[r], want[r]) for r in range(4))
    assert eng.metrics.snapshot()["counters"]["sched.finished"] == 4
    groups = eng._prefill_groups([Request(r, [1] * (3 + r // 4))
                                  for r in range(9)])
    assert [[q.rid for q in g] for g in groups] == [[0, 1, 2, 3],
                                                    [4, 5, 6, 7], [8]]
    one = Scheduler(token_budget=S, max_batch=4)
    one.submit(Request(0, prompts[0].tolist(), max_new_tokens=2))
    xla = Engine(cfg, params, ServeConfig(max_seq=S + NEW + 1),
                 rules=data_rules())
    assert torch.equal(eng.serve(one)[0],
                       xla.generate({"tokens": prompts[:1]}, 2)[0])


@pytest.mark.parametrize("overlap,quantize", [(False, False), (True, False),
                                              (False, True)])
@pytest.mark.parametrize("b", PADDED)
@pytest.mark.parametrize("cf", CAPS)
def test_padded_body_equals_reference_gathered_body(ref, cf, b, overlap,
                                                    quantize, monkeypatch):
    """A batch of 2, 3 or 5 rows on 4 ranks under ``backend="pallas"``:
    one call of the kernel (its plain version) on the padded layout, no
    host body, equal to the reference's ``moe_apply`` (its gathered body:
    capacity and keep over all tokens) at capacity 1.25 (tokens dropped)
    and 16. The int8 wire does not apply there, in the reference's
    gathered body or here."""
    cfg = config(cf)
    params = with_kernel_weights(params_from_numpy(ref["tree"], cfg,
                                                   device="cpu"), cfg)
    rec = _count_kernel_calls(monkeypatch)
    got = tmoe.moe_apply(first_repeat(params["blocks"]["s1"]["moe"]),
                         ref["x"][:b], cfg, data_rules(), backend="pallas",
                         overlap=overlap, quantize=quantize)
    assert rec == {"kernel": 1, "bodies": [("_padded_body", b)]}
    assert rel_err(got, ref[f"moe_{cf}_{b}"]) <= 1e-5


def _count_kernel_calls(monkeypatch):
    """Count ``moe_dispatch_combine`` calls, record which kernel body each
    MoE call took (with its input's leading size: the batch for
    ``_padded_body``, the ranks for ``_pallas_body``), and make the host
    bodies raise."""
    from repro_torch.kernels import moe_dispatch as kern
    rec = {"kernel": 0, "bodies": []}
    real = kern.moe_dispatch_combine

    def count(*a, **kw):
        rec["kernel"] += 1
        return real(*a, **kw)

    def host(*a, **kw):
        raise AssertionError("a host body ran under moe_backend='pallas'")

    monkeypatch.setattr(kern, "moe_dispatch_combine", count)
    for name in ("_pallas_body", "_padded_body"):
        def tracked(x, *a, _body=getattr(tmoe, name), _name=name, **kw):
            rec["bodies"].append((_name, x.shape[0]))
            return _body(x, *a, **kw)
        monkeypatch.setattr(tmoe, name, tracked)
    for name in ("_alltoall_body", "_gathered_body", "_local_moe"):
        monkeypatch.setattr(tmoe, name, host)
    return rec


@pytest.mark.parametrize("traffic", ["staggered", "early_finish",
                                     "mixed_lengths"])
def test_serve_under_pallas_takes_lock_step_traffic_only(ref, traffic,
                                                         monkeypatch):
    """Traffic that is not lock-step, under pallas: ``serve`` groups
    decode steps by position and prefills by prompt length, so two
    requests that arrive a step later (prefills of 1, a decode group of
    2), one request that stops early (a decode group of 3) or prompts of
    other lengths make groups that do not shard over the 4 ranks. Each
    such group runs the kernel's padded layout (its plain version here):
    one kernel call a MoE layer a group, no host body. Every request
    completes with its own ``max_new_tokens``, and the tokens equal the
    xla backend's (capacity 16)."""
    cfg = config(16.0)
    params = params_from_numpy(ref["tree"], cfg, device="cpu")
    prompts = [t.tolist() for t in ref["tokens"]]
    lens = {"mixed_lengths": [12, 9, 12, 5, 9, 12]}.get(traffic, [S] * 6)
    news = {"early_finish": [2, NEW, NEW, NEW],
            "mixed_lengths": [NEW, 2, 3, NEW, NEW, 1]}.get(traffic,
                                                         [NEW] * 6)
    rids = range(6 if traffic != "early_finish" else 4)
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))

    def run(backend):
        eng = Engine(cfg, params, ServeConfig(
            max_seq=S + NEW + 1, opts=StepOptions(moe_backend=backend,
                                                  moe_overlap=True)),
            rules=data_rules())
        groups, prefill, decode = [], eng._prefill, eng._decode

        def counted_prefill(batch):
            groups.append(batch["tokens"].shape[0])
            return prefill(batch)

        def counted_decode(cache, toks, pos):
            groups.append(toks.shape[0])
            return decode(cache, toks, pos)

        eng._prefill, eng._decode = counted_prefill, counted_decode
        sched = Scheduler(token_budget=8 * S, max_batch=8)
        for rid in rids:
            if traffic != "staggered" or rid < 4:
                sched.submit(Request(rid, prompts[rid][:lens[rid]],
                                     max_new_tokens=news[rid]))

        def late(step, _):
            if traffic == "staggered" and step == 0:
                for rid in (4, 5):
                    sched.submit(Request(rid, prompts[rid], NEW))
        return eng.serve(sched, on_step=late), groups

    want, _ = run("xla")
    rec = _count_kernel_calls(monkeypatch)
    done, groups = run("pallas")
    assert sorted(done) == sorted(want) == list(rids)
    assert all(len(done[r]) == news[r] for r in rids)
    assert all(torch.equal(done[r], want[r]) for r in rids)
    assert rec["kernel"] == n_moe * len(groups)
    assert rec["bodies"] == [("_padded_body", b) if b % 4
                             else ("_pallas_body", 4)
                             for b in groups for _ in range(n_moe)]
    assert any(b % 4 for b in groups)         # some group did not shard


def test_kernel_weights_built_once_per_engine(ref):
    cfg = config()
    params = params_from_numpy(ref["tree"], cfg, device="cpu")
    eng = Engine(cfg, params, ServeConfig(opts=StepOptions(
        moe_backend="pallas")), rules=data_rules())
    moe = eng.params["blocks"]["s1"]["moe"]
    R, E, d, f = moe["wg"].shape
    fs = moe["shared"]["down"].shape[1]
    assert {k: tuple(v.shape) for k, v in moe["kernel"].items()} == {
        "w1": (R, E, d, 2 * f), "w2": (R, E, f, d), "s1": (R, d, 2 * fs),
        "s2": (R, fs, d)}
    assert all(v.dtype == torch.float32 for v in moe["kernel"].values())
    assert "kernel" not in params["blocks"]["s1"]["moe"]   # input untouched
    assert "moe" not in eng.params["blocks"]["s0"]
    same = with_kernel_weights(params, cfg)["blocks"]["s1"]["moe"]["kernel"]
    assert torch.equal(same["w1"], moe["kernel"]["w1"])
    xla = Engine(cfg, params, ServeConfig(), rules=data_rules())
    assert xla.params is params


def test_moe_params_match_reference_shapes_and_router_stays_f32():
    for name in (ARCH, "granite-moe-3b-a800m"):
        tcfg = reduced(get_arch(name))
        tp = init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
        jp = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0),
                                          jreduced(jarch(name))))
        assert jax.tree.map(lambda t: tuple(t.shape), tp) \
            == jax.tree.map(lambda a: a.shape, jp)
    cfg = reduced(get_arch(ARCH))                 # bfloat16
    jp = jinit(jax.random.PRNGKey(0), jreduced(jarch(ARCH)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    moe = tp["blocks"]["s1"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["wg"].dtype == torch.bfloat16
    assert torch.equal(moe["router"], torch.from_numpy(np.array(
        jp["blocks"]["s1"]["moe"]["router"])))


def test_bf16_backends_agree_to_f32_sums():
    """In bfloat16 every body computes its FFNs in float32 and rounds the
    output, so the all-to-all body and the kernel's plain version agree."""
    cfg = reduced(get_arch(ARCH), num_experts=4, experts_per_token=1,
                  pad_to=2)
    params = init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (4, 10),
                         generator=torch.Generator().manual_seed(2))
    outs = [logits(params, toks, cfg, data_rules(),
                   StepOptions(moe_backend=b, moe_overlap=True))
            for b in ("xla", "pallas")]
    assert outs[0].dtype == torch.float32
    assert rel_err(outs[1], outs[0]) <= 1e-2


def test_serve_entry_point_on_the_cpu(capsys):
    launch_serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "8",
                       "--prompt-len", "6", "--new-tokens", "3", "--ep", "8",
                       "--moe-backend", "pallas", "--moe-overlap"])
    out = capsys.readouterr().out
    assert "24 tokens" in out and "moe_backend=pallas, ep=8" in out
    launch_serve.main(["--arch", "llama3.2-1b", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "4", "--new-tokens",
                       "2", "--disaggregated"])
    assert "mode=disaggregated" in capsys.readouterr().out
    assert tmoe.pallas_moe_eligible(reduced(get_arch(ARCH)), data_rules(8),
                                    8)


def test_chip_smoke_serve_moe_on_the_cpu():
    """The smoke's serve_moe phase at the reduced size on the CPU (the
    plain version, so no launch is counted); the full config keeps every
    published width and cuts depth to one repeat unit and the experts to
    one per rank."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    assert chip_smoke.phase_serve_moe(
        "cpu", chip_smoke.moe_engine_config(small=True),
        chip_smoke.moe_serve_shape(small=True)) == {}
    cfg, ref_cfg = chip_smoke.moe_engine_config(), get_arch(ARCH)
    assert dataclasses.asdict(cfg) == dict(
        dataclasses.asdict(ref_cfg), num_layers=4, num_experts=4, pad_to=4)
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
            cfg.moe_d_ff, cfg.d_ff, cfg.vocab_size, cfg.experts_per_token,
            cfg.capacity_factor, cfg.shared_expert, cfg.ep_mode) == (
        5120, 40, 8, 128, 8192, 16384, 202048, 1, 1.25, True, "alltoall")
    assert cfg.num_experts_padded == 4 and cfg.num_repeats == 1
    assert [cfg.layer_is_moe(i) for i in range(4)] == [False, True] * 2
    assert 3.9e9 < cfg.param_count() < 4.2e9
    assert chip_smoke.moe_serve_shape() == (8, 512, 32)
    assert chip_smoke.moe_call_shapes(cfg, (8, 512, 32)) == [
        ("prefill", 1024, 320), ("decode", 2, 1)]


@pytest.mark.parametrize("v,step", [(5.906, 2.0 ** -5), (4.0, 2.0 ** -5),
                                    (-0.75, 2.0 ** -8), (1.0, 2.0 ** -7),
                                    (0.0, 0.0)])
def test_chip_smoke_bf16_step(v, step):
    """The gap ``serve_moe`` allows the xla pick at the streams' first
    split: one bf16 step at the logit's magnitude, as torch rounds."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    assert chip_smoke._bf16_step(abs(v)) == step
    if v:
        t = torch.tensor(abs(v), dtype=torch.bfloat16)
        assert float(torch.nextafter(t, t + 1) - t) == step


@pytest.mark.parametrize("axis", ["data", "pod", "model", "x"])
def test_rules_answer_as_the_reference_does(axis):
    """The port's ``Rules`` over a ``VirtualMesh`` answer the queries the
    models make as the reference's ``Rules`` over the same named axes;
    ``shard`` is the identity on one device."""
    mesh = VirtualMesh(4, device="cpu", axis=axis)
    for kind in ("decode", "train"):
        t, j = Rules(mesh, kind), JRules(mesh, kind)
        assert (t.dp_axes, t.tp_axes, t.dp_size(), t.table) == (
            j.dp_axes, j.tp_axes, j.dp_size(), j.table)
        assert all(t.axes(n) == j.axes(n) for n in j.table)
    x = torch.zeros(2, 3)
    assert t.shard(x, "batch", None) is x


def test_chip_smoke_serve_mixed_on_the_cpu():
    """The smoke's serve_mixed phase at the reduced size on the CPU (the
    kernel's plain version, so no launch is counted), and the two records
    of this slice's shapes: the padded decode group (C = 1 from 3 rows on
    4 ranks) and whisper's cross handoff."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    assert chip_smoke.phase_serve_mixed(
        "cpu", chip_smoke.moe_engine_config(small=True),
        chip_smoke.mixed_traffic(small=True)) == {}
    lens, news, late = chip_smoke.mixed_traffic()
    assert (lens, news, late) == ([512, 512, 384, 384, 256, 128],
                                  [32, 8, 32, 16, 32, 24], (2, 3))
    assert [lens[r] for r in late] == [384, 384]
    recs = chip_smoke.phase_serve_kernels(
        "cpu", iters=1, moe_cfg=chip_smoke.moe_engine_config(small=True),
        whisper=chip_smoke.kind_configs(small=True)[2])
    assert [(r["_path"], r["_key"][1:]) for r in recs] == [
        ("serve_mixed", (4, 4, 64, 64)), ("serve_kinds", (64, 16, "bfloat16"))]
    assert all(r["max_abs_err"] == 0.0 for r in recs)   # the plain version
