"""MoE layers through the Hopper moe_dispatch kernel inside the model and
the engine, on the card.

Marked ``gpu``: each test skips (inside a fixture) where there is no H100
and ``nvcc``. Imports only torch and the port (the card's machine has no
JAX):

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_moe_model.py

Config: ``reduced(llama4-maverick, num_experts=4, experts_per_token=1,
pad_to=2)`` in float32 (d = 64, expert d_ff = 64: the kernel's 64-wide
tiles), weights from a seed, a ``VirtualMesh(4)`` data mesh on the card.
``moe_backend="pallas"`` launches ``moe_dispatch.cu``; ``"xla"`` runs the
all-to-all body on the card's operators. Tolerance 1e-4
max-abs-normalised (f32 on both sides, sums in another order; TF32 off).
"""
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.dist.sharding import Rules
from repro_torch.kernels import moe_dispatch as kern
from repro_torch.models import StepOptions, forward, init_params
from repro_torch.models import moe as tmoe
from repro_torch.models.model import lm_logits, with_kernel_weights
from repro_torch.serve import Engine, ServeConfig
from torch_port_helpers import rel_err


@pytest.fixture
def cuda_device():
    from repro_torch import compat
    if not compat.has_hopper():
        pytest.skip("needs an H100 (compute capability 9.0) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def setup(device, cf=1.25, seed=0):
    cfg = reduced(get_arch("llama4-maverick-400b-a17b"), num_experts=4,
                  experts_per_token=1, pad_to=2, capacity_factor=cf,
                  dtype="float32")
    params = init_params(torch.Generator(device=device).manual_seed(seed),
                         cfg, device=device)
    rules = Rules(VirtualMesh(4, device=device, axis="data"), "decode")
    return cfg, params, rules


@pytest.mark.gpu
@pytest.mark.parametrize("overlap,quantize", [(False, False), (True, False),
                                              (False, True)])
@pytest.mark.parametrize("B,S", [(8, 16), (4, 1), (8, 1), (4, 40)])
def test_moe_apply_kernel_matches_host_body(cuda_device, B, S, overlap,
                                            quantize):
    """``moe_apply`` through the kernel against the all-to-all body on the
    same card, at prefill-like and decode-like shapes (S = 1: one token a
    row, C = 1, one-row microblocks); the int8 wire without the split,
    where both quantize every row (1e-3: a tie may round the other way)."""
    cfg, params, rules = setup(cuda_device)
    p = with_kernel_weights(params, cfg)["blocks"]["s1"]["moe"]
    p = {k: (v[0] if torch.is_tensor(v) else {n: t[0] for n, t in v.items()})
         for k, v in p.items()}
    g = torch.Generator(device=cuda_device).manual_seed(B * 100 + S)
    x = torch.randn((B, S, cfg.d_model), generator=g, device=cuda_device)
    kw = dict(overlap=overlap, quantize=quantize)
    before = kern.launches()
    got = tmoe.moe_apply(p, x, cfg, rules, backend="pallas", **kw)
    torch.cuda.synchronize()
    assert kern.launches() == before + 1
    want = tmoe.moe_apply(p, x, cfg, rules, backend="xla", **kw)
    assert got.shape == want.shape == x.shape
    assert torch.isfinite(got).all()
    assert rel_err(got.cpu(), want.cpu()) <= (1e-3 if quantize else 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("cf", [1.25, 16.0])
def test_forward_logits_kernel_matches_host_body(cuda_device, cf):
    cfg, params, rules = setup(cuda_device, cf)
    toks = torch.randint(0, cfg.vocab_size, (8, 24), device=cuda_device,
                         generator=torch.Generator(
                             device=cuda_device).manual_seed(1))
    out = []
    for backend, p in (("xla", params),
                       ("pallas", with_kernel_weights(params, cfg))):
        x, _ = forward(p, {"tokens": toks}, cfg, rules,
                       StepOptions(moe_backend=backend, moe_overlap=True))
        out.append(lm_logits(p, x, cfg).cpu())
    assert rel_err(out[1], out[0]) <= 1e-4


@pytest.mark.gpu
def test_engine_tokens_equal_across_backends(cuda_device):
    """A short engine run: the kernel's greedy tokens equal the host
    body's, with one launch a MoE layer a step."""
    cfg, params, rules = setup(cuda_device, 16.0)
    toks = torch.randint(0, cfg.vocab_size, (8, 12), device=cuda_device,
                         generator=torch.Generator(
                             device=cuda_device).manual_seed(2))
    outs = []
    for backend in ("xla", "pallas"):
        eng = Engine(cfg, params, ServeConfig(max_seq=24, opts=StepOptions(
            moe_backend=backend, moe_overlap=True)), rules=rules)
        before = kern.launches()
        outs.append(eng.generate({"tokens": toks}, 6).cpu())
        launched = kern.launches() - before
    assert launched == 2 * 6                    # 2 MoE layers x 6 steps
    assert torch.equal(outs[0], outs[1])


@pytest.mark.gpu
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("cf", [1.25, 16.0])
@pytest.mark.parametrize("B,S", [(3, 1), (1, 1), (2, 16), (5, 3), (1, 40)])
def test_padded_batch_kernel_matches_gathered_body(cuda_device, B, S, cf,
                                                   overlap):
    """A batch that does not shard over the 4 ranks (decode groups of 1
    and 3 rows, prefills of 1, 2 and 5 requests): one launch of the
    kernel on the padded layout against ``_gathered_body`` (the
    reference's body for that batch) on the same card, at capacity 1.25
    (tokens dropped by the global capacity) and 16."""
    cfg, params, rules = setup(cuda_device, cf)
    p = with_kernel_weights(params, cfg)["blocks"]["s1"]["moe"]
    p = {k: (v[0] if torch.is_tensor(v) else {n: t[0] for n, t in v.items()})
         for k, v in p.items()}
    g = torch.Generator(device=cuda_device).manual_seed(B * 100 + S)
    x = torch.randn((B, S, cfg.d_model), generator=g, device=cuda_device)
    before = kern.launches()
    got = tmoe.moe_apply(p, x, cfg, rules, backend="pallas", overlap=overlap)
    torch.cuda.synchronize()
    assert kern.launches() == before + 1
    want = tmoe._gathered_body(x.reshape(B * S, -1), p, cfg,
                               rules).reshape(x.shape)
    assert torch.isfinite(got).all()
    assert rel_err(got.cpu(), want.cpu()) <= 1e-4


@pytest.mark.gpu
def test_engine_serves_mixed_traffic_through_the_kernel(cuda_device):
    """Requests of other lengths, admitted on other steps, finishing at
    other times: every group (most of them do not shard) launches the
    kernel once a MoE layer, and the tokens equal the host body's."""
    from repro_torch.serve import Request, Scheduler
    cfg, params, rules = setup(cuda_device, 16.0)
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))
    g = torch.Generator(device=cuda_device).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (6, 12), device=cuda_device,
                         generator=g).tolist()
    lens, news = [12, 12, 9, 9, 7, 5], [6, 2, 6, 4, 6, 5]
    out = {}
    for backend in ("xla", "pallas"):
        eng = Engine(cfg, params, ServeConfig(max_seq=24, opts=StepOptions(
            moe_backend=backend, moe_overlap=True)), rules=rules)
        sched = Scheduler(token_budget=64, max_batch=8, metrics=eng.metrics)
        for rid in (0, 1, 4, 5):
            sched.submit(Request(rid, toks[rid][:lens[rid]], news[rid]))

        def late(step, _):
            if step == 1:
                for rid in (2, 3):
                    sched.submit(Request(rid, toks[rid][:lens[rid]],
                                         news[rid]))

        before = kern.launches()
        out[backend] = eng.serve(sched, on_step=late)
        torch.cuda.synchronize()
        launched = kern.launches() - before
        c = eng.metrics.snapshot()["counters"]
    groups = c["serve.decode_steps"] + c["serve.prefills"]  # prefills of 1
    assert launched == n_moe * groups
    assert all(len(out["pallas"][r]) == news[r] for r in range(6))
    assert all(torch.equal(out["pallas"][r], out["xla"][r])
               for r in range(6))
