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
def test_pallas_raises_for_a_batch_that_does_not_shard(cuda_device):
    cfg, params, rules = setup(cuda_device)
    toks = torch.zeros((2, 4), dtype=torch.long, device=cuda_device)
    with pytest.raises(ValueError, match="not eligible"):
        forward(params, {"tokens": toks}, cfg, rules,
                StepOptions(moe_backend="pallas"))
