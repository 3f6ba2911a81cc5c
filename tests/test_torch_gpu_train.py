"""The trainer's arithmetic on the card against the port on the CPU.

Marked ``gpu``: each test skips (inside a fixture) where there is no H100
and ``nvcc``. Imports only torch and the port (the card's machine has no
JAX):

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_train.py

Every config, ``reduced()`` in float32, weights from a seed on the CPU
copied to the card, one pipeline batch of 4 x 32; granite-moe also on a
(2, 2) data x model ``VirtualMesh``. ``train_loss`` and every gradient
leaf, then one ``adamw_update`` from the CPU's gradients (parameters,
``m``, ``v``, ``master``, the gradient norm), each within 1e-4
max-abs-normalised of the same on the CPU (float32 on both, TF32 off; the
card's kernels sum in another order). AdamW's first step moves each
parameter by about ``lr * sign(g)``, so a gradient entry near zero that
the two devices round to opposite signs moves it by ``2 lr`` apart: the
update is held on the same gradients, the gradients on their own. No
hand-written kernel runs: the trainer launches none.
"""
import pytest
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.dist.sharding import Rules, tree_map
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.train import loss_and_grads
from repro_torch.train.loop import device_batch
from torch_port_helpers import rel_err


@pytest.fixture
def cuda_device():
    from repro_torch import compat
    if not compat.has_hopper():
        pytest.skip("needs an H100 (compute capability 9.0) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree.detach().float().cpu()}


def _close(got, want, what):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert rel_err(got[k].numpy(), want[k].numpy()) <= 1e-4, (what, k)


CASES = [(name, None) for name in sorted(ARCHS)] + [
    ("granite-moe-3b-a800m", (2, 2))]


@pytest.mark.gpu
@pytest.mark.parametrize("name,mesh", CASES)
def test_train_step_on_the_card_equals_cpu(cuda_device, name, mesh):
    cfg = reduced(ARCHS[name], dtype="float32")
    cpu = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = tree_map(lambda t: t.to(cuda_device), cpu)
    b = SyntheticTokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
        frames=cfg.enc_seq if cfg.is_encoder_decoder else 0,
        patches=cfg.num_patch_tokens, d_model=cfg.d_model)).batch(0)
    out = {}
    devs = (("cpu", cpu), (cuda_device, card))
    for dev, params in devs:
        rules = Rules(make_mesh(mesh, ("data", "model"), device=dev),
                      "train") if mesh else None
        loss, grads = loss_and_grads(params, device_batch(b, dev), cfg,
                                     rules)
        out[dev] = [float(loss), grads]
    for dev, params in devs:
        grads = tree_map(lambda t: t.to(dev), out["cpu"][1])
        new, state, gnorm = adamw_update(
            tree_map(lambda t: t.clone(), params), grads,
            init_opt_state(params), AdamWConfig(peak_lr=1e-3,
                                                warmup_steps=0))
        out[dev] += [new, state, float(gnorm)]
    (lc, gc, pc, sc, nc), (lg, gg, pg, sg, ng) = out["cpu"], out[cuda_device]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    assert abs(ng - nc) <= 1e-4 * abs(nc)
    _close(gg, gc, "grads")
    _close(pg, pc, "params")
    for k in ("m", "v", "master"):
        _close(sg[k], sc[k], k)
