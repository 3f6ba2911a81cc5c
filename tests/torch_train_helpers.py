"""Set-up the port's training tests share (``tests/test_torch_train*.py``):
a reduced config in float32 in both packages with the reference's weights
carried over (``params_from_numpy``), a pipeline batch, and the
reference's loss and gradients through ``jax.value_and_grad``, jitted once
per config. Imports JAX: the card-only tests do not use it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jarch
from repro.configs import reduced as jreduced
from repro.data import DataConfig, SyntheticTokenPipeline
from repro.models import init_params as jinit
from repro.models import train_loss as jtrain_loss
from repro_torch.configs import get_arch, reduced
from repro_torch.models import StepOptions, params_from_numpy
from repro_torch.train import loss_and_grads
from repro_torch.train.loop import device_batch
from torch_port_helpers import rel_err

B, S = 4, 32


def pair(name, **over):
    """(reference cfg, port cfg, reference params, port params on the
    CPU): ``reduced(name)`` in float32, the reference's weights from
    ``PRNGKey(0)`` in both."""
    jcfg = jreduced(jarch(name), dtype="float32", **over)
    tcfg = reduced(get_arch(name), dtype="float32", **over)
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             tcfg, device="cpu")


def batch(cfg, step=0, batch_size=B, seq_len=S):
    """The training pipeline's numpy batch for ``cfg`` (frames and patches
    where the config reads them)."""
    return SyntheticTokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=batch_size,
        frames=cfg.enc_seq if cfg.is_encoder_decoder else 0,
        patches=cfg.num_patch_tokens, d_model=cfg.d_model)).batch(step)


def reference_loss_and_grads(jp, b, jcfg, jopts=None):
    fn = jax.jit(jax.value_and_grad(
        lambda p, bb: jtrain_loss(p, bb, jcfg, None, jopts)))
    loss, grads = fn(jp, {k: jnp.asarray(v) for k, v in b.items()})
    return float(loss), flat(grads)


def flat(tree, prefix=""):
    """{"/"-joined path: numpy} of a nested dict of tensors or arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    if hasattr(tree, "detach"):
        return {prefix[:-1]: tree.detach().float().cpu().numpy()}
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def check_equal_reference(name):
    jcfg, tcfg, jp, tp = pair(name)
    b = batch(tcfg)
    want_loss, want = reference_loss_and_grads(jp, b, jcfg)
    loss, grads = loss_and_grads(tp, device_batch(b, "cpu"), tcfg)
    got = flat(grads)
    assert sorted(got) == sorted(want)
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert rel_err(got[k], want[k]) <= 1e-4, (k, rel_err(got[k],
                                                             want[k]))


def check_options(name):
    """Chunked CE and remat off against the default, in the port."""
    _, tcfg, _, tp = pair(name)
    b = device_batch(batch(tcfg), "cpu")
    loss, grads = loss_and_grads(tp, b, tcfg, opts=StepOptions())
    base = flat(grads)
    for opts in (StepOptions(loss_chunk=8), StepOptions(remat=False),
                 StepOptions(remat=False, loss_chunk=8)):
        l2, g2 = loss_and_grads(tp, b, tcfg, opts=opts)
        assert abs(float(l2) - float(loss)) <= 1e-6 * abs(float(loss)), opts
        got = flat(g2)
        assert all(rel_err(got[k], base[k]) <= 1e-5 for k in base), opts



@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one intra-op thread, restored after: the models here
    are tiny, and under the suite's parallel workers torch's default of a
    thread a core oversubscribes the machine many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


__all__ = ["B", "S", "pair", "batch", "reference_loss_and_grads", "flat",
           "device_batch", "check_equal_reference", "check_options",
           "one_torch_thread"]
