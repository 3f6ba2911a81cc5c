"""The port's training loss and its gradients against the JAX package's,
on the CPU, for the architectures that are not plain attention stacks:
xLSTM (mLSTM's chunkwise scan and sLSTM's cell, 32 tokens over mLSTM
chunks of 8), RecurrentGemma (RG-LRU's log-depth scan, local attention),
whisper (the encoder over the pipeline's ``frames``, cross attention in
every decoder block) and llava (the pipeline's ``patches`` in place of
the first tokens, whose labels are -1).

Set-up and tolerances as ``test_torch_train_loss.py``: reduced configs in
float32 with the reference's weights, one pipeline batch of 4 x 32, the
loss within 1e-5 and every gradient leaf within 1e-4 against
``jax.value_and_grad``; the chunked loss and remat off against the
default in the port.
"""
import numpy as np
import pytest

from repro_torch.train import loss_and_grads
from torch_train_helpers import (batch, check_equal_reference, check_options,
                                 device_batch, flat, pair)
from torch_train_helpers import one_torch_thread  # noqa: F401 (autouse)

KINDS = ["xlstm-350m", "recurrentgemma-9b", "whisper-large-v3",
         "llava-next-mistral-7b"]


@pytest.mark.parametrize("name", KINDS)
def test_loss_and_grads_equal_reference(name):
    check_equal_reference(name)


@pytest.mark.parametrize("name", KINDS)
def test_chunked_loss_and_remat_off_equal_default(name):
    check_options(name)


def test_stub_inputs_reach_the_gradient():
    """whisper's encoder weights and llava's every leaf get a gradient
    from the frames and the patches; the patch positions are not scored
    (the loss is the same whatever the labels say there)."""
    _, tcfg, _, tp = pair("whisper-large-v3")
    _, grads = loss_and_grads(tp, device_batch(batch(tcfg), "cpu"), tcfg)
    enc = flat(grads["enc"]["blocks"])
    assert all(np.abs(v).max() > 0 for v in enc.values())
    _, tcfg, _, tp = pair("llava-next-mistral-7b")
    b = batch(tcfg)
    assert (b["labels"][:, :tcfg.num_patch_tokens] == -1).all()
    loss, _ = loss_and_grads(tp, device_batch(b, "cpu"), tcfg)
    b["labels"][:, :tcfg.num_patch_tokens] = -7       # still not scored
    loss2, _ = loss_and_grads(tp, device_batch(b, "cpu"), tcfg)
    assert float(loss2) == float(loss)
