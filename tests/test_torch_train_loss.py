"""The port's training loss and its gradients against the JAX package's,
on the CPU: the attention architectures (dense, GQA, MoE with replicated
and all-to-all experts, chunked and NoPE attention in llama4).

Each config is ``reduced()`` in float32 with the reference's weights
(``params_from_numpy``) and one pipeline batch of 4 x 32. The reference
runs ``jax.value_and_grad(train_loss)``, jitted once per config; the port
runs autograd (``train.loop.loss_and_grads``, remat on). Tolerances: the
loss within 1e-5 (relative) and every gradient leaf within 1e-4,
max-abs-normalised (the same float32 arithmetic in another library, sums
in another order). Within the port: the chunked loss (``loss_chunk`` 8)
and remat off against the default, within 1e-6 for the loss and 1e-5 for
the gradients (the same operators, the CE summed in chunks); remat's
recomputation counted by a recorder; pallas raising under autograd; and
``VirtualMesh``'s collectives under ``torch.autograd.gradcheck``.
"""
import numpy as np
import pytest
import torch

from repro_torch.models import StepOptions
from repro_torch.models.moe import record_routes
from repro_torch.train import loss_and_grads
from torch_train_helpers import (batch, check_equal_reference, check_options,
                                 device_batch, flat, pair)
from torch_train_helpers import one_torch_thread  # noqa: F401 (autouse)

ATTN = ["granite-20b", "granite-moe-3b-a800m", "llama3.2-1b",
        "llama4-maverick-400b-a17b", "phi3-mini-3.8b", "stablelm-12b"]


@pytest.mark.parametrize("name", ATTN)
def test_loss_and_grads_equal_reference(name):
    check_equal_reference(name)


@pytest.mark.parametrize("name", ATTN)
def test_chunked_loss_and_remat_off_equal_default(name):
    check_options(name)


def test_remat_recomputes_each_repeat_in_the_backward_pass():
    """A recorder inside a checkpointed forward logs the recomputation
    too: granite's routings (one per MoE layer and call) counted over the
    forward and the backward pass — once each with remat off, twice with
    it on — and none under ``no_grad`` (prefill and decode take no
    checkpoint)."""
    _, tcfg, _, tp = pair("granite-moe-3b-a800m", num_layers=2)
    b = device_batch(batch(tcfg), "cpu")
    for remat, calls in ((False, 2), (True, 4)):
        with record_routes() as routes:
            loss_and_grads(tp, b, tcfg, opts=StepOptions(remat=remat))
        assert len(routes) == calls, remat
    from repro_torch.models import forward
    with torch.no_grad(), record_routes() as routes:
        forward(tp, b, tcfg)
    assert len(routes) == 2


def test_pallas_backend_raises_under_autograd():
    """The kernel has no backward: ``train_loss`` under
    ``moe_backend="pallas"`` raises rather than dropping the experts'
    gradients, on a mesh the kernel could otherwise take (alltoall, one
    expert a data rank) and without one."""
    from repro_torch.dist.mesh import VirtualMesh
    from repro_torch.dist.sharding import Rules
    from repro_torch.models.model import with_kernel_weights
    _, tcfg, _, tp = pair("llama4-maverick-400b-a17b", num_experts=4,
                          experts_per_token=1, pad_to=2)
    b = device_batch(batch(tcfg), "cpu")
    rules = Rules(VirtualMesh(4, device="cpu", axis="data"), "train")
    for r in (rules, None):
        with pytest.raises(ValueError, match="no backward"):
            loss_and_grads(with_kernel_weights(tp, tcfg), b, tcfg, r,
                           StepOptions(moe_backend="pallas"))
    # the same weights under xla carry a gradient to every expert leaf
    # (not to the router: at top-1 the softmax over one gate is 1)
    _, grads = loss_and_grads(tp, b, tcfg, rules, StepOptions())
    moe = flat(grads["blocks"]["s1"]["moe"])
    del moe["router"]
    assert all(np.abs(v).max() > 0 for v in moe.values()), moe.keys()


@pytest.mark.parametrize("shape,axes", [((4,), ("data",)),
                                        ((2, 2), ("data", "model")),
                                        ((1, 4), ("data", "model"))])
def test_mesh_collectives_carry_gradients(shape, axes):
    """``VirtualMesh``'s collectives and the shard cut / reassembly under
    autograd: ``torch.autograd.gradcheck`` (float64, analytic against
    finite differences) of ``psum``, ``all_to_all``, ``all_gather``,
    ``ppermute`` (its indexed write into zeros included) and
    ``local_shards`` / ``from_shards``, over each mesh's last axis."""
    from repro_torch.dist.sharding import P, from_shards, local_shards
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(shape, axes, device="cpu")
    ax, n = axes[-1], mesh.n
    k = mesh.size(ax)
    g = torch.Generator().manual_seed(0)

    def rand(*s):
        return torch.randn(s, generator=g, dtype=torch.float64,
                           requires_grad=True)

    pairs = [(i, (i + 1) % k) for i in range(k - 1)]   # rank k-1 gets 0s
    for fn, t in ((lambda t: mesh.psum(t, ax), rand(n, 3)),
                  (lambda t: mesh.all_to_all(t, ax), rand(n, k, 2)),
                  (lambda t: mesh.all_gather(t, axis=ax), rand(n, 2, 3)),
                  (lambda t: mesh.ppermute(t, pairs, ax), rand(n, 3)),
                  (lambda t: from_shards(local_shards(t, P(ax), mesh) * 2,
                                         P(ax), mesh), rand(4 * k, 3))):
        assert torch.autograd.gradcheck(fn, (t,))
