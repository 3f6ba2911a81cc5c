"""What the plain references share: their matrix product at a stated
precision, and the number ``correct`` compares.

``precision`` "float32" is float32 with TF32 off; "tf32" is the control,
TF32 products (on the card through cuBLAS's TF32 mode, on the CPU by
rounding both operands to TF32's 10-bit mantissa, as the tensor cores
read them, and accumulating in float32).
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision(device, mode):
    """The card's TF32 switches set for ``mode`` over the block, and put
    back after it."""
    if mode not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {mode!r}")
    if torch.device(device).type != "cuda":
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    torch.backends.cudnn.allow_tf32 = mode == "tf32"
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def tf32_round(t):
    """float32 rounded to nearest (ties away) at TF32's 10 mantissa
    bits."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(a, b, mode):
    """``a @ b`` at ``mode`` (inside :func:`precision` on the card)."""
    if mode == "tf32" and a.device.type != "cuda":
        a, b = tf32_round(a), tf32_round(b)
    return a @ b


def row_rel_err(got, want):
    """The worst row's relative error: max over rows of
    ||got_r - want_r|| / ||want_r|| (rows are the last axis)."""
    got = got.reshape(-1, got.shape[-1]).to(torch.float32)
    want = want.reshape(-1, want.shape[-1]).to(torch.float32)
    num = torch.linalg.vector_norm(got - want, dim=-1)
    den = torch.linalg.vector_norm(want, dim=-1).clamp_min(1e-30)
    err = (num / den).max()
    return float(err) if torch.isfinite(err) else float("inf")
