"""Blockwise flash attention as a hand-written Hopper kernel
(``repro_torch/csrc/flash_attention.cu``).

Port of ``repro/kernels/flash_attention.py``: single-device attention with
an online softmax over key blocks, the scores, running max, sum and
accumulator in f32, optionally causal, the result in q's dtype. q/k/v are
``(BH, S, hd)`` (k and v ``(BH, Skv, hd)``). The reference's
``q_block`` / ``kv_block`` shape its grid; they keep its checks
(``S % q_block == 0``, ``Skv % kv_block == 0``) here, and the plain
version walks ``kv_block`` key blocks as its grid did. The kernel tiles
64 x 64 whatever they are.

CUDA tensors launch the kernel or raise (f32 or bf16, hd <= 128); CPU
tensors compute :func:`flash_attention_plain`, the plain version the tests
and ``chip_smoke.py`` hold the kernel against. ``LAUNCHES`` counts
launches keyed by variant and shape; ``VARIANTS`` names the knob sets the
main path launches.
"""
from __future__ import annotations

import collections
import ctypes
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30               # the reference's masked score
MAX_HD = 128                  # the kernel's largest head dimension

# (variant, BH, S, Skv, hd) -> kernel launches; read by chip_smoke.py
LAUNCHES = collections.Counter()

# Knobs of each variant the main path launches (``chip_smoke.py`` phase
# ``ring_main``: single-device attention over the ring's whole sequence).
VARIANTS = {
    "causal": dict(causal=True, dtype=torch.float32),
    "causal_bf16": dict(causal=True, dtype=torch.bfloat16),
    "full": dict(causal=False, dtype=torch.float32),
}


def reset_launches():
    LAUNCHES.clear()


def launches():
    """Kernel launches so far, all variants."""
    return sum(LAUNCHES.values())


def variant_name(*, causal=True, dtype=torch.float32):
    return ("causal" if causal else "full") \
        + ("_bf16" if dtype == torch.bfloat16 else "")


def _shape(q, k, v, q_block, kv_block):
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"flash_attention wants q (BH, S, hd), k and v "
                         f"(BH, Skv, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    BH, S, hd = q.shape
    Skv = k.shape[1]
    if S % q_block or Skv % kv_block:
        raise ValueError(f"S={S} and Skv={Skv} must be multiples of "
                         f"q_block={q_block} and kv_block={kv_block}")
    return BH, S, Skv, hd


# ------------------------------------------------------------ plain version


def flash_attention_plain(q, k, v, *, causal=True, q_block=128,
                          kv_block=128):
    """Plain-torch version on (BH, S, hd): the online softmax over
    ``kv_block`` key blocks in f32 (masked scores -1e30, every query row
    at once), the result acc / max(l, 1e-30) in q's dtype."""
    BH, S, Skv, hd = _shape(q, k, v, q_block, kv_block)
    scale = 1.0 / math.sqrt(hd)
    qf = q.to(torch.float32)
    acc = torch.zeros((BH, S, hd), dtype=torch.float32, device=q.device)
    m = torch.full((BH, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((BH, S), dtype=torch.float32, device=q.device)
    qpos = torch.arange(S, device=q.device)[:, None]
    for k0 in range(0, Skv, kv_block):
        kb = k[:, k0:k0 + kv_block].to(torch.float32)
        vb = v[:, k0:k0 + kv_block].to(torch.float32)
        s = torch.einsum("bqd,bkd->bqk", qf, kb) * scale
        if causal:
            kpos = k0 + torch.arange(kb.shape[1], device=q.device)[None, :]
            s = torch.where(qpos >= kpos, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=2))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=2)
        acc = acc * alpha[..., None] + torch.einsum("bqk,bkd->bqd", p, vb)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


# ------------------------------------------------------------ the kernel


class _Params(ctypes.Structure):
    """``FlashParams`` of ``csrc/flash_attention.cu``, field for field."""
    _fields_ = (
        [(k, ctypes.c_int) for k in ("BH", "S", "Skv", "hd", "causal",
                                     "bf16", "vec")]
        + [("scale", ctypes.c_float)]
        + [(k, ctypes.c_void_p) for k in ("q", "k", "v", "out")])


def load_kernel():
    """Build (if needed) and load the kernel without running it."""
    return build.load_typed("flash_attention", _Params)


def _launch(q, k, v, *, causal, q_block, kv_block):
    BH, S, Skv, hd = _shape(q, k, v, q_block, kv_block)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention's kernel takes float32 or "
                         f"bfloat16, got {q.dtype}")
    for t in (k, v):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"k and v must match q ({q.dtype} on "
                             f"{q.device}); got {t.dtype} on {t.device}")
    if hd > MAX_HD:
        raise ValueError(f"flash_attention's kernel takes hd <= {MAX_HD}, "
                         f"got {hd}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)
    # cp.async copies 16 bytes: rows of a 16-byte multiple, aligned bases
    vec = hd * q.element_size() % 16 == 0 \
        and all(t.data_ptr() % 16 == 0 for t in (q, k, v, out))
    p = _Params(BH=BH, S=S, Skv=Skv, hd=hd, causal=int(causal),
                bf16=int(q.dtype == torch.bfloat16), vec=int(vec),
                scale=1.0 / math.sqrt(hd), q=q.data_ptr(), k=k.data_ptr(),
                v=v.data_ptr(), out=out.data_ptr())
    build.launch(load_kernel(), p, q.device)
    LAUNCHES[(variant_name(causal=causal, dtype=q.dtype), BH, S, Skv,
              hd)] += 1
    return out


def flash_attention(q, k, v, *, causal=True, q_block=128, kv_block=128):
    """q/k/v: (BH, S, hd) -> (BH, S, hd) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, q_block=q_block,
                                     kv_block=kv_block)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch(q, k, v, causal=causal, q_block=q_block,
                   kv_block=kv_block)
