"""Plain PyTorch reference of the expert-parallel MoE layer: the routed
rows of each rank through their expert's SwiGLU FFN (after the int8 wire's
quantization where the mix has one), plus the shared expert's SwiGLU FFN
over every row where the mix runs it. float32, TF32 off.

Routing is the skew law of CUCo's MoE workload (paper §4.3): expert e's
share of a rank's T rows is proportional to skew^-e, floored, with the
remainder on expert 0, and every rank's rows sorted into contiguous
per-expert blocks. :func:`skew_counts` is a frozen copy of that law, so
the reference works the routing out again and takes none from the program.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.reference.common import mm, precision


def skew_counts(n, T, skew):
    """Rows of a rank routed to each of the n experts."""
    w = np.array([skew ** (-e) for e in range(n)])
    w = w / w.sum()
    counts = np.floor(w * T).astype(int)
    counts[0] += T - counts.sum()
    return [int(c) for c in counts]


def quant_i8(x):
    """The int8 wire: per-row scale max|x| / 127 + 1e-12, rows rounded
    half to even and clipped to [-127, 127], then scaled back. Both
    divisions are IEEE divisions by a tensor (PyTorch divides a CUDA
    tensor by a Python number as a product with its reciprocal, which can
    move the scale by an ulp and a rounding across its half)."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    s = amax / amax.new_tensor(127.0) + 1e-12
    return torch.clamp(torch.round(x / s), -127, 127) * s


def swiglu(x, w1, w2, mode):
    """GEMM1 (gate | up, 2f) -> silu(gate) * up -> GEMM2."""
    h = mm(x, w1, mode)
    g, u = h.chunk(2, dim=-1)
    return mm(g * torch.sigmoid(g) * u, w2, mode)


def blocks(x, w1, w2, counts, *, wire_i8=False, shared=None,
           mode="float32"):
    """The layer's output one expert block at a time: yields ``(off, c,
    y)``, y (n, c, d) the output rows ``[off, off + c)`` of every rank.
    x (n, T, d); w1 (n, d, 2f), w2 (n, f, d) expert e's on rank e;
    ``shared``: (s1 (d, 2fs), s2 (fs, d))."""
    n, _, d = x.shape
    off = 0
    for e, c in enumerate(counts):
        if c:
            rows = x[:, off:off + c].reshape(-1, d)
            with precision(x.device, mode):
                wire = quant_i8(rows) if wire_i8 else rows
                y = swiglu(wire, w1[e], w2[e], mode)
                if shared is not None:
                    y = y + swiglu(rows, *shared, mode)
            yield off, c, y.reshape(n, c, d)
        off += c
