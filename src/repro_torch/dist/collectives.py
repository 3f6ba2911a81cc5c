"""Cross-rank reductions beyond the stock ``psum`` (port of
``repro/dist/collectives.py``), over a
:class:`~repro_torch.dist.mesh.VirtualMesh` on the stacked ``(n, ...)``
layout.

``compressed_psum`` trades exactness for wire bytes: each rank quantizes
its contribution to int8 with per-group scales before the reduction (the
bandwidth-bound regime; ~1% relative error on unit-scale activations).

``hierarchical_psum`` decomposes a global reduction into an intra-pod psum
followed by a cross-pod psum, optionally compressing only the cross-pod
hop. The decomposition is exact when ``compress_dcn=False``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _quantize_i8(x, group_size):
    """Per-group int8 quantization along the last dim. Returns dequantized
    values (the wire carries q + one f32 scale per group)."""
    shape = x.shape
    d = shape[-1]
    g = max(1, min(group_size, d))
    pad = (-d) % g
    xg = F.pad(x, (0, pad)).reshape(*shape[:-1], -1, g)
    scale = xg.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xg / scale), -127, 127)
    return (q * scale).reshape(*shape[:-1], d + pad)[..., :d]


def compressed_psum(x, mesh, axes, group_size=8):
    """int8-compressed all-reduce of ``x`` (n, ...) over ``axes`` of
    ``mesh``."""
    return mesh.psum(_quantize_i8(x, group_size), axes)


def hierarchical_psum(x, mesh, *, pod_axis="pod", inner_axes=("data",),
                      compress_dcn=False, group_size=8):
    """Intra-pod psum then cross-pod psum; optionally int8-compress the
    cross-pod hop only."""
    inner = mesh.psum(x, inner_axes)
    if compress_dcn:
        inner = _quantize_i8(inner, group_size)
    return mesh.psum(inner, pod_axis)
