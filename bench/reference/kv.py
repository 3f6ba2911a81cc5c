"""Plain PyTorch reference of the KV handoff: the decode rank's K = x Wk
and V = x Wv over the prefill rank's prompt rows x. float32, TF32 off."""
from __future__ import annotations

from bench.reference.common import mm, precision


def handoff(x, wk, wv, mode="float32"):
    """x (T, d), wk and wv (d, dk) -> (K, V), each (T, dk)."""
    with precision(x.device, mode):
        return mm(x, wk, mode), mm(x, wv, mode)
