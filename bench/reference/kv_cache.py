"""Plain PyTorch reference of the cache handoff: the decode rank receives
the prefill rank's cache as it is, block by block and leaf by leaf, in the
cache's own precision. ``dtype`` is the control's: each float leaf
rounded through a lower precision (float8 e4m3 for a bfloat16 cache, as
an FP8 KV cache ships it) and back."""
from __future__ import annotations


def copy(t, dtype=None):
    """The decode rank's copy of one leaf."""
    if dtype is not None and t.is_floating_point():
        return t.to(dtype).to(t.dtype)
    return t.clone()


def handoff(cache, dtype=None):
    """``{block: {leaf: tensor}}`` -> the same blocks, each leaf copied."""
    return {name: {leaf: copy(t, dtype) for leaf, t in block.items()}
            for name, block in cache.items()}
