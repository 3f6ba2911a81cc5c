"""FLOPs and bytes of one cache handoff: a request's K and V of ``layers``
layers, T positions and ``heads`` x ``head_dim`` elements of ``esize``
bytes each, moved from the prefill to the decode rank. No operations.
Bytes: the cache read once and written once (the positions, ``kpos``, are
handed over as they are and move no byte)."""


def flops(layers, T, heads, head_dim):
    del layers, T, heads, head_dim
    return 0


def nbytes(layers, T, heads, head_dim, esize):
    cache = 2 * layers * T * heads * head_dim * esize
    return 2 * cache
