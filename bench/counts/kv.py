"""FLOPs and bytes of one KV handoff: the prefill rank's K = x Wk and
V = x Wv over T prompt rows of width d into width dk, landed on the decode
rank. Operations: the two products, 2 T d dk each. Bytes: x and both
weights read once, K and V written once on the decode rank, float32.
"""


def flops(T, d, dk):
    return 4 * T * d * dk


def nbytes(T, d, dk):
    return 4 * (T * d + 2 * d * dk + 2 * T * dk)
