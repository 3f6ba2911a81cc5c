"""FLOPs and bytes of one call of the MoE layer (dispatch, routed SwiGLU
expert FFN, combine; with ``fs`` the shared expert's SwiGLU FFN over every
row too), from its shapes alone.

Only the matrix products count: a SwiGLU FFN of width f is 2 d 2f + 2 f d
= 6 d f operations a row; the activation, the int8 wire's rounding and
the combine's adds are left out, as are padding rows and recomputation.
Bytes: each input read once and the output written once, in float32 (the
expert weights of every expert that gets a row; the int8 wire is internal
to the layer and the dispatch and combine are not HBM traffic the layer
needs).
"""


def flops(n, T, d, f, fs=0):
    """n ranks of T routed rows each, every row to one expert of width f,
    and (fs > 0) every row through the shared expert of width fs."""
    return 6 * n * T * d * (f + fs)


def nbytes(n, T, d, f, fs=0, experts=None):
    experts = n if experts is None else experts
    weights = experts * 3 * d * f + 3 * d * fs
    return 4 * (2 * n * T * d + weights)
