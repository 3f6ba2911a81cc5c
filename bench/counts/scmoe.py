"""FLOPs and bytes of one step of the ScMoE layer kind: N tokens through
one double-layer a list entry, ``rows[i]`` of them FFN picks in layer i
(the reference's own routing of the step's input), from the shapes alone.

Only the matrix products count: a SwiGLU FFN of width f is 2 d 2f + 2 f d
= 6 d f operations a row; the router is 2 d (E + Z) a token. The step
runs the router, the routed rows through their experts (width f) and
both dense FFNs (width fd) over every token. Bytes: each input read once
and each output written once, float32.

The kernel's part (``moe_dispatch.cu``, one launch a layer) is the routed
rows and FFN1, its second stream: the held expert tensors and FFN1's
weights read once, the routed rows and FFN1's tokens in and out once.
"""


def flops(rows, N, d, f, fd, experts):
    """The whole step: ``experts`` = E + Z router outputs."""
    return sum(6 * r * d * f + 2 * 6 * N * d * fd + 2 * N * d * experts
               for r in rows)


def nbytes(rows, N, d, f, fd, experts, held):
    """h in and out once, and each layer's weights: the held expert
    tensors, both dense FFNs, the router and its bias, the two norms."""
    layer = held * 3 * d * f + 2 * 3 * d * fd + (d + 1) * experts + 2 * d
    return 4 * (2 * N * d + len(rows) * layer)


def kernel_flops(rows, N, d, f, fd):
    return sum(6 * r * d * f + 6 * N * d * fd for r in rows)


def kernel_nbytes(rows, N, d, f, fd, held):
    return 4 * sum(held * 3 * d * f + 3 * d * fd + 2 * r * d + 2 * N * d
                   for r in rows)
