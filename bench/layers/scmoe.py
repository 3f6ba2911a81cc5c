"""The ScMoE layer kind: LongCat-Flash's shortcut-connected MoE
double-layers through the port's ``ScMoEStep`` build.

Set-up makes each double-layer's weights (the router, its zero bias, the
held expert tensors, both dense FFNs, the norms at one) and one input h
(n ranks x T tokens x d, normal) per pool entry on the card from the
seed, in a few large calls, and builds the port's layer once:
``get_workload(entry, ...).build(directive, VirtualMesh(n))``, n the
configuration's ``experts_held``. A step is the configuration's
``num_layers`` calls of that ``run`` in turn, one ``moe_kernel`` launch
each (:meth:`Layer.launches`), and returns the last layer's output with
the picks each layer made (the program's ``record_routes`` sink).

The check computes the layers again in the plain reference with the
program's picks, and reads two numbers: ``route_gap``, how far a pick
lies below the reference's own k-th score (0 where it is among the top
k), and ``row_rel_err`` of the output.

FLOPs and bytes are the algorithm's (``counts/scmoe.py``): the FFN rows
are those of the reference's own routing of each pool entry, never the
program's.
"""
from __future__ import annotations

import functools
import math

import torch

from bench.counts import scmoe as counts
from bench.lib.traffic import SEED_MASK, directive
from bench.reference import common
from bench.reference import scmoe as ref


class Layer:
    kernel = "moe_kernel"

    def __init__(self, config, mix, entries, seed, device):
        from repro_torch.workloads import WORKLOADS
        self.entry = WORKLOADS[mix["entry"]]
        self.device = torch.device(device)
        self.dtype = config["torch_dtype"]
        self.n = n = int(config["experts_held"])
        self.d = d = int(config["hidden_size"])
        self.f = f = int(config["expert_ffn_hidden_size"])
        self.fd = fd = int(config["ffn_hidden_size"])
        self.E = int(config["n_routed_experts"])
        self.Z = int(config["zero_expert_num"])
        self.depth = int(config["num_layers"])
        self.cfg = dict(n_experts=self.E, topk=int(config["moe_topk"]),
                        scale=float(config["routed_scaling_factor"]),
                        eps=float(config["rms_norm_eps"]))
        Ts = {int(e["tokens_per_rank"]) for e in entries}
        if len(Ts) != 1:
            raise ValueError(f"one batch shape a pool, got {sorted(Ts)}")
        self.T = Ts.pop()
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed) & SEED_MASK)
        kw = dict(generator=g, device=self.device, dtype=torch.float32)

        def normal(*shape):
            return torch.randn(shape, **kw).mul_(1 / math.sqrt(shape[-2]))

        self.layers = []
        for _ in range(self.depth):
            self.layers.append(dict(
                wr=normal(d, self.E + self.Z),
                b=torch.zeros(self.E + self.Z, device=self.device),
                w1=normal(n, d, 2 * f), w2=normal(n, f, d),
                s1=normal(d, 2 * fd), s2=normal(fd, d),
                t1=normal(d, 2 * fd), t2=normal(fd, d),
                g0=torch.ones(d, device=self.device),
                g1=torch.ones(d, device=self.device)))
        self.h = torch.randn((len(entries), n, self.T, d), **kw)
        self._rows = {}
        run = self.entry(n_dev=n, tokens_per_rank=self.T, d=d, f=f,
                         f_dense=fd, n_zero=self.Z, **self.cfg).build(
                             directive(mix), self._mesh(n))
        self.steps = [functools.partial(self._step, run, self.h[j])
                      for j in range(len(entries))]

    def _mesh(self, n):
        from repro_torch.dist.mesh import VirtualMesh
        return VirtualMesh(n, device=self.device)

    def _step(self, run, h):
        from repro_torch.workloads.scmoe import record_routes
        with record_routes() as picks:
            for lay in self.layers:
                h = run(h, *(lay[k] for k in ref.LAYER_KEYS))
        return h, picks

    def launches(self, j):
        return self.depth

    def tokens(self, j):
        return self.n * self.T

    def rows(self, j):
        """FFN rows of each layer under the reference's own routing of
        pool entry j's input (worked out once an entry)."""
        if j not in self._rows:
            _, picks, _ = ref.forward(self.h[j], self.layers, **self.cfg)
            self._rows[j] = tuple(ref.ffn_rows(p, self.E) for p in picks)
        return self._rows[j]

    def flops(self, j):
        return counts.flops(self.rows(j), self.n * self.T, self.d, self.f,
                            self.fd, self.E + self.Z)

    def nbytes(self, j):
        return counts.nbytes(self.rows(j), self.n * self.T, self.d, self.f,
                             self.fd, self.E + self.Z, self.n)

    def kernel_flops(self, j):
        return counts.kernel_flops(self.rows(j), self.n * self.T, self.d,
                                   self.f, self.fd)

    def kernel_nbytes(self, j):
        return counts.kernel_nbytes(self.rows(j), self.n * self.T, self.d,
                                    self.f, self.fd, self.n)

    def check(self, j, out):
        """The numbers ``correct`` compares for the program's output
        ``out`` (the last layer's output and each layer's picks) of entry
        j, against the reference in float32 with the program's picks."""
        got, picks = out
        want, _, gap = ref.forward(self.h[j], self.layers, picks,
                                   mode="float32", **self.cfg)
        return {"route_gap": gap, "row_rel_err": common.row_rel_err(got,
                                                                    want)}
