"""The MoE layer kind: DeepSeek-V3's expert-parallel MoE layer through the
port's ``MoEDispatch`` / ``ServingStep`` builds.

Set-up makes the expert weights (and the shared expert's, where the
mix's ``shared_expert`` says the layer has one) and one input batch per
pool entry on the card from the seed, in a few large calls, then builds
the port's layer once per entry (its routing skew is a parameter of the
build):
``get_workload(entry, ...).build(directive, VirtualMesh(n))``. A step is
one call of that ``run`` on the entry's batch. The n ranks are partitions
of one card, as the port runs them.

A row of a rank's batch is one routed (token, expert) pair: the rows the
rank's dispatch sends, each to one of the n experts held here. The gate
weights and the sum of a token's experts happen outside the layer, in the
program and the reference alike.

Whether the layer has the shared expert is the mix's data, never the
program's: the reference adds it from the mix. A program whose entry
does not run the shared expert as the mix says (its ``second_stream``)
is refused before any step, since the cell would then not measure the
layer it names.
"""
from __future__ import annotations

import functools

import torch

from bench.counts import moe as counts
from bench.lib.traffic import SEED_MASK, directive
from bench.reference import common
from bench.reference import moe as ref


class Layer:
    kernel = "moe_kernel"

    def __init__(self, config, mix, entries, seed, device):
        from repro_torch.workloads import WORKLOADS
        self.device = torch.device(device)
        self.dtype = config["torch_dtype"]
        self.n = n = int(config["n_routed_experts"])
        self.d = d = int(config["hidden_size"])
        self.f = f = int(config["moe_intermediate_size"])
        self.fs = f * int(config["n_shared_experts"]) \
            if mix["shared_expert"] else 0
        self.entry = WORKLOADS[mix["entry"]]
        if bool(self.entry.second_stream) != bool(self.fs):
            raise ValueError(
                f"mix {mix['entry']!r}: shared_expert is "
                f"{mix['shared_expert']}, but the program's entry runs "
                f"{'a' if self.entry.second_stream else 'no'} shared-expert "
                "stream")
        self.wire_i8 = bool(mix["directive"].get("tunables", {})
                            .get("wire_i8", 0))
        self.entries = entries
        Ts = {int(e["tokens_per_rank"]) for e in entries}
        if len(Ts) != 1:
            raise ValueError(f"one batch shape a pool, got {sorted(Ts)}")
        self.T = T = Ts.pop()
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed) & SEED_MASK)
        kw = dict(generator=g, device=self.device, dtype=torch.float32)
        self.w1 = torch.randn((n, d, 2 * f), **kw).mul_(d ** -0.5)
        self.w2 = torch.randn((n, f, d), **kw).mul_(f ** -0.5)
        self.shared = None
        if self.fs:
            fs = self.fs
            self.shared = (torch.randn((d, 2 * fs), **kw).mul_(d ** -0.5),
                           torch.randn((fs, d), **kw).mul_(fs ** -0.5))
        self.x = torch.randn((len(entries), n, T, d), **kw)
        self.steps = self._program(mix)

    def _program(self, mix):
        from repro_torch.dist.mesh import VirtualMesh
        point = directive(mix)
        mesh = VirtualMesh(self.n, device=self.device)
        steps = []
        for j, e in enumerate(self.entries):
            kw = dict(n_dev=self.n, tokens_per_rank=self.T, d=self.d,
                      f=self.f, skew=float(e["skew"]))
            if self.fs:
                kw["f_shared"] = self.fs
            run = self.entry(**kw).build(point, mesh)
            steps.append(functools.partial(
                run, self.x[j], self.w1, self.w2, *(self.shared or ())))
        return steps

    def counts(self, j):
        return ref.skew_counts(self.n, self.T, float(self.entries[j]["skew"]))

    def tokens(self, j):
        return self.n * self.T

    def flops(self, j):
        return counts.flops(self.n, self.T, self.d, self.f, self.fs)

    def nbytes(self, j):
        used = sum(1 for c in self.counts(j) if c)
        return counts.nbytes(self.n, self.T, self.d, self.f, self.fs, used)

    def _blocks(self, j, mode):
        return ref.blocks(self.x[j], self.w1, self.w2, self.counts(j),
                          wire_i8=self.wire_i8, shared=self.shared, mode=mode)

    def check(self, j, out):
        """The numbers ``correct`` compares for the program's output
        ``out`` of entry j, against the reference in float32."""
        worst = 0.0
        for off, c, want in self._blocks(j, "float32"):
            worst = max(worst, common.row_rel_err(out[:, off:off + c], want))
        return {"row_rel_err": worst}
