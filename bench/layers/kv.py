"""The KV-handoff layer kind: one layer's K / V projection on the prefill
rank and its handoff to the decode rank, through the port's
``KVTransfer`` build (``kv_shuttle.cu``).

Set-up makes Wk and Wv and one request's prompt activations per pool
entry on the card from the seed, each in the stacked layout the port
takes, (2, T, d) with the decode rank's rows zero, then builds the port's
``run`` once: ``get_workload("kv_transfer", ...).build(directive,
VirtualMesh(2))``. A step is one call of ``run`` on one request; the
prefill and decode ranks are partitions of one card.
"""
from __future__ import annotations

import functools

import torch

from bench.counts import kv as counts
from bench.lib.traffic import SEED_MASK, directive
from bench.reference import common
from bench.reference import kv as ref


class Layer:
    kernel = "kv_shuttle_kernel"

    def __init__(self, config, mix, entries, seed, device):
        self.device = torch.device(device)
        self.dtype = config["torch_dtype"]
        self.d = d = int(config["hidden_size"])
        head_dim = int(config.get("head_dim")
                       or d // int(config["num_attention_heads"]))
        self.dk = dk = int(config["num_key_value_heads"]) * head_dim
        self.entries = entries
        self.Ts = [int(e["prompt_tokens"]) for e in entries]
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed) & SEED_MASK)
        kw = dict(generator=g, device=self.device, dtype=torch.float32)
        self.wk = torch.randn((d, dk), **kw).mul_(d ** -0.5)
        self.wv = torch.randn((d, dk), **kw).mul_(d ** -0.5)
        buf = torch.zeros((2 * sum(self.Ts), d), device=self.device)
        self.x, off = [], 0
        for T in self.Ts:
            x = buf[off:off + 2 * T].view(2, T, d)
            x[0].normal_(generator=g)
            self.x.append(x)
            off += 2 * T
        self.steps = self._program(mix)

    def _program(self, mix):
        from repro_torch.dist.mesh import VirtualMesh
        from repro_torch.workloads import get_workload
        point = directive(mix)
        mesh = VirtualMesh(2, device=self.device)
        steps = []
        for x, T in zip(self.x, self.Ts):
            run = get_workload(mix["entry"], T=T, d=self.d,
                               dk=self.dk).build(point, mesh)
            steps.append(functools.partial(run, x, self.wk, self.wv))
        return steps

    def tokens(self, j):
        return self.Ts[j]

    def flops(self, j):
        return counts.flops(self.Ts[j], self.d, self.dk)

    def nbytes(self, j):
        return counts.nbytes(self.Ts[j], self.d, self.dk)

    def check(self, j, out):
        """The numbers ``correct`` compares for the program's (K, V) of
        entry j: the decode rank's rows against the reference."""
        k, v = out
        want_k, want_v = ref.handoff(self.x[j][0], self.wk, self.wv)
        return {"row_rel_err": max(common.row_rel_err(k[1], want_k),
                                   common.row_rel_err(v[1], want_v))}
