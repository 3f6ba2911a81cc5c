"""The cache-handoff layer kind: a request's whole prefill cache handed
from the prefill to the decode rank by the serving engine's own handoff,
``Engine._shuttle_cache`` (``kv_cache_shuttle``: ``kv_shuttle.cu``'s
pure-copy path).

Set-up makes each pool entry's cache on the card from the seed, one
``torch.randn`` call an entry, in the layout and precision (the
configuration's ``torch_dtype``) that ``Engine.prefill`` returns for a
dense attention backbone such as Mistral's: one block ``s0`` that holds
every layer, ``k`` and ``v`` of (layers, 1, T, KV heads, head_dim) and
``kpos`` (layers, T), a prompt of T tokens prefilled into T slots. It
builds an engine with no weights (the handoff reads none) and checks the
2-rank mesh as ``Engine.prefill_remote`` does. A step is one call of
``Engine._shuttle_cache(cache, VirtualMesh(2))`` itself on one request's
cache, with the mix's ``shuttle`` knobs: one ``kv_cache_shuttle`` launch
for the one ``{k, v}`` block (the harness's default of one launch a
step), and the engine's ``cat``, ``stack`` and ``zeros_like`` around it.
The prefill and decode ranks are partitions of one card.
"""
from __future__ import annotations

import functools

import torch

from bench.counts import kv_cache as counts
from bench.lib.traffic import SEED_MASK, rng
from bench.reference import common
from bench.reference import kv_cache as ref


def model_config(config):
    """The port's ``ModelConfig`` of the configuration's backbone."""
    from repro_torch.configs.base import ModelConfig
    d, heads = int(config["hidden_size"]), int(config["num_attention_heads"])
    return ModelConfig(
        name=config["model_type"], family="dense",
        num_layers=int(config["num_hidden_layers"]), d_model=d,
        num_heads=heads, num_kv_heads=int(config["num_key_value_heads"]),
        d_ff=int(config["intermediate_size"]),
        vocab_size=int(config["vocab_size"]),
        head_dim=int(config.get("head_dim") or d // heads),
        rope_theta=float(config["rope_theta"]),
        dtype=config["torch_dtype"])


class Layer:
    kernel = "kv_shuttle_kernel"

    def __init__(self, config, mix, entries, seed, device):
        from repro_torch.dist.mesh import VirtualMesh
        from repro_torch.serve import Engine, ServeConfig
        self.device = torch.device(device)
        self.dtype = config["torch_dtype"]
        self.tdtype = getattr(torch, self.dtype)
        self.esize = torch.empty(0, dtype=self.tdtype).element_size()
        cfg = model_config(config)
        self.layers, self.heads, self.hd = \
            cfg.num_layers, cfg.num_kv_heads, cfg.hd
        self.Ts = [int(e["prompt_tokens"]) for e in entries]
        self.seeds = [rng(seed, f"cache{j}").getrandbits(64) & SEED_MASK
                      for j in range(len(entries))]
        caches = [self._cache(j) for j in range(len(entries))]
        # the handoff reads neither weights nor the engine's max_seq
        engine = Engine(cfg, {"embed": torch.empty(0, device=self.device)},
                        ServeConfig())
        mesh = VirtualMesh(2, device=self.device)
        engine._check_shuttle_mesh(mesh)
        knobs = mix.get("shuttle", {})
        self.steps = [functools.partial(engine._shuttle_cache, c, mesh,
                                        **knobs) for c in caches]

    def _cache(self, j):
        """Entry j's cache, made from the seed: the same tensors every time
        it is made, so the check makes it again rather than trust the
        program with its input."""
        T = self.Ts[j]
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seeds[j])
        kv = torch.randn((2, self.layers, 1, T, self.heads, self.hd),
                         generator=g, device=self.device, dtype=self.tdtype)
        kpos = torch.arange(T, dtype=torch.int32, device=self.device)
        return {"s0": {"k": kv[0], "v": kv[1],
                       "kpos": kpos.expand(self.layers, T).contiguous()}}

    def tokens(self, j):
        return self.Ts[j]

    def flops(self, j):
        return counts.flops(self.layers, self.Ts[j], self.heads, self.hd)

    def nbytes(self, j):
        return counts.nbytes(self.layers, self.Ts[j], self.heads, self.hd,
                             self.esize)

    def check(self, j, out):
        """The numbers ``correct`` compares for the cache the program handed
        to the decode rank for entry j, against the reference's handoff of
        the cache made again from the seed: every leaf of every block, bit
        for bit (a block or leaf missing, or of another shape or type,
        reads inf)."""
        want = ref.handoff(self._cache(j))
        worst = 0.0
        for name, block in want.items():
            got = out.get(name, {})
            for leaf, w in block.items():
                g = got.get(leaf)
                err = float("inf") if g is None or g.shape != w.shape \
                    or g.dtype != w.dtype else common.row_rel_err(g, w)
                worst = max(worst, err)
        return {"row_rel_err": worst}
