"""Deterministic, index-addressable synthetic token pipeline (a copy of
``repro/data/pipeline.py``: numpy only, so the batches are the reference's
bit for bit; the training loop moves them to the device).

Stateless-by-construction: batch(i) is a pure function of (seed, i), so a
restarted job resumes mid-epoch exactly by storing only the step counter in
the checkpoint — no iterator state, no data-loss window (the fault-tolerance
story depends on this). Supports host-sharded loading (each host materializes
only its batch shard) and background prefetch.

The synthetic stream is a mixture of Zipfian unigrams and a deterministic
"copy task" structure so the loss actually decreases during the e2e examples.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    copy_period: int = 16          # structure: token repeats every period
    frames: int = 0                # enc-dec stub frames
    patches: int = 0               # vlm stub patch tokens
    d_model: int = 0


class SyntheticTokenPipeline:
    def __init__(self, cfg: DataConfig, *, host_index=0, num_hosts=1,
                 prefetch=2):
        assert cfg.global_batch % num_hosts == 0
        self.cfg = cfg
        self.host_index = host_index
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts
        self._q = None
        self._prefetch = prefetch
        # zipf-ish unigram distribution over the vocab
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._p = p / p.sum()

    # ------------------------------------------------------------ batches
    def batch(self, step: int):
        """Global batch for `step`, restricted to this host's rows."""
        cfg = self.cfg
        rows = []
        lo = self.host_index * self.local_batch
        for r in range(lo, lo + self.local_batch):
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, r]))
            base = rng.choice(cfg.vocab_size, size=cfg.seq_len, p=self._p)
            # learnable structure: the stream is periodic with copy_period
            # (token t == token t - copy_period for all t >= copy_period)
            idx = np.arange(cfg.seq_len)
            base = base[idx % cfg.copy_period]
            rows.append(base)
        tokens = np.stack(rows).astype(np.int32)
        labels = np.concatenate([tokens[:, 1:],
                                 np.full((len(rows), 1), -1, np.int32)], 1)
        out = {"tokens": tokens, "labels": labels}
        if cfg.frames:
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, 10**6]))
            out["frames"] = rng.standard_normal(
                (self.local_batch, cfg.frames, cfg.d_model),
                dtype=np.float32).astype(np.float32)
        if cfg.patches:
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, 2 * 10**6]))
            out["patches"] = rng.standard_normal(
                (self.local_batch, cfg.patches, cfg.d_model),
                dtype=np.float32)
            out["labels"][:, :cfg.patches] = -1
        return out

    # ----------------------------------------------------------- prefetch
    def start_prefetch(self, first_step: int):
        self._q = queue.Queue(maxsize=self._prefetch)
        self._stop = False

        def worker():
            s = first_step
            while not self._stop:
                try:
                    self._q.put((s, self.batch(s)), timeout=0.5)
                    s += 1
                except queue.Full:
                    continue

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def next_prefetched(self):
        s, b = self._q.get()
        return s, b

    def stop(self):
        self._stop = True
