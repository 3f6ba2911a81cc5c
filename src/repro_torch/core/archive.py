"""MAP-Elites diversity archive (paper Appendix E, Mouret & Clune 2015).
Port copy of ``repro/core/archive.py`` (store schema ``cuco-map-elites``
v1, the reference's).

Grid indexed by the behavioral descriptor derived from the optimization
directive (backend, placement, completion); each cell keeps the
highest-scoring candidate with that behavioral profile. Archive samples are
injected into mutation prompts as cross-pollination inspirations.

The archive also persists (docs/search.md): :meth:`MapElitesArchive.save`
writes each cell's behavior key, elite candidate (directive + deterministic
result fields) and code embedding as versioned JSON;
:meth:`MapElitesArchive.load` rebuilds it, raising
``database.StoreError`` on corruption or a version this code does not
read. ``slow_path(..., warm_start=...)`` accepts either store kind."""
from __future__ import annotations

import json
import random

from repro_torch.core.database import (StoreError, candidate_from_dict,
                                       candidate_to_dict, embed_code,
                                       load_store)

ARCHIVE_SCHEMA = "cuco-map-elites"
ARCHIVE_VERSION = 1


class MapElitesArchive:
    def __init__(self):
        self.cells = {}

    def offer(self, cand):
        key = cand.directive.behavior
        cur = self.cells.get(key)
        if cand.result and cand.result.ok and (cur is None
                                               or cand.score > cur.score):
            self.cells[key] = cand
            return True
        return False

    def sample(self, rng: random.Random, k=2, exclude_behavior=None):
        pool = [c for b, c in self.cells.items() if b != exclude_behavior]
        rng.shuffle(pool)
        return pool[:k]

    def elites(self):
        return sorted(self.cells.values(), key=lambda c: -c.score)

    def coverage(self):
        return len(self.cells)

    # ------------------------------------------------------------ persistence
    def save(self, path, *, workload="", hardware=""):
        """Versioned JSON of every cell: behavior key, elite candidate, and
        its code embedding, stamped with the fingerprints the elites were
        scored under (cells sorted by behavior for a deterministic file)."""
        cells = []
        for behavior in sorted(self.cells):
            cand = self.cells[behavior]
            emb = embed_code(cand.code_text or cand.directive.render())
            cells.append({"behavior": list(behavior),
                          "candidate": candidate_to_dict(cand),
                          "embedding": [round(float(x), 7) for x in emb]})
        payload = {"schema": ARCHIVE_SCHEMA, "version": ARCHIVE_VERSION,
                   "workload": str(workload), "hardware": str(hardware),
                   "cells": cells}
        with open(path, "w") as f:
            json.dump(payload, f, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path) -> "MapElitesArchive":
        """Rebuild an archive from :meth:`save` output; fingerprints land on
        ``archive.saved_meta``. Raises ``database.StoreError`` on corruption
        or version mismatch."""
        payload = load_store(path, ARCHIVE_SCHEMA, ARCHIVE_VERSION)
        arch = cls()
        try:
            for cell in payload["cells"]:
                cand = candidate_from_dict(cell["candidate"])
                behavior = tuple(cell["behavior"])
                if behavior != cand.directive.behavior:
                    raise StoreError(
                        f"{path}: cell behavior {behavior} does not match "
                        f"its elite's directive {cand.directive.behavior}")
                arch.cells[behavior] = cand
        except StoreError:
            raise
        except (KeyError, TypeError, ValueError) as e:
            raise StoreError(f"{path}: malformed archive cell: {e}") from e
        arch.saved_meta = {"workload": payload.get("workload", ""),
                           "hardware": payload.get("hardware", "")}
        return arch
