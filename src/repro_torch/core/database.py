"""Candidate database with code embeddings, kNN retrieval, novelty
filtering (paper Appendix E/J), and a persistent warm-start store.

Port copy of ``repro/core/database.py``; the store's schema and version
are the reference's, so a store written by either package loads in the
other.

The paper embeds candidate CUDA source with a neural code encoder; here the
"code" is what l1 built and loaded (``Candidate.code_text``) or, without
it, the rendered directive, and the embedding is a feature-hashed bag of
token bigrams — deterministic, dependency-free, and good enough for
structural similarity.

Novelty is indexed: every added record's :func:`~repro_torch.core.
design_space.directive_key` lands in a set, so
:meth:`CandidateDB.is_novel` is O(1) per proposal instead of the former
O(n) linear scan (quadratic over a whole search). The key is the canonical
``as_dict`` identity — exactly the equality the old scan tested (two
directives whose rendered configuration matches are "seen"), so
accept/reject decisions are unchanged on any proposal stream the bounded
mutators emit.

Persistence (docs/search.md): :meth:`CandidateDB.save` /
:meth:`CandidateDB.load` serialize the full record stream (directives,
scores, levels, embeddings) as versioned JSON stamped with the workload +
hardware fingerprints, so a later ``slow_path(..., warm_start=path)`` can
seed generation zero from the store's elites and skip re-evaluating any
cached directive. A corrupted or version-mismatched store raises
:class:`StoreError`; the warm-start loader degrades that to a clean cold
start.
"""
from __future__ import annotations

import hashlib
import json
import re

import numpy as np

from repro_torch.core.cascade import Candidate, EvalResult
from repro_torch.core.design_space import directive_from_dict, directive_key

_TOKEN_RE = re.compile(r"[a-zA-Z][\w\-.]*")
DIM = 128

DB_SCHEMA = "cuco-candidate-db"
DB_VERSION = 1


class StoreError(ValueError):
    """A persisted search store failed to load (corrupt JSON, wrong schema,
    or a version this code does not read). Warm-start treats this as a
    clean cold start; direct callers of ``load`` see the reason."""


def embed_code(text: str, dim: int = DIM) -> np.ndarray:
    toks = _TOKEN_RE.findall(text)[:20000]
    v = np.zeros(dim, np.float32)
    for i in range(len(toks) - 1):
        g = toks[i] + " " + toks[i + 1]
        h = int(hashlib.blake2s(g.encode(), digest_size=8).hexdigest(), 16)
        v[h % dim] += 1.0 if (h >> 63) else -1.0
    n = np.linalg.norm(v)
    return v / n if n else v


# --------------------------------------------------- candidate (de)serialize


def candidate_to_dict(cand) -> dict:
    """The persisted form of one evaluated candidate: the directive's
    canonical dict, its lineage, and the run-deterministic result fields
    (level/score/modeled ms — never wall timings). ``code_text`` stays out:
    it is rebuildable from the directive."""
    res = cand.result
    out = {
        "directive": cand.directive.as_dict(),
        "gen": int(cand.gen), "island": int(cand.island),
        "parent_id": int(cand.parent_id), "mutation": str(cand.mutation),
        "cid": int(cand.cid),
        "result": None,
    }
    if res is not None:
        t = res.t_model_ms
        out["result"] = {
            "level": int(res.level), "score": float(res.score),
            "t_model_ms": float(t) if np.isfinite(t) else None,
            "diagnostic": str(res.diagnostic),
            "quarantined": bool(res.quarantined),
            "retries": int(res.retries),
        }
    return out


def candidate_from_dict(obj: dict):
    """Inverse of :func:`candidate_to_dict`."""
    cand = Candidate(directive=directive_from_dict(obj["directive"]),
                     gen=int(obj["gen"]), island=int(obj["island"]),
                     parent_id=int(obj["parent_id"]),
                     mutation=str(obj["mutation"]), cid=int(obj["cid"]))
    r = obj.get("result")
    if r is not None:
        t = r.get("t_model_ms")
        cand.result = EvalResult(
            level=int(r["level"]), score=float(r["score"]),
            t_model_ms=float("inf") if t is None else float(t),
            diagnostic=str(r.get("diagnostic", "")),
            quarantined=bool(r.get("quarantined", False)),
            retries=int(r.get("retries", 0)))
    return cand


def load_store(path, schema: str, version: int) -> dict:
    """Read + validate one versioned JSON store; raises StoreError on any
    corruption or schema/version mismatch (shared by db and archive)."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError) as e:
        raise StoreError(f"unreadable store {path}: {e}") from e
    if not isinstance(payload, dict) or payload.get("schema") != schema:
        raise StoreError(f"{path}: not a {schema} store "
                         f"(schema={payload.get('schema')!r})"
                         if isinstance(payload, dict)
                         else f"{path}: not a JSON object")
    if payload.get("version") != version:
        raise StoreError(f"{path}: {schema} version "
                         f"{payload.get('version')!r} != {version}")
    return payload


class CandidateDB:
    def __init__(self, novelty_threshold: float = 0.995):
        self.records = []              # Candidate list (cid == index)
        self.embeddings = []
        self.novelty_threshold = novelty_threshold
        self._seen = set()             # directive_key of every record

    def add(self, cand):
        cand.cid = len(self.records)
        self.records.append(cand)
        self.embeddings.append(embed_code(cand.code_text or
                                          cand.directive.render()))
        self._seen.add(directive_key(cand.directive))
        return cand.cid

    def knn(self, cand, k=3):
        """Structurally similar prior candidates + their feedback."""
        if not self.records:
            return []
        q = embed_code(cand.code_text or cand.directive.render())
        sims = np.array([float(q @ e) for e in self.embeddings])
        order = np.argsort(-sims)
        out = []
        for i in order[:k + 1]:
            r = self.records[i]
            if r.cid == cand.cid:
                continue
            out.append((float(sims[i]), r))
        return out[:k]

    def is_novel(self, directive, code_text=""):
        """Novelty filter: reject configurations already seen. O(1) — the
        canonical ``directive_key`` of every added record is indexed in a
        set, replacing the former per-proposal linear scan (which also
        subsumes the old embedding branch: structural near-duplicates were
        only ever rejected when their ``as_dict`` matched a seen record's,
        and that is exactly key membership)."""
        return directive_key(directive) not in self._seen

    @property
    def best(self):
        done = [r for r in self.records if r.result and r.result.ok]
        return max(done, key=lambda r: r.score) if done else None

    def history(self):
        return [(r.cid, r.gen, r.island, r.mutation, r.score,
                 r.directive.behavior) for r in self.records]

    # ------------------------------------------------------------ persistence
    def save(self, path, *, workload="", hardware=""):
        """Write the versioned warm-start store: every record's directive +
        deterministic result fields + embedding, stamped with the workload
        and hardware fingerprints the scores were modeled under."""
        payload = {
            "schema": DB_SCHEMA, "version": DB_VERSION,
            "workload": str(workload), "hardware": str(hardware),
            "novelty_threshold": float(self.novelty_threshold),
            "records": [candidate_to_dict(c) for c in self.records],
            "embeddings": [[round(float(x), 7) for x in e]
                           for e in self.embeddings],
        }
        with open(path, "w") as f:
            json.dump(payload, f, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path) -> "CandidateDB":
        """Rebuild a db from :meth:`save` output; the store's fingerprints
        land on ``db.saved_meta``. Raises :class:`StoreError` on corruption
        or version mismatch."""
        payload = load_store(path, DB_SCHEMA, DB_VERSION)
        try:
            db = cls(novelty_threshold=payload.get("novelty_threshold",
                                                   0.995))
            cands = [candidate_from_dict(o) for o in payload["records"]]
            embs = payload.get("embeddings", [])
        except (KeyError, TypeError, ValueError) as e:
            raise StoreError(f"{path}: malformed candidate record: {e}") \
                from e
        for i, cand in enumerate(cands):
            db.records.append(cand)
            if i < len(embs):
                db.embeddings.append(np.asarray(embs[i], np.float32))
            else:
                db.embeddings.append(embed_code(cand.directive.render()))
            db._seen.add(directive_key(cand.directive))
        db.saved_meta = {"workload": payload.get("workload", ""),
                         "hardware": payload.get("hardware", "")}
        return db
