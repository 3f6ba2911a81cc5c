"""What the port's acceptance suites share: the device they run on, where an
artifact goes, the ``bench-rows/v1`` table writer (a copy of
``benchmarks/common.py::write_rows``, which imports the JAX package), the
comparison of a regenerated artifact with a checked-in one, and the
command line every suite module takes.
"""
from __future__ import annotations

import argparse
import builtins
import contextlib
import functools
import json
import operator
from pathlib import Path

import torch

from repro_torch.compat import REPO_ROOT
from repro_torch.core.hardware import H100, V5E

# where a suite writes its artifact unless given ``out`` (gitignored)
SUITES_DIR = REPO_ROOT / "build" / "suites"
CHIPS = {"h100": H100, "v5e": V5E}


class SuiteFailure(AssertionError):
    """A check of an acceptance suite failed."""


def require(ok, what):
    """Raise :class:`SuiteFailure` with ``what`` unless ``ok``."""
    if not ok:
        raise SuiteFailure(what() if callable(what) else what)


def resolve_device(device):
    """``device`` as a ``torch.device``; a CUDA device must exist (a suite
    asked for the card never runs on the CPU instead)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the suite was asked for cuda and there is no "
                           "CUDA device (pass device='cpu' for the CPU)")
    return dev


def artifact_path(out, name):
    """``out``, or ``build/suites/<name>`` of the checkout; its directory
    is made."""
    path = Path(out) if out is not None else SUITES_DIR / name
    path.parent.mkdir(parents=True, exist_ok=True)
    return path


def write_json(path, payload):
    """``payload`` as the reference's artifacts are written: sorted keys,
    an indent of 2 and a trailing newline."""
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return payload


def write_rows(path, rows):
    """Persist ``(name, us_per_call, derived)`` rows as a ``bench-rows/v1``
    JSON table (sorted keys, trailing newline — the same diff-stable
    conventions as BENCH_search.json)."""
    payload = {
        "schema": "bench-rows/v1",
        "rows": [{"name": str(n), "us_per_call": float(us),
                  "derived": str(d)} for n, us, d in rows],
    }
    return write_json(path, payload)


def read_json(path):
    with open(path) as f:
        return json.load(f)


def diff(got, want, path=""):
    """The JSON paths at which two parsed artifacts differ, in order
    (``[]`` exactly when ``got == want``)."""
    if isinstance(got, dict) and isinstance(want, dict):
        out = []
        for k in sorted(set(got) | set(want), key=str):
            if k not in got or k not in want:
                out.append(f"{path}.{k}")
            else:
                out += diff(got[k], want[k], f"{path}.{k}")
        return out
    if isinstance(got, list) and isinstance(want, list):
        if len(got) != len(want):
            return [f"{path}[len {len(got)} != {len(want)}]"]
        out = []
        for i, (g, w) in enumerate(zip(got, want)):
            out += diff(g, w, f"{path}[{i}]")
        return out
    return [] if got == want else [path or "."]


@contextlib.contextmanager
def left_fold_sum():
    """Python's ``sum`` as it was before 3.12: a plain left fold.

    From 3.12 ``sum`` adds floats with compensation (Neumaier), which
    moves the last bit of some sums. The cost model's
    ``CostBreakdown.total`` and the telemetry's mean scores are such sums,
    and the reference's checked-in artifacts were written under the left
    fold, so a regeneration that is to equal them bit for bit runs inside
    this context."""
    plain = builtins.sum

    def fold(iterable, /, start=0):
        return functools.reduce(operator.add, iterable, start)

    builtins.sum = fold
    try:
        yield
    finally:
        builtins.sum = plain


def allclose(name, got, want, tol):
    """Hold tensors (or tuples of them) elementwise: ``|got - want| <=
    tol + tol |want|``, as ``np.testing.assert_allclose(atol=tol,
    rtol=tol)`` does; returns the max-abs error."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    require(len(got) == len(want),
            f"{name}: {len(got)} outputs, want {len(want)}")
    worst = 0.0
    for g, w in zip(got, want):
        require(tuple(g.shape) == tuple(w.shape),
                f"{name}: shape {tuple(g.shape)}, want {tuple(w.shape)}")
        g, w = g.float(), w.float()
        err = (g - w).abs()
        ok = bool(torch.isfinite(g).all()) and bool(
            (err <= tol + tol * w.abs()).all())
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
        require(ok, f"{name}: max abs err {worst:.3e} over tol {tol:g}")
    return worst


def main(run, argv=None, doc=""):
    """The command line of a suite module: ``--device`` (cuda unless
    cpu), ``--chip`` (h100 or v5e), ``--out``, ``--small``; prints the
    summary ``run`` returns as JSON."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0] if doc
                                 else None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chip", default="h100", choices=sorted(CHIPS))
    ap.add_argument("--out", default=None,
                    help="the artifact's path (default: build/suites/)")
    ap.add_argument("--small", action="store_true",
                    help="fewer timed repetitions (the shapes stay)")
    args = ap.parse_args(argv)
    summary = run(args.device, small=args.small, chip=CHIPS[args.chip],
                  out=args.out)
    print(json.dumps(summary, sort_keys=True, default=str))
    return 0
