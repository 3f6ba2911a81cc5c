"""What the benchmark's tests put in the program's place underneath a
whole run: the port's kernel entry with a fault planted in its output,
or the control, the plain reference computed in the precision below the
configuration's, where the kernel would run. The workloads and the engine
import their kernel entry when they build or call, so :func:`plant`
patches it before the run's set-up.

Each layer kind keeps its test hooks in a file of its own,
``bench/tests/kinds/<layer>.py``, found here by the configuration's
``layer``:

- ``CONFIG``: the configuration keys a tiny copy sets (its widths);
- ``PARAMS``: the mix parameters a tiny copy sets (its sizes);
- ``FAULTS``: the faults a cell of the kind can have, and optionally
  ``faults(mix)``, those a cell of ``mix`` can have;
- ``plant(monkeypatch, what)``: a fault or "control" in the place of the
  kind's kernel entry.
"""
import hashlib
from pathlib import Path

from bench.lib import spec as speclib

ROOT = Path(__file__).resolve().parents[2]


def hooks(layer, root=ROOT):
    """The test hooks of layer kind ``layer`` in the checkout (or copy) at
    ``root``."""
    if not layer.isidentifier():
        raise speclib.SpecError(f"layer name {layer!r} is not a module name")
    path = Path(root) / "bench" / "tests" / "kinds" / f"{layer}.py"
    if not path.is_file():
        raise speclib.SpecError(
            f"layer kind {layer!r} has no test hooks: add "
            f"bench/tests/kinds/{layer}.py (CONFIG, PARAMS, FAULTS, plant)")
    tag = hashlib.sha1(str(path).encode()).hexdigest()[:8]
    return speclib.load_module(path, f"bench_kind_{layer}_{tag}")


def faults(layer, mix, root=ROOT):
    """The faults a cell of kind ``layer`` under ``mix`` can have."""
    kind = hooks(layer, root)
    return kind.faults(mix) if hasattr(kind, "faults") else kind.FAULTS


def plant(monkeypatch, layer, what, root=ROOT):
    """Put ``what`` (a fault of the kind's, or "control") in the place of
    layer kind ``layer``'s kernel entry."""
    hooks(layer, root).plant(monkeypatch, what)
