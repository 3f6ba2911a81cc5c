"""The import guard: the benchmark measures the PyTorch port, so the JAX
package it was ported from, JAX itself and its libraries must not be
loaded in the process that prints a result. Modules are compared by
their top-level name (the part before the first dot), whole: the port's
``repro_torch`` is not ``repro``."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_loaded(modules=None):
    """Top-level names of the loaded modules that are forbidden, sorted."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & FORBIDDEN)
