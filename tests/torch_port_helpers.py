"""Helpers the port's tests share (``tests/test_torch_*.py``): seeded numpy
inputs in the JAX workload's layout, handed to both packages, and the
max-abs-normalised error every tolerance there is stated in. Imports only
numpy, so the card-only tests can use it where there is no JAX."""
import numpy as np


def rel_err(got, want):
    """max |got - want| / max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def numpy_inputs(n, T, d, f, fs=0, seed=0):
    """x (n, T, d), w1 (n, d, 2f), w2 (n, f, d) and, with ``fs``, the
    shared expert's s1 (d, 2fs), s2 (fs, d): float32, from ``seed``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((n, T, d)),
            rng.standard_normal((n, d, 2 * f)) / np.sqrt(d),
            rng.standard_normal((n, f, d)) / np.sqrt(f)]
    if fs:
        arrs += [rng.standard_normal((d, 2 * fs)) / np.sqrt(d),
                 rng.standard_normal((fs, d)) / np.sqrt(fs)]
    return [a.astype(np.float32) for a in arrs]
