"""Helpers the port's tests share (``tests/test_torch_*.py``): seeded numpy
inputs in the JAX workload's layout, handed to both packages, and the
max-abs-normalised error every tolerance there is stated in. Imports only
numpy, so the card-only tests can use it where there is no JAX."""
import numpy as np


def rel_err(got, want):
    """max |got - want| / max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def first_repeat(tree):
    """A stacked ``(R, ...)`` parameter tree's first repeat: one layer's
    weights, with the tree's nesting."""
    return {k: first_repeat(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


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


def run_jax_devices(code, arrays, tmp_dir, devices=4, timeout=420):
    """Run ``code`` in a fresh Python with ``devices`` JAX host devices
    (the device count is fixed when JAX starts, so it cannot change inside
    a test process). The script gets the path of an ``.npz`` of ``arrays``
    as ``sys.argv[1]`` and writes its results as an ``.npz`` to
    ``sys.argv[2]``; returns them as a dict of numpy arrays. The time
    limit leaves room for a machine loaded by other test workers, where
    such a script has taken more than twice its time alone."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    inp, out = os.path.join(tmp_dir, "in.npz"), os.path.join(tmp_dir,
                                                             "out.npz")
    np.savez(inp, **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code, inp, out], env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as got:
        return dict(got)
