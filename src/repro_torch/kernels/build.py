"""Build and load the port's CUDA kernels (route (b): ``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes``).

Each source under ``repro_torch/csrc/`` compiles on first use into
``build/repro_torch/lib<name>-<hash>.so``; the hash is of the source text,
so an edited source never loads a stale library. Nothing here runs at
import time, and nothing falls back: a failed build raises with the
compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import subprocess
import threading

from repro_torch import compat

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED = {}          # source name -> ctypes.CDLL
_LOGS = {}            # source name -> ptxas resource lines of its build


class KernelBuildError(RuntimeError):
    pass


def load(name):
    """The loaded library of ``csrc/<name>.cu``, compiling it first if its
    library is missing (once per process)."""
    with _LOCK:
        if name in _LOADED:
            return _LOADED[name]
        src = compat.CSRC / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
        lib = compat.build_dir() / f"lib{name}-{digest}.so"
        if not lib.exists():
            nvcc = compat.nvcc_path()
            if nvcc is None:
                raise KernelBuildError(f"no nvcc to build {src}")
            lib.parent.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_suffix(".so.tmp")
            out = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                 capture_output=True, text=True)
            log = out.stdout + out.stderr
            _LOGS[name] = [ln for ln in log.splitlines() if "ptxas info" in ln]
            if out.returncode:
                raise KernelBuildError(
                    f"{name}: nvcc exited {out.returncode}\n{log}")
            tmp.replace(lib)
        _LOADED[name] = ctypes.CDLL(str(lib))
        return _LOADED[name]


def ptxas_log(name):
    """``ptxas info`` lines (registers, shared memory, spills) of the build
    this process ran for ``name``; empty when the library was cached."""
    return list(_LOGS.get(name, ()))
