"""Build and load the port's CUDA kernels (route (b): ``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes``).

Each source under ``repro_torch/csrc/`` compiles on first use into
``build/repro_torch/lib<name>-<hash>.so``; the hash is of the source text,
so an edited source never loads a stale library. :func:`build` compiles
several sources at once, one ``nvcc`` each, all started together. Nothing
here runs at import time, and nothing falls back: a failed build raises
with the compiler's output.
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


def _library(name):
    """The source of ``name`` and the library path its content hash names."""
    src = compat.CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return src, compat.build_dir() / f"lib{name}-{digest}.so"


def build(names):
    """Compile every source of ``names`` whose library is missing: one
    ``nvcc`` per source, all started together, each waited for. Raises
    with the compiler's output of every build that failed."""
    with _LOCK:
        todo = [(name, *_library(name)) for name in dict.fromkeys(names)
                if name not in _LOADED]
        todo = [(name, src, lib) for name, src, lib in todo
                if not lib.exists()]
        if not todo:
            return
        nvcc = compat.nvcc_path()
        if nvcc is None:
            raise KernelBuildError(f"no nvcc to build {todo[0][1]}")
        compat.build_dir().mkdir(parents=True, exist_ok=True)
        running = []
        for name, src, lib in todo:
            tmp = lib.with_suffix(".so.tmp")
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                                     str(src)], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            running.append((name, proc, tmp, lib))
        failed = []
        for name, proc, tmp, lib in running:
            log, _ = proc.communicate()
            _LOGS[name] = [ln for ln in log.splitlines() if "ptxas info" in ln]
            if proc.returncode:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            else:
                tmp.replace(lib)
        if failed:
            raise KernelBuildError("\n".join(failed))


def load(name):
    """The loaded library of ``csrc/<name>.cu``, compiling it first if its
    library is missing (once per process)."""
    with _LOCK:
        if name in _LOADED:
            return _LOADED[name]
    build([name])
    with _LOCK:
        if name not in _LOADED:
            _LOADED[name] = ctypes.CDLL(str(_library(name)[1]))
        return _LOADED[name]


def ptxas_log(name):
    """``ptxas info`` lines (registers, shared memory, spills) of the build
    this process ran for ``name``; empty when the library was cached."""
    return list(_LOGS.get(name, ()))
