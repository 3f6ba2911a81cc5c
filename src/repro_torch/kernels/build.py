"""Build and load the port's CUDA kernels (route (b): ``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes``).

Each source under ``repro_torch/csrc/`` compiles on first use into
``build/repro_torch/lib<name>-<hash>.so``; the hash is of the source text,
of every header in ``csrc/`` (``*.cuh``, which sources share) and of the
``-D`` defines of a test build, so an edited source or header never loads a
stale library. :func:`build` compiles several sources at once, one ``nvcc``
each, all started together. Nothing here runs at import time, and nothing
falls back: a failed build raises with the compiler's output.

Every source exports the same plain C interface, which :func:`load_typed`
types once for all wrappers: ``<name>_launch(Params *, [int grid,]
cudaStream_t)``, ``<name>_error(int)``, ``<name>_params_size()`` and, for a
cooperative kernel, ``<name>_grid(int ..., int *grid, int *per_sm)``.
"""
from __future__ import annotations

import ctypes
import hashlib
import subprocess
import threading

import torch

from repro_torch import compat

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the counting build of moe_dispatch.cu and kv_shuttle.cu (csrc/cta_stats.cuh),
# which one traced launch in 17 takes (core/telemetry.py::kernel_counters)
STATS_DEFINES = ("CUCO_STATS",)

_LOCK = threading.Lock()
_LOADED = {}          # (source name, defines) -> ctypes.CDLL
_LOGS = {}            # (source name, defines) -> ptxas lines of its build
_GRIDS = {}           # (library, device index, grid args) -> (grid, per_sm)
_FAILED = {}          # library path -> compiler output of its failed build
_PRELOADED = set()    # (source name, device, grid args) preloaded


class KernelBuildError(RuntimeError):
    pass


def _library(name, defines=()):
    """The source of ``name`` and the library path its content hash names
    (the source's text, every shared header's, and the defines)."""
    src = compat.CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(compat.CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    for define in defines:
        h.update(b"-D" + define.encode() + b"\0")
    digest = h.hexdigest()[:12]
    tag = "".join(f"-{define.lower()}" for define in defines)
    return src, compat.build_dir() / f"lib{name}{tag}-{digest}.so"


def build(names, defines=()):
    """Compile every source of ``names`` whose library is missing, with
    ``-D`` each of ``defines``: one ``nvcc`` per source, all started
    together, each waited for. Raises with the compiler's output of every
    build that failed."""
    build_jobs([(name, tuple(defines)) for name in dict.fromkeys(names)])


def build_jobs(jobs, optional=()):
    """Compile the library of each ``(name, defines)`` in ``jobs`` and in
    ``optional`` that is missing, all started together. A build of
    ``optional`` that fails raises nothing here; a library that failed to
    build raises its compiler output when a later call wants it, without
    another ``nvcc``."""
    with _LOCK:
        want = [(key, True) for key in jobs]
        want += [(key, False) for key in optional if key not in jobs]
        todo = [(key, must, *_library(*key)) for key, must in want
                if key not in _LOADED]
        todo = [job for job in todo if not job[3].exists()]
        known = [_FAILED[lib] for _, must, _, lib in todo
                 if must and lib in _FAILED]
        if known:
            raise KernelBuildError("\n".join(known))
        todo = [job for job in todo if job[3] not in _FAILED]
        if not todo:
            return
        nvcc = compat.nvcc_path()
        if nvcc is None:
            raise KernelBuildError(f"no nvcc to build {todo[0][2]}")
        compat.build_dir().mkdir(parents=True, exist_ok=True)
        running = []
        for (name, defines), must, src, lib in todo:
            tmp = lib.with_suffix(".so.tmp")
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS,
                                     *(f"-D{d}" for d in defines), "-o",
                                     str(tmp), str(src)],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            running.append((name, defines, must, proc, tmp, lib))
        failed = []
        for name, defines, must, proc, tmp, lib in running:
            log, _ = proc.communicate()
            _LOGS[(name, defines)] = [ln for ln in log.splitlines()
                                      if "ptxas info" in ln
                                      or "bytes spill" in ln]
            if proc.returncode:
                _FAILED[lib] = f"{name}: nvcc exited {proc.returncode}\n{log}"
                if must:
                    failed.append(_FAILED[lib])
            else:
                tmp.replace(lib)
        if failed:
            raise KernelBuildError("\n".join(failed))


def load(name, defines=(), together=()):
    """The loaded library of ``csrc/<name>.cu`` (built with ``defines``),
    compiling it first if its library is missing (once per process), and
    with it the builds of ``name`` with each define set of ``together``
    that are missing, all started together; one of those that fails to
    build does not fail this load."""
    key = (name, tuple(defines))
    with _LOCK:
        if key in _LOADED:
            return _LOADED[key]
    build_jobs([key], [(name, tuple(d)) for d in together])
    with _LOCK:
        if key not in _LOADED:
            _LOADED[key] = ctypes.CDLL(str(_library(*key)[1]))
        return _LOADED[key]


def load_typed(name, params, grid_args=None, defines=(), together=()):
    """:func:`load` with the library's C interface typed (once):
    ``params`` is the ctypes mirror of the source's parameter struct,
    checked against ``<name>_params_size()``; a cooperative kernel takes
    ``grid_args`` ints in ``<name>_grid`` and its grid in
    ``<name>_launch``."""
    lib = load(name, defines, together)
    if getattr(lib, "_kernel", None) is None:
        fn = lambda what: getattr(lib, f"{name}_{what}")  # noqa: E731
        coop = [] if grid_args is None else [ctypes.c_int]
        fn("launch").argtypes = [ctypes.POINTER(params), *coop,
                                 ctypes.c_void_p]
        fn("error").argtypes = [ctypes.c_int]
        fn("error").restype = ctypes.c_char_p
        fn("params_size").argtypes = []
        if grid_args is not None:
            fn("grid").argtypes = [ctypes.c_int] * grid_args \
                + [ctypes.POINTER(ctypes.c_int)] * 2
        if fn("params_size")() != ctypes.sizeof(params):
            raise RuntimeError(f"{params.__name__} differs from the "
                               f"parameter struct of {name}.cu")
        lib._kernel = name
    return lib


def _check(lib, code, what):
    if code:
        error = getattr(lib, f"{lib._kernel}_error")(code).decode()
        raise RuntimeError(f"{lib._kernel} {what} failed: {error}")


def grid(lib, device, *args):
    """``(grid, per_sm)`` of a cooperative kernel on ``device``, as
    ``<name>_grid(*args)`` sizes it (CTAs per SM x SMs, rounded as its
    source says); cached per library, device and arguments."""
    key = (lib._name, torch.device(device).index, args)
    if key not in _GRIDS:
        size, per_sm = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            _check(lib, getattr(lib, f"{lib._kernel}_grid")(
                *args, ctypes.byref(size), ctypes.byref(per_sm)), "grid")
        _GRIDS[key] = (size.value, per_sm.value)
    return _GRIDS[key]


def preload(name, load, device, *args):
    """Load the library ``load()`` returns and size its grid on ``device``
    for ``args`` (:func:`grid`), once a process for ``(name, device,
    args)``, so that the first launch that takes it waits for no module
    load. Best effort: a library that fails to build or load is left to
    that launch, which raises."""
    key = (name, device, args)
    if key in _PRELOADED:
        return
    _PRELOADED.add(key)
    try:
        grid(load(), device, *args)
    except (OSError, RuntimeError):
        pass


def launch(lib, params, device, *grid_size):
    """Launch ``lib``'s kernel with ``params`` (and ``grid_size`` CTAs, a
    cooperative kernel) on ``device``'s current stream; raises on the
    error it returns."""
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        _check(lib, getattr(lib, f"{lib._kernel}_launch")(
            ctypes.byref(params), *grid_size, stream), "launch")


def ptxas_log(name, defines=()):
    """``ptxas info`` and spill lines (registers, shared memory, stack
    frame, spill stores and loads) of the build this process ran for
    ``name``; empty when the library was cached."""
    return list(_LOGS.get((name, tuple(defines)), ()))
