"""Capability probe for the port: is there a CUDA card, is it Hopper
(compute capability 9.0), where is ``nvcc``, and where do built kernels go.

Nothing falls back on what this reports: a kernel wrapper given a CUDA
tensor builds and launches its kernel or raises, and the GPU tests skip
on :func:`has_hopper`.
"""
from __future__ import annotations

import os
import shutil
from pathlib import Path

import torch

# src/repro_torch/compat.py -> the checkout root
REPO_ROOT = Path(__file__).resolve().parents[2]
CSRC = Path(__file__).resolve().parent / "csrc"


def has_cuda() -> bool:
    return torch.cuda.is_available()


def compute_capability(device=0):
    """``(major, minor)`` of the card, or ``None`` without one."""
    if not has_cuda():
        return None
    return torch.cuda.get_device_capability(device)


def has_hopper(device=0) -> bool:
    """A card of compute capability 9.0 (H100/H200), the only target the
    ``sm_90a`` kernels are built for."""
    return compute_capability(device) == (9, 0)


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``, or
    the one on ``PATH``; ``None`` when there is none."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    return shutil.which("nvcc")


def build_dir() -> Path:
    """Where kernels are built: ``build/repro_torch/`` in the checkout
    (listed in ``.gitignore``)."""
    return REPO_ROOT / "build" / "repro_torch"

