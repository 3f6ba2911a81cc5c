"""Atomic, elastic checkpointing (port of ``repro/train/checkpoint.py``, in
its file format, so a checkpoint of either package restores into the
other).

* Atomic: write to ``step_NNNNNNNN.npz.tmp`` then ``os.replace`` +
  manifest update — a preempted writer never corrupts the latest
  checkpoint.
* Elastic: tensors are saved whole, keyed by their ``/``-joined dict path
  (``params/blocks/s0/attn/q``, ``opt/m/...``, ``opt/step``); bfloat16,
  which npz cannot hold, as its bits in ``uint16``. A ``VirtualMesh``
  holds whole tensors, so restoring under another mesh, or none, is
  placing each leaf on the device and dtype of ``state_like``'s.
* The data pipeline is index-addressable, so the manifest's step counter is
  the only data-state needed for an exact resume.
"""
from __future__ import annotations

import json
import os
import pathlib

import numpy as np
import torch


def _flatten(tree, prefix=""):
    """{path: leaf} in the order of the nested dicts."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _unflatten(like, flat, prefix=""):
    if isinstance(like, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}/")
                for k, v in like.items()}
    return flat[prefix[:-1]]


def _to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:                      # npz has no bf16
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save_checkpoint(ckpt_dir, step, state, *, keep=3):
    """Write ``state`` (nested dicts of tensors) as ``step_NNNNNNNN.npz``
    under ``ckpt_dir``, publish it in ``manifest.json`` and keep the newest
    ``keep`` checkpoints. Returns the file's path."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in _flatten(state).items()}
    tmp = ckpt_dir / f"step_{step:08d}.npz.tmp"
    final = ckpt_dir / f"step_{step:08d}.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, final)                      # atomic publish
    manifest = ckpt_dir / "manifest.json"
    mtmp = ckpt_dir / "manifest.json.tmp"
    mtmp.write_text(json.dumps({"latest_step": step,
                                "file": final.name}))
    os.replace(mtmp, manifest)
    # retention
    ckpts = sorted(ckpt_dir.glob("step_*.npz"))
    for old in ckpts[:-keep]:
        old.unlink()
    return final


def latest_step(ckpt_dir):
    manifest = pathlib.Path(ckpt_dir) / "manifest.json"
    if not manifest.exists():
        return None
    return json.loads(manifest.read_text())["latest_step"]


def restore_checkpoint(ckpt_dir, state_like, *, step=None):
    """Restore the checkpoint at ``step`` (the manifest's latest by
    default) into the structure of ``state_like``, each leaf on the device
    and in the dtype of ``state_like``'s. Returns ``(state, step)``, or
    ``(None, None)`` where there is no checkpoint. A leaf whose shape is
    not ``state_like``'s raises ``ValueError``."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        return None, None
    flat = {}
    with np.load(ckpt_dir / f"step_{step:08d}.npz") as data:
        for key, like in _flatten(state_like).items():
            arr = data[key]
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"checkpoint leaf {key}: shape "
                                 f"{arr.shape}, want {tuple(like.shape)}")
            if like.dtype == torch.bfloat16 and arr.dtype == np.uint16:
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            flat[key] = t.to(device=like.device, dtype=like.dtype)
    return _unflatten(state_like, flat), step
