"""Mesh construction (port of ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module builds no
mesh. The single-pod production mesh is 16 x 16 = 256 ranks of
``("data", "model")``; the multi-pod mesh adds a leading ``"pod"`` axis
(2 pods = 512 ranks). Each returns a
:class:`~repro_torch.dist.mesh.VirtualMesh` of the reference's shape and
axes. Its ranks are virtual, all on one device, so the reference's error
for a machine with fewer devices than the mesh has ranks has no
counterpart here: any shape builds.
"""
from __future__ import annotations

from repro_torch.dist.mesh import VirtualMesh


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return VirtualMesh(shape, axes=axes, device=device)


def make_mesh(shape, axes, device="cuda"):
    """Generic helper for tests and examples (small meshes)."""
    return VirtualMesh(tuple(shape), axes=tuple(axes), device=device)
