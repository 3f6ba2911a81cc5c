"""PyTorch/CUDA port of the CUCo reproduction for an NVIDIA H100.

Mirrors ``repro``'s layout and names; imports ``torch``, never ``jax`` and
nothing of ``repro``. Entry points run on ``device="cuda"`` unless the
caller passes ``device="cpu"``.
"""
