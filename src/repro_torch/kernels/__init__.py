"""Hand-written Hopper kernels (sources in ``repro_torch/csrc/``) with
their plain-torch versions."""
