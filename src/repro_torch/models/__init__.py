"""The attention architectures in plain torch (port of ``repro.models``)."""
from repro_torch.models.model import (StepOptions, decode_step, forward,
                                      init_cache, init_params,
                                      params_from_numpy, prefill_step)

__all__ = [
    "StepOptions", "init_params", "params_from_numpy", "prefill_step",
    "decode_step", "init_cache", "forward",
]
