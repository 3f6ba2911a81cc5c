"""The model zoo in plain torch (port of ``repro.models``): init,
parameter and cache specs, prefill and decode, and the training loss."""
from repro_torch.models.model import (StepOptions, cache_specs, decode_step,
                                      forward, init_cache, init_params,
                                      param_shapes, param_specs,
                                      params_from_numpy,
                                      prefill_step, train_loss)

__all__ = [
    "StepOptions", "init_params", "param_shapes", "params_from_numpy",
    "param_specs",
    "train_loss", "prefill_step", "decode_step", "init_cache", "cache_specs",
    "forward",
]
