"""The optimizer (port of ``repro.optim``)."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_update, global_norm,
                                     init_opt_state, lr_at, opt_state_specs)

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update", "opt_state_specs",
           "lr_at", "global_norm"]
