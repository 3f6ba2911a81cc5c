"""95th percentile of all steps' times: each step's CUDA end event less
the previous step's (linear interpolation between order statistics)."""
import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.window.step_ms), 95))
