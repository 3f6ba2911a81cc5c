"""Training-side fault tolerance of the port: the straggler watchdog, the
elastic controller and the preemption guard. The checkpoint, loop and
optimizer modules of the reference's ``repro.train`` are not ported yet."""
from repro_torch.train.fault_tolerance import (ElasticController,
                                               PreemptionGuard,
                                               StragglerWatchdog)

__all__ = ["ElasticController", "PreemptionGuard", "StragglerWatchdog"]
