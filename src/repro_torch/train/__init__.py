"""Training (port of ``repro.train``): the loop, checkpoints, and the
fault tolerance around them — the straggler watchdog, the elastic
controller and the preemption guard."""
from repro_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.fault_tolerance import (ElasticController,
                                               PreemptionGuard,
                                               StragglerWatchdog)
from repro_torch.train.loop import (TrainConfig, build_state, loss_and_grads,
                                    train)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "TrainConfig", "train", "build_state", "loss_and_grads",
           "ElasticController", "PreemptionGuard",
           "StragglerWatchdog"]
