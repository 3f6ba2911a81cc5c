"""Serving: the engine and its continuous-batching scheduler."""
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["ServeConfig", "Engine", "Request", "Scheduler"]
