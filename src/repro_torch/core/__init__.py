"""Search machinery of the port: design space, schedules, verifier,
cost model, cascade, fast path and slow path."""
from repro_torch.core.slow_path import (SearchResult, SlowPathConfig,
                                        slow_path, transfer_seeds)

__all__ = ["SlowPathConfig", "SearchResult", "slow_path", "transfer_seeds"]
