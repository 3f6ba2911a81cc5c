from repro_torch.workloads.base import Workload, WORKLOADS, get_workload
from repro_torch.workloads import moe_dispatch, serving  # noqa: F401  (registration)

__all__ = ["Workload", "WORKLOADS", "get_workload"]
