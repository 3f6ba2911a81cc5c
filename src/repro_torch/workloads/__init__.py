from repro_torch.workloads.base import Workload, WORKLOADS, get_workload
from repro_torch.workloads import (kv_transfer, moe_dispatch,  # noqa: F401
                                   serving)  # (registration)

__all__ = ["Workload", "WORKLOADS", "get_workload"]
