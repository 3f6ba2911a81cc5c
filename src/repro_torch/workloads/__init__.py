from repro_torch.workloads.base import Workload, WORKLOADS, get_workload
from repro_torch.workloads import (gemm_allgather, kv_transfer,  # noqa: F401
                                   moe_dispatch, ring_attention, scmoe,
                                   serving)  # (registration)

__all__ = ["Workload", "WORKLOADS", "get_workload"]
