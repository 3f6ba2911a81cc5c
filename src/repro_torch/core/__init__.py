"""Search machinery of the port: design space, schedules, verifier,
cost model, cascade, fast path and slow path, and the fault loop's model
(fault plans, their l3 pricing, modeled Perfetto timelines)."""
from repro_torch.core.faults import (FaultPlan, FaultSpec, fault_cost,
                                     inject_wire_fault, survival_report)
from repro_torch.core.slow_path import (SearchResult, SlowPathConfig,
                                        slow_path, transfer_seeds)
from repro_torch.core.trace import (ScheduleProbe, Timeline, TraceWriter,
                                    schedule_timeline, validate_trace)

__all__ = ["SlowPathConfig", "SearchResult", "slow_path", "transfer_seeds",
           "ScheduleProbe", "Timeline", "TraceWriter", "schedule_timeline",
           "validate_trace",
           "FaultPlan", "FaultSpec", "fault_cost", "inject_wire_fault",
           "survival_report"]
