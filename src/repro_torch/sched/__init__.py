"""Online fleet scheduling — dynamic multi-tenant placement (DESIGN.md §3).

Public surface (layered, DESIGN.md §14):
  events     — Event / EventQueue discrete-event core + stale_event
  scheduler  — the FleetScheduler facade, FleetStats
  config     — SchedulerConfig + per-subsystem frozen configs (§15)
  clock      — WorkClock work ledger + re-clocking engine, SchedJob
  admission  — AdmissionController (FIFO + windowed joint batches, §13)
  remap      — RemapEngine budgeted remap passes, RemapDecision
  autoscale  — AutoscaleEngine serving closed loop, AutoscaleDecision (§15)
  recovery   — RecoveryEngine fault/drain handling (§12)
  cells      — CellFabric placement domains; flat or nested "pod/rack"
               shards + the cells=1 aliasing contract (§13)
  loads      — projected per-level / per-NIC load views
  traces     — named arrival scenarios (paper tables + serving fleet)
               and the seeded fault injector (§12)

The scheduler's state and decisions live on the host (numpy); every
re-simulation goes through ``core.simulator.SimHandle`` on the device
``FleetScheduler(..., device=)`` names — ``None`` means the CUDA card and
the hand-written Lindley-scan kernel, ``"cpu"`` the host.
"""
from .admission import AdmissionController
from .autoscale import AutoscaleDecision, AutoscaleEngine
from .cells import (GLOBAL_CELL, CellFabric, FleetCell, build_cells,
                    derive_cell_nodes)
from .clock import SchedJob, WorkClock
from .config import (AdmissionConfig, AutoscaleConfig, CellConfig,
                     RecoveryConfig, RemapConfig, SchedulerConfig)
from .events import (ADMIT, ARRIVAL, DEPARTURE, DRAIN, NODE_FAIL,
                     NODE_RECOVER, REMAP, TRAFFIC, Event, EventQueue,
                     stale_event)
from .loads import projected_level_loads, projected_nic_loads
from .recovery import RecoveryEngine
from .remap import RemapDecision, RemapEngine
from .scheduler import (FleetScheduler, FleetStats,
                        SchedulerInvariantError, resolve_strategy)
from .traces import (TRACES, NodeEvent, ServeTraceSpec, TraceSpec,
                     fault_trace, get_trace, reference_fault_trace,
                     trace_names)

__all__ = [
    "ADMIT", "ARRIVAL", "DEPARTURE", "REMAP", "NODE_FAIL", "NODE_RECOVER",
    "DRAIN", "TRAFFIC", "Event", "EventQueue", "stale_event",
    "GLOBAL_CELL", "CellFabric", "FleetCell", "build_cells",
    "derive_cell_nodes",
    "FleetScheduler", "FleetStats", "SchedulerInvariantError",
    "resolve_strategy",
    "SchedulerConfig", "RemapConfig", "AdmissionConfig", "RecoveryConfig",
    "CellConfig", "AutoscaleConfig",
    "WorkClock", "SchedJob", "AdmissionController", "RemapEngine",
    "RemapDecision", "RecoveryEngine", "AutoscaleEngine",
    "AutoscaleDecision",
    "projected_level_loads", "projected_nic_loads",
    "TRACES", "TraceSpec", "ServeTraceSpec", "get_trace", "trace_names",
    "NodeEvent", "fault_trace", "reference_fault_trace",
]
