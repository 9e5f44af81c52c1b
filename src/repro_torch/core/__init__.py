"""Paper core: contention-aware process/shard mapping.

Public surface:
  graphs     — AppGraph / ClusterTopology / Placement
  hierarchy  — NetLevel / NetworkHierarchy multi-level fabric (§9)
  mapping    — blocked / cyclic / drb / new_mapping (paper Fig. 1) /
               recursive_bisect (hierarchy-aware, §9)
  simulator  — queueing model of message waiting times (paper sec. 5);
               loop / segmented / torch / kernel backends + simulate_batch
  sim_scan   — segmented max-plus scan backends (DESIGN.md §8)
  workloads  — paper Tables 2–9 + the rack_oversub mix (§9)
  commgraph  — AppGraph derivation for sharded model jobs (collective traffic)
  meshplan   — fleet mesh planning: tpu_topology, the fleet-adapted
               new_tpu strategy (+ search:new_tpu), place_jobs
  (commgraph and meshplan read ``repro_torch.configs``; import them by
  module, this package's namespace stays free of configs)
  convert    — build these objects from plain arrays and field dicts
"""
from .graphs import (AppGraph, ClusterFull, ClusterTopology, FlatMessages,
                     FreeCoreTracker, Placement, tie_phase)
from .hierarchy import NetLevel, NetworkHierarchy, default_hierarchy
from .mapping import (STRATEGIES, blocked, cyclic, drb, new_mapping,
                      recursive_bisect)
from .simulator import (BACKENDS, SimHandle, SimResult, resolve_backend,
                        resolve_device, simulate, simulate_batch)

__all__ = [
    "AppGraph", "ClusterFull", "ClusterTopology", "FlatMessages", "FreeCoreTracker",
    "Placement", "tie_phase",
    "NetLevel", "NetworkHierarchy", "default_hierarchy",
    "STRATEGIES", "blocked", "cyclic", "drb", "new_mapping",
    "recursive_bisect",
    "BACKENDS", "SimHandle", "SimResult", "resolve_backend", "resolve_device",
    "simulate", "simulate_batch",
]
