"""Aggregate run statistics for the fleet scheduler (DESIGN.md §11).

Kept out of the facade so result consumers (benchmarks, tests,
examples) can import the record type without the scheduler stack.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class FleetStats:
    """Aggregate outcome of one scheduler run.

    Two kinds of numbers live here (DESIGN.md §11): **per-job end state**
    (``makespan`` / ``total_queue_wait`` / ``total_msg_wait`` /
    ``migrated_bytes`` / ``per_job`` — one record per job, complete by
    construction) and **per-mutation samples** (``nic_p99_util`` /
    ``peak_sim_util`` / ``level_p99_util`` — statistics over the
    utilisation samples taken once per fleet mutation).
    ``sample_counts`` carries the record count behind every sampled
    statistic so downstream consumers can tell a 3-sample p99 from a
    3000-sample one; ``sampling_policy`` names the weighting contract
    (one sample per admit/depart/remap-commit, never per event tick).
    """

    n_jobs: int
    makespan: float                  # last departure (s, sim clock)
    total_queue_wait: float          # sum over jobs of (placed_at - arrival)
    total_msg_wait: float            # sum of simulated per-job message waits
    nic_p99_util: float              # p99 of per-node NIC utilisation samples
    peak_sim_util: float             # max simulator server utilisation seen
    n_remap_commits: int
    n_remap_rejects: int
    migrated_bytes: float
    per_job: dict[int, dict]
    level_p99_util: dict = dataclasses.field(default_factory=dict)
    # ^ p99 per hierarchy level of per-link utilisation samples (§9)
    sample_counts: dict = dataclasses.field(default_factory=dict)
    # ^ records behind each sampled statistic, e.g. {"peak_sim_util": 31,
    #   "nic_util": 29, "level.rack": 29} — 0 samples -> the statistic is 0
    sampling_policy: str = "per-mutation"
    # -- failure / recovery outcomes (DESIGN.md §12) -----------------------
    goodput: float = 1.0             # useful_core_s / alloc_core_s; 1.0
    #   when no work was accrued (reclock=False or an empty run)
    useful_core_s: float = 0.0       # productive core-seconds (work that
    #   survived to the end — checkpoint rollbacks subtract their losses)
    alloc_core_s: float = 0.0        # core-seconds jobs held cores
    lost_work_s: float = 0.0         # job-seconds discarded by rollbacks
    mttr_mean: float = 0.0           # mean kill -> re-placement latency
    n_node_failures: int = 0
    n_node_recoveries: int = 0
    n_restarts: int = 0              # requeue-restart kills
    n_shrinks: int = 0               # elastic-shrink survivals
    n_drains: int = 0                # drain windows begun
    n_evacuations: int = 0           # jobs migrated off draining nodes
    n_drain_kills: int = 0           # jobs hard-killed at drain deadlines
    # -- joint admission / cells (DESIGN.md §13) ---------------------------
    hol_blocked_core_s: float = 0.0  # free core-seconds wasted while the
    #   FIFO head did not fit but a later queued job would have (HOL
    #   blocking actually costing capacity)
    n_joint_batches: int = 0         # window/backlog batches placed jointly
    n_joint_admitted: int = 0        # jobs admitted through joint batches
    n_spanning_jobs: int = 0         # placements that crossed cell borders
    n_cell_escalations: int = 0      # re-clocks escalated up a level
    n_cross_cell_migrations: int = 0  # whole-job moves between cells
    # -- serving closed loop (DESIGN.md §15) -------------------------------
    slo_violation_s: float = 0.0     # total p99-SLO-violation seconds
    slo_violation_by_model: dict = dataclasses.field(default_factory=dict)
    n_scale_ups: int = 0             # committed add-replica actions
    n_scale_downs: int = 0           # committed drop-replica actions
    n_autoscale_rejects: int = 0     # structural actions priced out
    n_routing_shifts: int = 0        # routing-weight refreshes that moved

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        return d
