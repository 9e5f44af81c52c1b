"""The work ledger and re-clocking engine (DESIGN.md §3).

Owns the scheduler's notion of *time-under-contention*: every live job
progresses at rate ``1/sim_finish`` (its full duration under the
contention of the last re-clock), departures are re-derived as
``now + (1 - work_done) * sim_finish`` after EVERY fleet mutation, and
superseded departure events die lazily in the heap via per-job epochs.

The :class:`WorkClock` holds only the goodput ledger (productive vs
allocated core-seconds, §12); everything else it reads and mutates
lives on the fleet facade passed at construction (``self.f``) — a
duck-typed context exposing ``live`` / ``now`` / ``events`` /
``placement`` / ``_sim`` / ``_last_res`` / ``_sample_mutation`` /
``_live_graphs`` / ``fabric``. Layering: this module may import only
``repro_torch.core`` / ``repro_torch.obs`` / ``repro_torch.search`` / ``repro_torch.ckpt`` and
the sched event/cell primitives — never its sibling subsystems
(admission / remap / recovery).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np

from ..core.graphs import AppGraph
from .cells import GLOBAL_CELL, FleetCell
from .events import DEPARTURE, Event


@dataclasses.dataclass
class SchedJob:
    """One job's lifecycle inside the scheduler."""

    job_id: int
    graph: AppGraph
    arrival: float
    state_bytes_per_proc: float
    placed_at: Optional[float] = None
    cores: Optional[np.ndarray] = None
    departure: Optional[float] = None
    msg_wait: float = 0.0            # simulated message wait (s); under the
    #   re-clocking engine this is the work-weighted integral of the job's
    #   projected wait over its lifetime, under reclock=False the stale
    #   admission-time sample
    n_migrations: int = 0
    migrated_bytes: float = 0.0
    # -- elapsed-work clock state (DESIGN.md §3) ---------------------------
    epoch: int = 0                   # departure re-key generation; the
    #   job's departure event is only honoured when its epoch matches
    work_done: float = 0.0           # completed work fraction; may go
    #   negative transiently when a migration adds payload-transfer debt
    sim_finish: float = 0.0          # full-job duration under the
    #   contention of the last re-clock (the work rate is 1/sim_finish)
    wait_proj: float = 0.0           # per-job wait projection at last re-clock
    last_clock: float = 0.0          # sim time work was last accrued
    # -- failure-recovery state (DESIGN.md §12) ----------------------------
    restart_debt_s: float = 0.0      # restore traffic (s over the NIC)
    #   pending from a restart/shrink; folded into work_done as debt at
    #   the job's next re-key, exactly like a migration stall
    n_restarts: int = 0              # kills survived (requeue or shrink)
    lost_work_s: float = 0.0         # work discarded by checkpoint rollbacks
    # -- serving-replica state (DESIGN.md §15) -----------------------------
    resident: bool = False           # serving replica: never departs on its
    #   own — re-clocks refresh its contention projection but push no
    #   departure event; it leaves only via an explicit depart() (the
    #   autoscale engine's drop-replica action) or the run horizon

    @property
    def queue_wait(self) -> float:
        # for restarted jobs this spans original arrival -> latest
        # placement, so it includes the pre-kill residency (§12)
        return (self.placed_at - self.arrival) if self.placed_at is not None else 0.0


class WorkClock:
    """Work accrual + departure re-keying over a fleet facade."""

    def __init__(self, fleet) -> None:
        self.f = fleet
        # goodput ledger: productive vs allocated core-seconds, accrued in
        # advance() without touching the per-job clock math (the no-fault
        # bit-identical guarantee relies on that separation)
        self.useful_core_s = 0.0
        self.alloc_core_s = 0.0

    def advance(self) -> None:
        """Accrue elapsed work on every live job up to ``f.now``.

        Between re-clocks a job progresses at rate ``1/sim_finish`` (its
        full duration under the contention of the last re-clock), so the
        fraction completed over ``dt`` is ``dt/sim_finish``; ``msg_wait``
        integrates the projected wait over the same fractions, making the
        final per-job wait a work-weighted blend of every contention
        regime the job lived through.
        """
        f = self.f
        for job in f.live.values():
            dt = f.now - job.last_clock
            if dt > 0.0 and job.sim_finish > 0.0:
                frac = min(dt / job.sim_finish,
                           max(1.0 - job.work_done, 0.0))
                before = job.work_done
                job.work_done += frac
                job.msg_wait += frac * job.wait_proj
                # goodput ledger (§12): productive seconds are the
                # POSITIVE work actually gained — paying off migration /
                # restore debt is machine time, not progress. Pure
                # side-accounting: the per-job clock math above is
                # untouched, so no-fault runs stay bit-identical.
                self.useful_core_s += (
                    (max(job.work_done, 0.0) - max(before, 0.0))
                    * job.sim_finish * job.graph.n_procs)
            if dt > 0.0:
                self.alloc_core_s += dt * job.graph.n_procs
            job.last_clock = f.now

    def reclock(self, res=None) -> None:
        """Re-key every live job's departure from a fresh simulation.

        ``departure = now + (1 - work_done) * sim_finish``. If contention
        did not change, the re-derived departure equals the job's current
        one (the elapsed-work model telescopes) and no event is pushed;
        otherwise the job's epoch is bumped and the superseded event dies
        lazily in the heap. ``res`` lets the remap commit path reuse its
        already-scored candidate instead of simulating again.
        """
        f = self.f
        if not f.live:
            return
        if res is None:
            res = f._sim.simulate(f._live_graphs(), f.placement)
        f._last_res = res
        f._sample_mutation(res)
        self.rekey(f.live.values(), res)
        if f.fabric.n_cells > 1:
            # a global re-simulate covers every cell: their cached
            # results are superseded and nothing is left dirty
            for cell in f.fabric.cells:
                cell.last_res = None
            f.fabric.dirty.clear()

    def rekey(self, jobs: Iterable[SchedJob], res) -> None:
        f = self.f
        for job in jobs:
            job.sim_finish = max(res.job_finish[job.job_id], 1e-9)
            job.wait_proj = res.per_job_wait[job.job_id]
            if job.restart_debt_s > 0.0:
                # restore traffic from a restart/shrink stalls the job
                # exactly like a migration: fold it into work_done as
                # debt at the first re-key under the new contention
                # (no-op float-compare when no fault ever touched the job)
                job.work_done -= job.restart_debt_s / job.sim_finish
                job.restart_debt_s = 0.0
            if job.resident:
                # serving replicas have no finite work to exhaust: keep
                # the contention projection fresh, push no departure
                continue
            departure = f.now \
                + max(1.0 - job.work_done, 0.0) * job.sim_finish
            if job.departure is not None and abs(departure - job.departure) \
                    <= 1e-9 * max(1.0, abs(departure)):
                continue                      # clock unchanged — keep event
            job.epoch += 1
            job.departure = departure
            f.events.push(Event(time=departure, kind=DEPARTURE,
                                job_id=job.job_id, epoch=job.epoch))

    def reclock_fleet(self) -> None:
        """Cell-aware re-clock dispatch (§13): single-cell fleets re-clock
        globally (the historical path, bit-for-bit); sharded fleets
        re-simulate only the cells dirtied since the last re-clock.
        Escalation walks UP one level at a time: a dirty rack whose pod
        holds pod-spanning jobs re-clocks at the pod, and only jobs that
        span pods (or cells, in flat mode) force one global re-simulate
        (their contention couples the domains they touch)."""
        f = self.f
        fab = f.fabric
        if fab.n_cells == 1:
            self.reclock()
            return
        dirty = fab.dirty
        fab.dirty = set()
        if not dirty:
            return
        if fab.n_spanning or GLOBAL_CELL in dirty:
            f.metrics.counter("sched.cell_escalations").inc()
            self.reclock()
            return
        for cid in fab.reclock_domains(dirty):
            self.reclock_cell(fab.cells[cid])

    def reclock_cell(self, cell: FleetCell, res=None) -> None:
        """Re-key one cell's resident jobs from the cell's warm handle.

        The cell-local simulate sees exactly the cell subtree's live set —
        jobs in other cells share no links with it (placements are node-
        disjoint and cell-contained, so their traffic never reaches links
        outside their own subtree), so the restriction is exact, not an
        approximation. For a parent (pod) cell the subtree is the pod's
        own spanning residents plus every child rack's residents."""
        f = self.f
        jobs = [f.live[jid] for jid in f.fabric.cell_jobs(cell)
                if jid in f.live]
        if not jobs:
            cell.last_res = None
            return
        if res is None:
            res = cell.sim.simulate([j.graph for j in jobs], f.placement)
        cell.last_res = res
        f._sample_mutation(res)
        self.rekey(jobs, res)
