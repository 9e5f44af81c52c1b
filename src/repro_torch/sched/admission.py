"""Admission control — FIFO and joint batched placement (DESIGN.md §13).

Owns the arrival path: strict FIFO with head-of-line accounting by
default; with ``admission_window`` set, arrivals are collected for up to
that many sim-seconds (plus the FIFO backlog that fits, bounded
look-ahead) and placed as ONE batch — K joint placements (portfolio
seeds × per-job strategy assignments × search moves over the whole
batch, ``repro_torch.search.joint``) scored in a single warm
``simulate_batch`` against the full live set, so admission sees
cross-job contention instead of scoring each arrival in isolation.

The :class:`AdmissionController` owns the admission RNG, the window
state and the head-of-line meter; the fleet facade (``self.f``)
provides the tracker, live set, event queue and the clock/remap
delegators (``f._reclock_fleet`` / ``f._maybe_schedule_remap``).
Layering: imports only ``repro_torch.core`` / ``repro_torch.obs`` /
``repro_torch.search`` / ``repro_torch.ckpt`` and the sched event/cell primitives —
never the sibling subsystems (clock / remap / recovery).
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

from ..core.graphs import ClusterFull
from ..core.mapping import ONE_SHOT_STRATEGIES
from .cells import GLOBAL_CELL, FleetCell
from .events import ADMIT, DEPARTURE, Event


class AdmissionController:
    """FIFO + windowed joint batch placement over a fleet facade."""

    def __init__(self, fleet, *, window: float = 0.0, k: int = 24,
                 lookahead: int = 8, rng_seed: int = 0,
                 reclock: bool = True) -> None:
        self.f = fleet
        self.window = float(window)
        if self.window < 0.0:
            raise ValueError("admission_window must be >= 0")
        if self.window > 0.0 and not reclock:
            raise ValueError("admission_window requires reclock=True "
                             "(batch keying re-keys the live set)")
        self.k = max(1, k)
        self.lookahead = max(1, lookahead)
        self.rng = np.random.default_rng(rng_seed)
        self.scheduled = False          # an ADMIT window-close is in flight
        # head-of-line accounting (free core-seconds wasted while the FIFO
        # head blocked a later queued job that would have fit)
        self.hol_since: Optional[float] = None
        self.hol_free = 0

    # -- arrival path --------------------------------------------------------
    def handle_arrival(self, job) -> None:
        f = self.f
        rec = f.recorder
        if rec.enabled:
            rec.instant("arrive", track="events", job=job.job_id,
                        job_name=job.graph.name, procs=job.graph.n_procs)
        if self.window > 0.0:
            # joint batched admission (§13): hold the arrival until the
            # window closes, then place the whole batch at once.
            # Batching only pays when placements interact — on an
            # uncontended fleet with an empty queue the arrival is
            # placed immediately (holding it would cost latency and
            # buy nothing the joint score could see). A search strategy
            # never places its own bypass: below the contention
            # threshold its projected edge is noise (the same reason
            # the batch chooser trusts candidate 0 there), so the
            # bypass uses the robust one-shot mapper instead
            res = f._last_res
            if not f.pending and res is not None \
                    and res.max_server_utilisation < f.util_threshold \
                    and job.graph.n_procs <= f.tracker.total_free():
                if f.strategy_name in ONE_SHOT_STRATEGIES:
                    self.place_and_clock(job)
                    f._maybe_schedule_remap()
                    return
                if f.fabric.n_cells == 1:
                    from ..search.joint import joint_candidates
                    cands = joint_candidates(
                        [job.graph], f.cluster, f.tracker.free_mask(),
                        self.rng, 1, sizes=self.domain_sizes())
                    if cands:
                        f.admit(job.graph, now=f.now,
                                cores=cands[0][job.job_id])
                        job.last_clock = f.now
                        f._reclock_fleet()
                        f._maybe_schedule_remap()
                        return
            f.pending.append(job.job_id)
            f.metrics.gauge("sched.queue_depth").set(len(f.pending), f.now)
            if rec.enabled:
                rec.instant("queue", track="events", job=job.job_id,
                            depth=len(f.pending))
            if not self.scheduled:
                f.events.push(Event(time=f.now + self.window, kind=ADMIT))
                self.scheduled = True
            # anchor the remap cadence at ARRIVAL time, exactly where the
            # sequential path anchors it (place-on-arrival then schedule):
            # otherwise the admission hold shifts every downstream remap
            # tick by the window, and tick-vs-departure races make the
            # windowed fleet see a systematically different free pool
            f._maybe_schedule_remap()
            self.update_hol()
            return
        # strict FIFO: while anyone is queued, later arrivals queue behind
        # them (head-of-line blocking) instead of jumping ahead
        if f.pending or job.graph.n_procs > f.tracker.total_free():
            f.pending.append(job.job_id)
            f.metrics.gauge("sched.queue_depth").set(len(f.pending), f.now)
            if rec.enabled:
                rec.instant("queue", track="events", job=job.job_id,
                            depth=len(f.pending))
            self.update_hol()
            return
        self.place_and_clock(job)
        f._maybe_schedule_remap()

    def drain_pending(self) -> bool:
        """Admit queued jobs from the FIFO head while they fit; returns
        whether anything was placed. Callers holding the re-clock engine
        must re-clock afterwards — the whole drained batch is keyed by
        one simulate, per-job re-clocks at the same timestamp would only
        push events the next iteration supersedes.

        With an admission window configured, capacity events route the
        backlog through :meth:`admit_batch` instead — requeued restarts
        and freed cores re-enter the joint batched path (§13)."""
        f = self.f
        if self.window > 0.0:
            return self.admit_batch()
        placed_any = False
        while f.pending:
            head = f.jobs[f.pending[0]]
            if head.graph.n_procs > f.tracker.total_free():
                break
            f.pending.popleft()
            rec = f.recorder
            if rec.enabled:
                rec.instant("queue_drain", track="events", job=head.job_id,
                            queue_wait=f.now - head.arrival,
                            depth=len(f.pending))
            if f.reclock:
                f.admit(head.graph, now=f.now)
                head.last_clock = f.now
            else:
                self.place_and_clock(head)
            f.metrics.gauge("sched.queue_depth").set(len(f.pending), f.now)
            placed_any = True
        self.update_hol()
        return placed_any

    def place_and_clock(self, job) -> None:
        """Admit + derive departure times from the queueing simulator."""
        f = self.f
        f.admit(job.graph, now=f.now)
        job.last_clock = f.now
        if f.reclock:
            # one warm simulate keys the new job AND re-keys every other
            # live job under the arrival's added contention
            f._reclock_fleet()
            return
        # stale-clock baseline: key this job once, never revisit the rest
        res = f._sim.simulate(f._live_graphs(), f.placement)
        duration = max(res.job_finish[job.job_id], 1e-9)
        job.msg_wait = res.per_job_wait[job.job_id]
        job.sim_finish = duration
        job.departure = f.now + duration
        f._last_res = res
        f._sample_mutation(res)
        f.events.push(Event(time=job.departure, kind=DEPARTURE,
                            job_id=job.job_id, epoch=job.epoch))

    # -- joint batched admission (DESIGN.md §13) -----------------------------
    def domain_sizes(self):
        if not hasattr(self, "_domain_sizes_cache"):
            from ..search.moves import domain_sizes
            self._domain_sizes_cache = domain_sizes(self.f.cluster)
        return self._domain_sizes_cache

    def select_batch(self) -> list:
        """The admission batch: the FIFO prefix plus bounded look-ahead
        backfill — scan at most ``lookahead`` queued jobs and take every
        one that still fits the remaining free budget. A job is only
        ever skipped because it does not fit, so backfill cannot starve
        the head (it keeps its budget claim)."""
        f = self.f
        budget = f.tracker.total_free()
        batch: list = []
        for jid in list(f.pending)[:self.lookahead]:
            job = f.jobs[jid]
            if job.graph.n_procs <= budget:
                batch.append(job)
                budget -= job.graph.n_procs
        return batch

    def admit_batch(self) -> bool:
        """Place the admission batch jointly (§13): route jobs to cells,
        generate K joint placements per cell group and commit the best
        by one warm ``simulate_batch`` against the full live set. Jobs
        whose group does not fit stay queued (in order) and retry at the
        next capacity event or window close. Returns whether anything
        was placed; the caller re-clocks."""
        f = self.f
        batch = self.select_batch()
        if not batch:
            self.update_hol()
            return False
        f.metrics.counter("sched.joint_batches").inc()
        placed: set = set()
        if f.fabric.n_cells == 1:
            placed |= self.place_batch_jointly(None, batch)
        else:
            # route with decremented budgets so one cell is never handed
            # more batch jobs than it has free cores
            remaining = {c.cell_id: c.total_free() for c in f.fabric.cells}
            groups: dict[int, list] = {}
            for job in batch:
                cell = f.fabric.route(job.graph, remaining)
                cid = GLOBAL_CELL if cell is None else cell.cell_id
                if cell is not None:
                    remaining[cid] -= job.graph.n_procs
                    if cell.parent is not None:
                        remaining[cell.parent] -= job.graph.n_procs
                groups.setdefault(cid, []).append(job)
            # spanning placements first (GLOBAL_CELL sorts lowest): they
            # claim cores across cells, and each cell group re-checks
            # fit when its own candidates are generated
            for cid in sorted(groups):
                jobs = groups[cid]
                if cid == GLOBAL_CELL:
                    for job in jobs:
                        try:
                            f.admit(job.graph, now=f.now)
                        except ClusterFull:
                            continue    # stays queued — retry later
                        job.last_clock = f.now
                        placed.add(job.job_id)
                else:
                    placed |= self.place_batch_jointly(
                        f.fabric.cells[cid], jobs)
        if placed:
            f.pending = deque(j for j in f.pending if j not in placed)
            f.metrics.counter("sched.joint_admitted").inc(len(placed))
            f.metrics.gauge("sched.queue_depth").set(len(f.pending), f.now)
        self.update_hol()
        return bool(placed)

    def place_batch_jointly(self, cell: Optional[FleetCell],
                            jobs: list) -> set:
        """Commit one cell group of the admission batch (§13).

        K joint candidates (portfolio seeds x per-job strategy draws x
        batch-restricted search moves, ``repro_torch.search.joint``) are scored
        in a single warm ``simulate_batch`` against the live set they
        will contend with — THE fix for the admission-in-isolation
        regression: the objective is the projected total wait of
        everyone, not the arrival's own wait in an empty room."""
        from ..search.joint import joint_candidates

        f = self.f
        graphs = [j.graph for j in jobs]
        tracker = f.tracker if cell is None else cell.tracker
        # a non-one-shot configured strategy (e.g. search:new) joins the
        # candidate pool as an extra whole-batch seed — its isolation-
        # scored placement is judged jointly like every other candidate
        extra = None if f.strategy_name in ONE_SHOT_STRATEGIES \
            else f._strategy
        prefer = f.strategy_name \
            if f.strategy_name in ONE_SHOT_STRATEGIES else "new"
        cands = joint_candidates(graphs, f.cluster, tracker.free_mask(),
                                 self.rng, self.k,
                                 sizes=self.domain_sizes(), extra=extra,
                                 prefer=prefer)
        if not cands:
            return set()        # group does not fit — stays queued
        if cell is None:
            live_jobs = list(f.live.values())
            sim = f._sim
        else:
            live_jobs = [f.live[jid] for jid in f.fabric.cell_jobs(cell)]
            sim = cell.sim
        live_graphs = [j.graph for j in live_jobs] + graphs
        trials = []
        for cand in cands:
            trial = f.placement.copy()
            for jid, cores in cand.items():
                trial.assign(jid, cores)
            trials.append(trial)
        scored = sim.simulate_batch(live_graphs, trials)
        # remaining-work-weighted wait: the clock accrues each job's
        # projected wait in proportion to the work it still does under
        # this contention, so a placement is judged by the wait it
        # inflicts on work that remains — not by re-counting the full
        # wait of jobs that are nearly done
        weight = {j.job_id: max(1.0 - j.work_done, 0.0) for j in live_jobs}

        def _score(r) -> float:
            return sum(w * weight.get(jid, 1.0)
                       for jid, w in r.per_job_wait.items())

        if scored[0].max_server_utilisation < f.util_threshold:
            # seed-placed fleet is not contended: projected margins
            # between candidates are noise about a future the simulate
            # cannot see — trust the contention-robust mapper (the same
            # threshold that gates remap passes gates deviation here)
            best_i = 0
        else:
            best_i = min(range(len(scored)),
                         key=lambda i: (_score(scored[i]), i))
        cand = cands[best_i]
        rec = f.recorder
        if rec.enabled:
            rec.instant("admit_batch", track="events",
                        jobs=[j.job_id for j in jobs],
                        n_candidates=len(cands),
                        cell=cell.cell_id if cell is not None else 0,
                        total_wait=scored[best_i].total_wait)
        for job in jobs:
            if rec.enabled:
                rec.instant("queue_drain", track="events", job=job.job_id,
                            queue_wait=f.now - job.arrival,
                            depth=len(f.pending))
            f.admit(job.graph, now=f.now, cores=cand[job.job_id])
            job.last_clock = f.now
        return {j.job_id for j in jobs}

    # -- head-of-line accounting (§13 satellite) -----------------------------
    def accrue_hol(self) -> None:
        """Close the open HOL-blocked interval into the counter."""
        if self.hol_since is None:
            return
        dt = self.f.now - self.hol_since
        if dt > 0.0 and self.hol_free > 0:
            self.f.metrics.counter("sched.hol_blocked").inc(
                dt * self.hol_free)
        self.hol_since = None

    def update_hol(self) -> None:
        """Re-arm the head-of-line meter after a queue/capacity change:
        an interval is HOL-blocked when the FIFO head does not fit the
        free pool but some later queued job would — the free cores the
        strict FIFO leaves idle, integrated as core-seconds."""
        f = self.f
        self.accrue_hol()
        if not f.pending:
            return
        free = f.tracker.total_free()
        if free <= 0 or f.jobs[f.pending[0]].graph.n_procs <= free:
            return      # head fits (or nothing free): not HOL blocking
        if any(f.jobs[jid].graph.n_procs <= free for jid in f.pending):
            self.hol_since = f.now
            self.hol_free = free
