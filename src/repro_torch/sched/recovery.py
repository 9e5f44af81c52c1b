"""The failure engine — fail/recover/drain handling (DESIGN.md §12).

Injected ``NODE_FAIL`` / ``NODE_RECOVER`` / ``DRAIN`` events drive two
job-recovery policies — requeue-restart (kill, roll back to the last
checkpoint via ``ckpt.checkpoint.CheckpointCostModel``, re-admit through
the FIFO with the restore traffic booked as work debt) and elastic-shrink
(shed the dead node's procs with ``ckpt.fault_tolerance.ElasticReMesher``
and re-place the survivors' shrunk CTG) — plus two drain policies:
proactive (evacuate the draining node through the remap machinery before
the deadline) and kill (let the deadline hard-kill whatever is left).

The :class:`RecoveryEngine` owns node liveness (the sim-clocked
``HeartbeatMonitor``), the draining windows with their generation
epochs, and the MTTR kill-time ledger; fleet state and the sibling
subsystems are reached through the facade (``self.f``). Layering:
imports only ``repro_torch.core`` / ``repro_torch.obs`` / ``repro_torch.search`` /
``repro_torch.ckpt`` and the sched event/cell primitives — never the sibling
subsystems (clock / admission / remap); their services route through
facade delegators (``f._drain_pending`` / ``f._reclock_fleet`` /
``f.remap``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..ckpt.checkpoint import CheckpointCostModel
from ..ckpt.fault_tolerance import ElasticReMesher, HeartbeatMonitor
from ..core.graphs import AppGraph, ClusterFull
from .events import DEPARTURE, DRAIN, Event, stale_event


class RecoveryEngine:
    """Fail/recover/drain handlers + recovery policies over a facade."""

    def __init__(self, fleet, *, failure_policy: str = "requeue",
                 drain_policy: str = "proactive",
                 ckpt_model: Optional[CheckpointCostModel] = None,
                 elastic_model_size: int = 1) -> None:
        if failure_policy not in ("requeue", "elastic"):
            raise ValueError(f"unknown failure_policy {failure_policy!r}")
        if drain_policy not in ("proactive", "kill"):
            raise ValueError(f"unknown drain_policy {drain_policy!r}")
        self.f = fleet
        self.failure_policy = failure_policy
        self.drain_policy = drain_policy
        self.ckpt = ckpt_model if ckpt_model is not None \
            else CheckpointCostModel()
        self.elastic_model_size = max(1, elastic_model_size)
        # node liveness is canonical here; the sim-time clock (NOT the
        # wall-clock default) keeps last_seen — and every trace field
        # derived from it — byte-identical across seeded runs
        self.monitor = HeartbeatMonitor(fleet.cluster.n_nodes,
                                        deadline_s=float("inf"),
                                        clock=lambda: fleet.now)
        self.draining: dict[int, float] = {}   # node -> hard-kill deadline
        self.drain_gen: dict[int, int] = {}    # stale-deadline-tick guard
        self.node_down_at: dict[int, float] = {}
        self.kill_time: dict[int, float] = {}  # job -> eviction time (MTTR)

    # -- node-event handlers -------------------------------------------------
    def node_fail(self, ev: Event) -> None:
        f = self.f
        node = ev.node
        if not self.monitor.alive[node]:
            return      # overlapping injector windows — already down
        self.monitor.mark_dead(node)
        self.node_down_at[node] = f.now
        self.draining.pop(node, None)   # a failure overrides a drain
        f.tracker.set_offline(f._node_cores(node))
        f.fabric.set_offline(node)
        f.metrics.counter("fault.node_failures").inc()
        affected = f._jobs_on_node(node)
        rec = f.recorder
        if rec.enabled:
            rec.instant("node_fail", track="faults", node=node,
                        affected=affected,
                        pending_departures=f.events.count(DEPARTURE))
        for jid in affected:
            self.fail_job(jid, reason="node_fail")
        # killed jobs released their surviving cores — the FIFO head
        # (including the restarts just queued) may fit right now
        placed_any = f._drain_pending()
        f._reclock_fleet()
        if affected or placed_any:
            f._maybe_schedule_remap()

    def node_recover(self, ev: Event) -> None:
        f = self.f
        node = ev.node
        was_draining = self.draining.pop(node, None) is not None
        if self.monitor.alive[node] and not was_draining:
            return      # duplicate recover (overlapping injector windows)
        self.monitor.revive(node)
        f.tracker.set_online(f._node_cores(node))
        f.fabric.set_online(node)
        f.metrics.counter("fault.node_recoveries").inc()
        down_at = self.node_down_at.pop(node, None)
        if down_at is not None:
            f.metrics.histogram("fault.node_downtime_s").observe(
                f.now - down_at)
        rec = f.recorder
        if rec.enabled:
            rec.instant("node_recover", track="faults", node=node,
                        down_s=(f.now - down_at) if down_at is not None
                        else 0.0, cancelled_drain=was_draining,
                        pending_departures=f.events.count(DEPARTURE))
        placed_any = f._drain_pending()
        if placed_any:
            f._reclock_fleet()
            f._maybe_schedule_remap()

    def drain(self, ev: Event) -> None:
        f = self.f
        node = ev.node
        if ev.epoch:
            # the deadline tick we scheduled at drain start; the shared
            # staleness rule (events.stale_event) kills ticks whose drain
            # was cancelled by a failure/recover (generation gone) or
            # superseded by a newer drain window (generation advanced)
            live_gen = self.drain_gen.get(node) \
                if node in self.draining else None
            if not stale_event(ev.epoch, live_gen):
                self.drain_deadline(node)
            return
        if node in self.draining or not self.monitor.alive[node]:
            return      # duplicate start / node already down
        gen = self.drain_gen.get(node, 0) + 1
        self.drain_gen[node] = gen
        self.draining[node] = ev.deadline
        # draining cores leave the schedulable pool immediately; jobs
        # already on the node keep running until migrated or killed
        f.tracker.set_offline(f._node_cores(node))
        f.fabric.set_offline(node)
        f.metrics.counter("fault.drains").inc()
        rec = f.recorder
        if rec.enabled:
            rec.instant("drain_begin", track="faults", node=node,
                        deadline=ev.deadline, policy=self.drain_policy,
                        resident=f._jobs_on_node(node),
                        pending_departures=f.events.count(DEPARTURE))
        if self.drain_policy == "proactive":
            self.evacuate(node)
        if ev.deadline <= ev.time:
            self.drain_deadline(node)
        else:
            f.events.push(Event(time=ev.deadline, kind=DRAIN, node=node,
                                deadline=ev.deadline, epoch=gen))

    def drain_deadline(self, node: int) -> None:
        """Drain grace expired: hard-kill whatever still holds the node
        and put it into its maintenance window (NODE_RECOVER ends it)."""
        f = self.f
        del self.draining[node]
        victims = f._jobs_on_node(node)
        self.monitor.mark_dead(node)
        self.node_down_at[node] = f.now
        f.metrics.counter("fault.drain_kills").inc(len(victims))
        rec = f.recorder
        if rec.enabled:
            rec.instant("drain_deadline", track="faults", node=node,
                        killed=victims)
        for jid in victims:
            job = f.live[jid]
            # deadline kills are always hard restarts — elastic shrink is
            # a failure response; a drained node's procs are not "dead",
            # the whole job must vacate
            self.requeue(job, self.rollback(job), reason="drain_deadline")
        placed_any = f._drain_pending()
        f._reclock_fleet()
        if victims or placed_any:
            f._maybe_schedule_remap()

    # -- job recovery policies -----------------------------------------------
    def fail_job(self, jid: int, reason: str) -> None:
        """One job lost cores to a dead node: roll back to its last
        checkpoint, then shrink (elastic policy, when possible) or
        requeue-restart."""
        job = self.f.live[jid]
        kept_work = self.rollback(job)
        if self.failure_policy == "elastic" \
                and self.elastic_shrink(job, kept_work):
            return
        self.requeue(job, kept_work, reason)

    def rollback(self, job) -> float:
        """Checkpoint rollback: books the lost work and returns the work
        fraction that survives (progress at the last checkpoint)."""
        progress_s = max(job.work_done, 0.0) * job.sim_finish
        lost_s = self.ckpt.lost_work(progress_s)
        job.lost_work_s += lost_s
        self.f.metrics.counter("fault.lost_work_s").inc(lost_s)
        # the goodput ledger credited this work as it accrued — take the
        # discarded tail back out
        self.f.clock.useful_core_s -= lost_s * job.graph.n_procs
        if job.sim_finish <= 0.0:
            return 0.0
        return (progress_s - lost_s) / job.sim_finish

    def evict(self, jid: int, reason: str):
        """Remove a live job without crediting completion: cores go back
        to the pool (offline ones stay unschedulable), any in-flight
        departure event goes stale via the epoch bump."""
        f = self.f
        job = f.live.pop(jid)
        cores = f.placement.remove(jid)
        f.tracker.release_cores(cores)
        f.fabric.release(cores)
        f._index_remove(jid, cores)
        f.fabric.unbind(jid, cores, job.graph)
        job.cores = None
        job.epoch += 1
        job.departure = None
        job.sim_finish = 0.0
        job.wait_proj = 0.0
        f._last_res = None
        rec = f.recorder
        if rec.enabled:
            rec.instant("evict", track="faults", job=jid, reason=reason)
        return job

    def requeue(self, job, kept_work: float, reason: str) -> None:
        """Requeue-restart: kill the job and re-admit it through the FIFO
        tail, carrying its checkpointed progress and a restore-traffic
        work debt (state re-read through the NIC at re-placement)."""
        f = self.f
        self.evict(job.job_id, reason)
        job.work_done = kept_work
        job.restart_debt_s = self.ckpt.restore_seconds(
            job.state_bytes_per_proc * job.graph.n_procs,
            f.cluster.nic_bw)
        job.n_restarts += 1
        self.kill_time[job.job_id] = f.now
        f.pending.append(job.job_id)
        f.metrics.counter("fault.restarts").inc()
        f.metrics.gauge("sched.queue_depth").set(len(f.pending), f.now)
        rec = f.recorder
        if rec.enabled:
            rec.instant("requeue_restart", track="faults", job=job.job_id,
                        reason=reason, kept_work=kept_work,
                        restore_debt_s=job.restart_debt_s,
                        depth=len(f.pending))

    def elastic_shrink(self, job, kept_work: float) -> bool:
        """Elastic-shrink recovery: shed the dead node's procs and re-place
        the survivors' shrunk CTG with the admission strategy (the paper's
        mapper on the degraded cluster). Returns False when the job cannot
        shrink — no survivors, no power-of-two slice, or the survivors do
        not fit — and the caller falls back to requeue-restart.

        Modeling choice: ``work_done`` is a fraction of the job, so the
        checkpointed fraction carries over to the shrunk configuration
        and the remaining work is re-priced by the next re-clock under
        the shrunk CTG's contention.
        """
        f = self.f
        graph = job.graph
        survivors = np.flatnonzero(
            self.monitor.alive[f.cluster.node_of(job.cores)])
        if survivors.size == 0:
            return False
        plan = ElasticReMesher(model_size=self.elastic_model_size,
                               chips_per_host=1).replan(survivors.tolist())
        usable = plan.data_size * plan.model_size
        if usable < 1:
            return False
        # chips_per_host=1 makes replan's chip list the survivor ranks
        # themselves; device_order indexes that list (surviving ranks)
        kept_ranks = survivors[plan.device_order]
        sub = np.sort(kept_ranks)
        shrunk = AppGraph(name=f"{graph.name}~{usable}",
                          L=graph.L[np.ix_(sub, sub)].copy(),
                          lam=graph.lam[np.ix_(sub, sub)].copy(),
                          cnt=graph.cnt[np.ix_(sub, sub)].copy(),
                          job_id=graph.job_id)
        snap = f.tracker.snapshot()
        f.tracker.release_cores(job.cores)
        try:
            local = f._strategy([shrunk], f.cluster, f.tracker)
        except ClusterFull:
            f.tracker.restore(snap)
            return False
        new_cores = local.assignments[job.job_id]
        f.placement.remove(job.job_id)
        f.placement.assign(job.job_id, new_cores)
        # sync the cell views and the node index (the strategy already
        # settled the global tracker via the release/claim above)
        f.fabric.release(job.cores)
        f.fabric.claim(new_cores)
        f._index_remove(job.job_id, job.cores)
        f._index_add(job.job_id, new_cores)
        f.fabric.unbind(job.job_id, job.cores, graph)
        f.fabric.bind(job.job_id, new_cores, shrunk)
        job.graph = shrunk          # new object: the warm-sim delta path
        # keys on graph identity, so the swap is a clean remove+add
        job.cores = new_cores
        job.placed_at = f.now       # new stint
        job.epoch += 1              # old departure events are stale
        job.departure = None
        job.work_done = kept_work
        job.restart_debt_s = self.ckpt.restore_seconds(
            job.state_bytes_per_proc * shrunk.n_procs, f.cluster.nic_bw)
        job.n_restarts += 1
        job.last_clock = f.now
        f._last_res = None
        f.metrics.counter("fault.shrinks").inc()
        rec = f.recorder
        if rec.enabled:
            rec.instant("elastic_shrink", track="faults", job=job.job_id,
                        procs_from=graph.n_procs, procs_to=usable,
                        dropped=plan.dropped_chips,
                        restore_debt_s=job.restart_debt_s)
        return True

    def evacuate(self, node: int) -> None:
        """Proactive drain: migrate jobs off ``node`` before the deadline.

        Each resident job is re-placed by the admission strategy against
        the free pool (the node's cores are offline, so candidates cannot
        land back on it) and scored through the same warm
        ``simulate_batch`` path the remap search uses; the move commits
        regardless of profitability — the alternative at the deadline is
        losing the job's uncheckpointed work — with migration bytes
        booked as work debt through the normal remap bookkeeping. Jobs
        that do not fit stay put: the evacuation is retried after every
        departure, and whatever remains at the deadline is hard-killed.
        """
        f = self.f
        affected = f._jobs_on_node(node)
        if not affected:
            return
        live = f._live_graphs()
        res = f._last_res
        if res is None:
            res = f._sim.simulate(live, f.placement)
            f._last_res = res
        for jid in affected:
            candidates = f.remap.reseed_candidates([jid], 1)
            if not candidates:
                continue        # no room yet — retry on the next departure
            _, entry = f.remap.evaluate_candidates(live, res, candidates)
            if entry is None:   # pragma: no cover - single candidate scored
                continue
            f.remap.record_decision(entry, committed=True)
            f.remap.commit(entry)
            f.metrics.counter("fault.evacuations").inc()
            rec = f.recorder
            if rec.enabled:
                rec.instant("drain_evacuate", track="faults", job=jid,
                            node=node,
                            deadline=self.draining.get(node, 0.0))
            live = f._live_graphs()
            res = f._last_res    # remap.commit re-clocked from res_new
