"""The budgeted remap engine (DESIGN.md §3/§10/§13).

Periodic contention-driven re-placement: when projected peak server
utilisation is over threshold, trial moves of the most-contended live
jobs are scored in ONE warm ``simulate_batch`` and the best candidate is
committed only if its projected wait reduction pays for the migration
(state moved over the NIC, priced in the fleet's wait-accrual currency).

The :class:`RemapEngine` owns the remap RNG, the scheduled-tick flag and
the decision log; tuning knobs (``remap_interval`` / ``util_threshold``
/ ``remap_budget`` ...) stay on the fleet facade (``self.f``) so tests
and benchmarks keep their historical configuration surface. Layering:
imports only ``repro_torch.core`` / ``repro_torch.obs`` / ``repro_torch.search`` /
``repro_torch.ckpt`` and the sched event/cell primitives — never the sibling
subsystems (clock / admission / recovery); cross-subsystem calls route
through the facade (``f._reclock`` / ``f.clock``).

Cross-cell migration (§13): on a sharded fleet the per-cell passes see
only their own shard, so a job pinned in a hot cell can never reach the
idle cell next door. After the per-cell passes the engine proposes ONE
whole-job move from the most contended cell into the best-fitting other
cell, scored over the two cells' combined live sets (exact — subtrees
share no links while nothing spans globally) and priced with the same
migration-cost currency as every other remap.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.graphs import AppGraph, ClusterFull, FreeCoreTracker
from ..core.simulator import SimHandle
from .cells import FleetCell
from .events import DEPARTURE, REMAP, Event


@dataclasses.dataclass(frozen=True)
class RemapDecision:
    """One remap-pass verdict (kept for inspection and tests)."""

    time: float
    job_id: int
    wait_gain: float           # projected total-wait reduction (s)
    bytes_moved: float         # migration payload over the NIC
    migration_time: float      # bytes_moved / nic_bw (s)
    committed: bool


class RemapEngine:
    """Budgeted remap passes + migration pricing over a fleet facade."""

    def __init__(self, fleet, rng_seed: int = 0) -> None:
        self.f = fleet
        self.rng = np.random.default_rng(rng_seed)
        self.scheduled = False
        self.decisions: list[RemapDecision] = []

    def maybe_schedule(self) -> None:
        f = self.f
        if f.remap_interval is None or self.scheduled:
            return
        # only worth ticking while jobs are live or still queued/arriving
        if f.live or f.pending or f._arrivals_pending:
            f.events.push(Event(time=f.now + f.remap_interval, kind=REMAP))
            self.scheduled = True

    def run_pass(self) -> None:
        """Re-place contended jobs when projected utilisation is over
        threshold AND the wait reduction pays for the migration.

        Default mode: up to ``remap_candidates`` trial moves (the
        most-contended live jobs, each re-placed into the current free
        pool) are scored in ONE ``simulate_batch`` call — on the torch and
        kernel backends that is a single batched scan, so K candidates cost about
        as much as one. The best net-gain candidate is committed if
        profitable. With ``remap_budget`` set, the fixed candidate list
        becomes a budgeted population search (:meth:`search`).
        """
        f = self.f
        if len(f.live) < 2:
            return
        if f.fabric.n_cells > 1 and not f.fabric.n_spanning:
            # sharded fleet with no global couplings: each placement
            # domain (pod when it holds pod-spanning jobs, rack
            # otherwise) runs its own pass against its own warm handle
            # and tracker view, then one cross-cell move may rebalance
            for cell in f.fabric.pass_domains():
                self.pass_cell(cell)
            if f.cross_cell_migration:
                self.cross_cell_pass()
            return
        live = f._live_graphs()
        # the fleet is unchanged since the last re-clock on most remap
        # ticks — reuse its SimResult (sampled by _sample_mutation at the
        # mutation) rather than re-simulating; when it IS missing (stale
        # mode after a departure) the fresh simulate is tick-driven, not
        # mutation-driven, so it deliberately takes no utilisation sample
        res = f._last_res
        if res is None:
            res = f._sim.simulate(live, f.placement)
            f._last_res = res
        if res.max_server_utilisation < f.util_threshold:
            return
        if f.remap_budget:
            # routed through the facade so tests can monkeypatch the
            # instance's _remap_search wholesale
            f._remap_search(live, res)
            return
        movable = self.movable_jobs(res)
        if not movable:
            return
        candidates = self.reseed_candidates(movable, f.remap_candidates)
        if not candidates:
            return
        best, best_any = self.evaluate_candidates(live, res, candidates)
        commit = best is not None
        self.record_decision(best if commit else best_any, commit)
        if commit:
            self.commit(best)

    def pass_cell(self, cell: FleetCell) -> None:
        """One placement domain's remap pass: identical policy to the
        global pass, but contention, candidates and the commit re-key all
        stay inside the domain (its tracker view cannot propose
        out-of-domain cores)."""
        f = self.f
        jids = [jid for jid in f.fabric.cell_jobs(cell) if jid in f.live]
        if len(jids) < 2:
            return
        jobs = [f.live[jid] for jid in jids]
        live = [j.graph for j in jobs]
        res = cell.last_res
        if res is None:
            res = cell.sim.simulate(live, f.placement)
            cell.last_res = res
        if res.max_server_utilisation < f.util_threshold:
            return
        movable = self.movable_jobs(res)
        if not movable:
            return
        candidates = self.reseed_candidates(movable, f.remap_candidates,
                                            tracker=cell.tracker)
        if not candidates:
            return
        best, best_any = self.evaluate_candidates(live, res, candidates,
                                                  sim=cell.sim)
        commit = best is not None
        self.record_decision(best if commit else best_any, commit)
        if commit:
            self.commit(best, cell=cell)

    def search(self, live: list[AppGraph], res) -> None:
        """Budgeted population search over the live placement (§10).

        Each round builds a population — strategy reseeds of the most
        contended jobs plus random single-job swap / migrate / subtree
        moves from ``repro_torch.search.moves`` — and scores it in one warm
        ``simulate_batch`` (the ``SimHandle`` delta path, so the honest
        clock's wall-time gate is unaffected). The best profitable move
        is committed through the normal migration-cost bookkeeping and
        the next round hill-climbs from the post-commit fleet, until the
        evaluation budget is spent or no move pays for its migration.
        """
        from ..search.moves import SearchState, domain_sizes, neighbours

        f = self.f
        sizes = domain_sizes(f.cluster)
        evals = 0
        committed = 0
        while evals < f.remap_budget:
            movable = self.movable_jobs(res)
            if not movable:
                break
            k = min(f.remap_population, f.remap_budget - evals)
            candidates = self.reseed_candidates(movable, max(1, k // 4))
            state = SearchState(
                f.cluster,
                {jid: j.cores.copy() for jid, j in f.live.items()},
                f.tracker.free_mask())
            for move, nxt in neighbours(self.rng, state,
                                        k - len(candidates), jobs=movable,
                                        allow_cross_job=False, sizes=sizes):
                jid = int(move.detail[0])
                candidates.append((jid, nxt.assignments[jid]))
            if not candidates:
                break
            evals += len(candidates)
            best, best_any = self.evaluate_candidates(live, res, candidates)
            if best is None:
                if committed == 0 and best_any is not None:
                    self.record_decision(best_any, committed=False)
                break
            self.record_decision(best, committed=True)
            self.commit(best)
            committed += 1
            res = best[8]      # the committed candidate IS the new baseline

    def record_decision(self, entry, committed: bool) -> None:
        """Book one remap verdict: decision record, counter, trace event
        (commit/reject with the savings-vs-migration-cost breakdown)."""
        f = self.f
        self.decisions.append(RemapDecision(
            time=f.now, job_id=entry[1], wait_gain=entry[7],
            bytes_moved=entry[5], migration_time=entry[6],
            committed=committed))
        f.metrics.counter("sched.remap_commits" if committed
                          else "sched.remap_rejects").inc()
        rec = f.recorder
        if rec.enabled:
            rec.instant("remap_commit" if committed else "remap_reject",
                        track="remap", job=entry[1], net_gain=entry[0],
                        wait_gain=entry[7], bytes_moved=entry[5],
                        migration_time=entry[6], procs_moved=entry[4])

    def movable_jobs(self, res) -> list[int]:
        """Live jobs under their migration budget, most-contended first."""
        f = self.f
        movable = [j for j in res.per_job_wait
                   if f.live[j].n_migrations < f.max_migrations_per_job]
        movable.sort(key=lambda j: (res.per_job_wait[j], j), reverse=True)
        return movable

    def reseed_candidates(self, movable: list[int], k: int,
                          tracker: Optional[FreeCoreTracker] = None
                          ) -> list[tuple[int, np.ndarray]]:
        """Trial re-placements: each of the top-k contended jobs re-run
        through the admission strategy against the current free pool
        (``tracker`` scopes the pool to one cell's view)."""
        f = self.f
        tracker = f.tracker if tracker is None else tracker
        snap = tracker.snapshot()
        candidates: list[tuple[int, np.ndarray]] = []
        for jid in movable[:k]:
            job = f.live[jid]
            tracker.release_cores(job.cores)
            try:
                local = f._strategy([job.graph], f.cluster, tracker)
            except ClusterFull:
                continue
            finally:
                tracker.restore(snap)
            candidates.append((jid, local.assignments[jid]))
        return candidates

    def evaluate_candidates(self, live: list[AppGraph], res,
                            candidates: list[tuple[int, np.ndarray]],
                            sim: Optional[SimHandle] = None):
        """Score single-job trial moves in one warm ``simulate_batch``.

        Returns ``(best, best_any)`` entries — best committable (actual
        move, gain pays the migration) and best overall (recorded as the
        reject decision when nothing commits).
        """
        f = self.f
        rec = f.recorder
        if rec.enabled:
            rec.instant("remap_propose", track="remap",
                        n_candidates=len(candidates),
                        jobs=sorted({jid for jid, _ in candidates}),
                        peak_util=res.max_server_utilisation)
        f.metrics.counter("sched.remap_evals").inc(len(candidates))
        trials = []
        for jid, new_cores in candidates:
            trial = f.placement.copy()
            trial.assign(jid, new_cores)
            trials.append(trial)
        scored = (f._sim if sim is None else sim).simulate_batch(
            live, trials)
        # price the migration stall in the same currency as the gain:
        # ``gain`` is projected wait-seconds saved over the live set's
        # remaining horizon, ``migration_time`` is wall seconds — so a
        # second of stall costs the fleet its current wait-accrual rate
        # (clamped at 1.0 so the rule is never weaker than the raw
        # seconds comparison the tests pin)
        horizon = max(res.job_finish.values(), default=0.0)
        wait_rate = max(res.total_wait / max(horizon, 1e-9), 1.0)
        best = None        # best committable candidate (actual moves only)
        best_any = None    # best overall, recorded when nothing commits
        for (jid, new_cores), res_new in zip(candidates, scored):
            job = f.live[jid]
            moved = int((f.cluster.node_of(new_cores)
                         != f.cluster.node_of(job.cores)).sum())
            bytes_moved = moved * job.state_bytes_per_proc
            migration_time = bytes_moved / f.cluster.nic_bw
            gain = res.total_wait - res_new.total_wait
            cost = migration_time * f.migration_cost_factor * wait_rate
            net = gain - cost
            entry = (net, jid, job.cores, new_cores, moved, bytes_moved,
                     migration_time, gain, res_new)
            if best_any is None or net > best_any[0]:
                best_any = entry
            committable = moved > 0 and gain > cost
            if committable and (best is None or net > best[0]):
                best = entry
        return best, best_any

    def commit(self, entry, cell: Optional[FleetCell] = None) -> None:
        """Apply one scored move: claim cores, book migration cost, re-key.

        ``cell`` scopes the re-key to one cell when the candidate was
        scored by that cell's handle (per-cell remap passes); the global
        path re-keys the whole fleet from the scored result as before."""
        f = self.f
        (_, worst_id, old_cores, new_cores, moved, bytes_moved,
         migration_time, gain, res_new) = entry
        job = f.live[worst_id]
        f.tracker.release_cores(old_cores)
        f.tracker.take_cores(new_cores)
        f.fabric.release(old_cores)
        f.fabric.claim(new_cores)
        f.placement.assign(worst_id, new_cores)
        f._index_remove(worst_id, old_cores)
        f._index_add(worst_id, new_cores)
        f.fabric.unbind(worst_id, old_cores, job.graph)
        f.fabric.bind(worst_id, new_cores, job.graph)
        job.cores = new_cores
        job.n_migrations += 1
        job.migrated_bytes += bytes_moved
        if f.reclock:
            # migration stalls the job while its state crosses the NIC:
            # book the transfer as work debt so the re-key below (and any
            # later re-clock) carries it as (1 - work_done) * sim_finish
            job.work_done -= migration_time \
                / max(res_new.job_finish[worst_id], 1e-9)
            # re-key EVERYONE the scored result covers, straight from the
            # already-scored committed candidate (one batched scan paid
            # for it — no extra simulate here); the post-remap peak
            # utilisation is sampled inside the re-clock
            if cell is not None and f.fabric.n_cells > 1:
                f.fabric.dirty.discard(cell.cell_id)
                for child in cell.children:
                    f.fabric.dirty.discard(child)
                f.clock.reclock_cell(cell, res=res_new)
            else:
                f.clock.reclock(res=res_new)
            return
        # stale-clock baseline: record post-remap utilisation, refresh the
        # projected waits so committed gains (and collateral damage) show
        # up in the final metrics, and shift only the migrated job
        f._last_res = res_new
        f._sample_mutation(res_new)
        for jid, w in res_new.per_job_wait.items():
            f.live[jid].msg_wait = w
        if job.departure is not None:
            # moving state over the NIC delays the job; re-key its departure
            job.departure += migration_time
            job.epoch += 1
            f.events.push(Event(time=job.departure, kind=DEPARTURE,
                                job_id=worst_id, epoch=job.epoch))

    # -- cross-cell migration (§13) -----------------------------------------
    def cross_cell_pass(self) -> None:
        """Move ONE whole job from the hottest placement domain into the
        best-fitting other domain when the combined projected wait drop
        pays for the migration.

        Runs only while no job spans globally, so the two domains'
        subtrees share no links and scoring their combined live sets in
        isolation is exact. At most one move per remap tick keeps the
        pass cheap (2 simulates) and lets the normal re-clock cadence
        absorb each move before the next is considered."""
        f = self.f
        fab = f.fabric
        domains = [c for c in fab.pass_domains() if c.last_res is not None]
        if len(fab.pass_domains()) < 2 or not domains:
            return
        src = max(domains,
                  key=lambda c: (c.last_res.max_server_utilisation,
                                 -c.cell_id))
        res_src = src.last_res
        if res_src.max_server_utilisation < f.util_threshold:
            return
        movable = self.movable_jobs(res_src)
        movable = [jid for jid in movable if jid in f.live
                   and jid in fab.cell_jobs(src)]
        if not movable:
            return
        jid = movable[0]
        job = f.live[jid]
        # destination: the best-fitting OTHER domain by the balancer's
        # load-per-uplink score; staying inside the domain list keeps
        # the combined scoring exact (no half-covered pod subtrees)
        demand = float(job.graph.demand.sum())
        dst = None
        dst_score = 0.0
        for cell in fab.pass_domains():
            if cell.cell_id == src.cell_id or cell.cell_id in src.children \
                    or cell.parent == src.cell_id:
                continue
            if cell.total_free() < job.graph.n_procs:
                continue
            score = (fab.subtree_load(cell) + demand) / cell.uplink_bw
            if dst is None or score < dst_score:
                dst, dst_score = cell, score
        if dst is None:
            return
        # trial placement on the destination's tracker view
        snap = dst.tracker.snapshot()
        try:
            local = f._strategy([job.graph], f.cluster, dst.tracker)
        except ClusterFull:
            return
        finally:
            dst.tracker.restore(snap)
        new_cores = local.assignments[jid]
        # score over the two domains' combined live sets: one baseline
        # simulate + one single-trial batch through the global warm handle
        jids = sorted(set(fab.cell_jobs(src)) | set(fab.cell_jobs(dst)))
        jobs = [f.live[j] for j in jids if j in f.live]
        live = [j.graph for j in jobs]
        base = f._sim.simulate(live, f.placement)
        trial = f.placement.copy()
        trial.assign(jid, new_cores)
        res_new = f._sim.simulate_batch(live, [trial])[0]
        moved = int((f.cluster.node_of(new_cores)
                     != f.cluster.node_of(job.cores)).sum())
        bytes_moved = moved * job.state_bytes_per_proc
        migration_time = bytes_moved / f.cluster.nic_bw
        horizon = max(base.job_finish.values(), default=0.0)
        wait_rate = max(base.total_wait / max(horizon, 1e-9), 1.0)
        gain = base.total_wait - res_new.total_wait
        cost = migration_time * f.migration_cost_factor * wait_rate
        entry = (gain - cost, jid, job.cores, new_cores, moved,
                 bytes_moved, migration_time, gain, res_new)
        if moved <= 0 or gain <= cost:
            self.record_decision(entry, committed=False)
            return
        self.record_decision(entry, committed=True)
        # commit by hand: res_new covers only the two subtrees, so the
        # re-key is scoped to exactly the jobs it scored — everyone whose
        # contention the move could change
        f.tracker.release_cores(job.cores)
        f.tracker.take_cores(new_cores)
        f.fabric.release(job.cores)
        f.fabric.claim(new_cores)
        f.placement.assign(jid, new_cores)
        f._index_remove(jid, job.cores)
        f._index_add(jid, new_cores)
        f.fabric.unbind(jid, job.cores, job.graph)
        f.fabric.bind(jid, new_cores, job.graph)
        job.cores = new_cores
        job.n_migrations += 1
        job.migrated_bytes += bytes_moved
        job.work_done -= migration_time \
            / max(res_new.job_finish[jid], 1e-9)
        f._last_res = None      # res_new is a subtree view, not the fleet
        f._sample_mutation(res_new)
        f.clock.rekey(jobs, res_new)
        # both subtrees are freshly keyed from res_new — drop their dirty
        # marks so the next re-clock does not redundantly re-simulate them
        for cell in (src, dst):
            f.fabric.dirty.discard(cell.cell_id)
            for child in cell.children:
                f.fabric.dirty.discard(child)
        f.metrics.counter("sched.cross_cell_migrations").inc()
        rec = f.recorder
        if rec.enabled:
            rec.instant("cross_cell_migrate", track="remap", job=jid,
                        src=src.cell_id, dst=dst.cell_id,
                        bytes_moved=bytes_moved, gain=gain)
