"""AutoscaleEngine — the serving closed loop (DESIGN.md §15).

A sibling of :class:`RemapEngine` in the facade's engine layer
(DESIGN.md §14): it owns the SLO objective for serving fleets and
nothing else. On every TRAFFIC event (one per request-stream epoch) it

1. books the elapsed interval's SLO-violation-seconds under the rates
   that were in force (the accounting is settled *before* any reaction,
   so actions can never launder violations they were too late to fix),
2. refreshes routing weights from each replica's contended capacity
   (the placement-aware routing action), and
3. considers ONE structural action — add-replica or drop-replica —
   committed only when a warm ``simulate_batch`` trial of the changed
   fleet projects fewer SLO-violation-seconds than it costs.

Pricing uses the remap pass's currency: a replica bring-up stalls the
NIC for ``state_bytes / nic_bw`` seconds, priced at the fleet's current
wait-accrual rate and scaled by ``migration_cost_factor``; the gain is
projected violation-seconds saved over ``lookahead_s``, valued at the
same rate. The rate cancels — deliberately: the commit rule is
scale-free in the fleet's wait magnitude, while ``migration_cost_factor``
keeps its historical role as the conservatism dial (1e9 vetoes every
structural action, exactly like the remap tests use it).

Latency model: a replica's *slowdown* is its projected contended finish
over its solo (uncontended) finish — both from the same Lindley-scan
simulator, so NIC contention enters request latency through the exact
machinery the paper's placement objective uses. See
``repro_torch.serve.fleet`` for the M/M/1 tail on top.

Layering: may import only ``repro_torch.core`` / ``repro_torch.obs`` /
``repro_torch.serve`` foundations and the sched leaf siblings (events /
config) — never admission / remap / recovery / clock.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from ..core.graphs import ClusterFull
from ..core.simulator import SimHandle
from ..serve.fleet import (SLOAccountant, TrafficEpoch, clone_replica,
                           fleet_p99s, model_key, route_weights)
from .config import AutoscaleConfig
from .events import Event


@dataclasses.dataclass
class AutoscaleDecision:
    """One considered structural action, committed or not."""

    time: float
    action: str          # "scale_up" | "scale_down"
    model: str
    job_id: int          # replica added / dropped (-1 when nothing fit)
    viol_saved_s: float  # projected violation-seconds saved over lookahead
    cost_s: float        # bring-up stall seconds (cost-factor scaled)
    committed: bool


class AutoscaleEngine:
    """SLO closed loop over the fleet facade (``self.f``)."""

    def __init__(self, fleet, cfg: Optional[AutoscaleConfig] = None) -> None:
        self.f = fleet
        self.cfg = cfg if cfg is not None else AutoscaleConfig()
        self.slos = {s.model: s for s in self.cfg.slos}
        self.acct = SLOAccountant(
            {m: s.p99_target_s for m, s in self.slos.items()})
        self.epochs: tuple[TrafficEpoch, ...] = ()
        self.rates: dict = {}        # offered load in force since last tick
        self.weights: dict = {}      # model -> {job_id: routing fraction}
        self.decisions: list[AutoscaleDecision] = []
        self.last_tick = 0.0
        # dedicated cold handle for solo (uncontended) projections — the
        # facade's warm handle stays keyed to the full live set
        self._solo_sim = SimHandle(fleet.cluster,
                                   count_scale=fleet.count_scale,
                                   backend=fleet.sim_backend,
                                   device=fleet.device)
        self._solo: dict = {}        # job_id -> (cores fingerprint, finish)

    @property
    def enabled(self) -> bool:
        return bool(self.cfg.enabled and self.slos)

    @property
    def horizon(self) -> float:
        """End of the traffic stream (the run loop's natural bound)."""
        return self.epochs[-1].time if self.epochs else 0.0

    def set_epochs(self, epochs: Sequence[TrafficEpoch]) -> None:
        self.epochs = tuple(epochs)

    # -- fleet introspection -------------------------------------------------
    def replicas(self) -> dict:
        """model -> sorted live replica job-ids, for SLO-tracked models."""
        out: dict = {m: [] for m in self.slos}
        for jid, job in self.f.live.items():
            m = model_key(job.graph.name)
            if m in out:
                out[m].append(jid)
        return {m: sorted(jids) for m, jids in out.items()}

    def _solo_finish(self, jid: int) -> float:
        """Uncontended finish of one live replica on its current cores."""
        f = self.f
        job = f.live[jid]
        key = job.cores.tobytes()
        cached = self._solo.get(jid)
        if cached is not None and cached[0] == key:
            return cached[1]
        res = self._solo_sim.simulate([job.graph], f.placement)
        finish = max(res.job_finish[jid], 1e-9)
        self._solo[jid] = (key, finish)
        return finish

    def _slowdowns(self, res, jids) -> dict:
        return {jid: max(res.job_finish[jid] / self._solo_finish(jid), 1.0)
                for jid in jids}

    def _fleet_res(self):
        f = self.f
        if f._last_res is None and f.live:
            f._last_res = f._sim.simulate(f._live_graphs(), f.placement)
        return f._last_res

    # -- projected-violation scoring -----------------------------------------
    def projected_violation_s(self, p99s: dict, rates: dict, replicas: dict,
                              weights: dict, slowdowns: dict) -> float:
        """Projected SLO-violation-seconds over the lookahead window.

        A violating model accrues the whole lookahead; an *overloaded*
        one (offered load at/above some replica's contended capacity —
        its queue grows without bound) accrues more, scaled by the
        overload excess. The excess term makes the score strictly
        decrease as replicas are added to a still-overloaded model, so
        the one-action-per-tick loop can climb out of a deep spike one
        committed step at a time instead of stalling on an inf-to-inf
        p99 comparison.
        """
        total = 0.0
        for m, slo in self.slos.items():
            lam = rates.get(m, 0.0)
            jids = replicas.get(m, [])
            if not jids:
                total += 2.0 * self.cfg.lookahead_s if lam > 0.0 else 0.0
                continue
            w = weights.get(m) or {}
            excess = 0.0
            for j in jids:
                mu = slo.service_rate / max(slowdowns.get(j, 1.0), 1.0)
                lam_j = lam * w.get(j, 1.0 / len(jids))
                if mu > 0.0 and lam_j >= mu:
                    excess = max(excess, (lam_j - mu) / mu)
            if excess > 0.0:
                total += self.cfg.lookahead_s * (1.0 + excess)
            elif p99s.get(m, 0.0) > slo.p99_target_s:
                total += self.cfg.lookahead_s
        return total

    def _p99s(self, replicas: dict, rates: dict, slowdowns: dict) -> dict:
        return fleet_p99s(self.slos, replicas, self.weights, rates,
                          slowdowns)

    # -- the tick ------------------------------------------------------------
    def on_traffic(self, ev: Event) -> None:
        """Settle the elapsed epoch's accounting, then react."""
        f = self.f
        now = f.now
        rec = f.recorder
        res = self._fleet_res()
        replicas = self.replicas()
        jids = [j for js in replicas.values() for j in js]
        slowdowns = self._slowdowns(res, jids) if res is not None else {}
        self._refresh_routing(replicas, res, slowdowns)
        # 1. book [last_tick, now) under the rates that WERE in force
        if now > self.last_tick and self.rates:
            p99s = self._p99s(replicas, self.rates, slowdowns)
            accrued, closed = self.acct.observe(self.last_tick, now, p99s)
            if accrued:
                f.metrics.counter("slo.violation_s").inc(
                    sum(accrued.values()))
            for m, start, end in closed:
                f.metrics.histogram("slo.violation_span_s").observe(
                    end - start)
                if rec.enabled:
                    rec.span(f"slo_violation:{m}", ts=start,
                             dur=end - start, track="slo", model=m)
        # 2. the new epoch's rates come into force
        last_epoch = ev.epoch >= len(self.epochs) - 1
        if 0 <= ev.epoch < len(self.epochs):
            self.rates = dict(self.epochs[ev.epoch].rates)
        p99s = self._p99s(replicas, self.rates, slowdowns)
        for m, p in p99s.items():
            f.metrics.series(f"slo.p99.{m}").append(
                now, min(p, 1e9))
        if last_epoch:
            # closing tick: flush still-open violation spans, no reaction
            for m, start, end in self.acct.close(now):
                f.metrics.histogram("slo.violation_span_s").observe(
                    end - start)
                if rec.enabled:
                    rec.span(f"slo_violation:{m}", ts=start,
                             dur=end - start, track="slo", model=m)
        # 3. one structural action, trial-confirmed and priced
        elif self.cfg.actions and res is not None:
            self.consider_scaling(p99s, replicas, slowdowns, res)
        self.last_tick = now

    def _refresh_routing(self, replicas: dict, res, slowdowns: dict) -> None:
        """Placement-aware routing-weight refresh (free action)."""
        f = self.f
        shifts = 0
        weights: dict = {}
        for m, jids in replicas.items():
            slo = self.slos[m]
            caps = {j: slo.service_rate / max(slowdowns.get(j, 1.0), 1.0)
                    for j in jids}
            w = route_weights(jids, caps, mode=self.cfg.routing)
            old = self.weights.get(m)
            if old is not None and set(old) == set(w) \
                    and any(abs(w[j] - old[j]) > 1e-6 for j in w):
                shifts += 1
            weights[m] = w
        self.weights = weights
        if shifts:
            f.metrics.counter("sched.routing_shifts").inc(shifts)

    # -- structural actions --------------------------------------------------
    def consider_scaling(self, p99s: dict, replicas: dict,
                         slowdowns: dict, res) -> None:
        cfg = self.cfg
        violating = sorted(
            (m for m, slo in self.slos.items()
             if p99s.get(m, 0.0) > slo.p99_target_s
             and len(replicas.get(m, ())) < cfg.max_replicas),
            key=lambda m: (-min(p99s[m] / self.slos[m].p99_target_s, 1e12),
                           m))
        if violating:
            self.try_scale_up(violating[0], p99s, replicas, slowdowns, res)
            return
        idle = sorted(
            (m for m, slo in self.slos.items()
             if len(replicas.get(m, ())) > cfg.min_replicas
             and p99s.get(m, math.inf)
             < cfg.scale_down_margin * slo.p99_target_s),
            key=lambda m: (p99s[m] / self.slos[m].p99_target_s, m))
        if idle:
            self.try_scale_down(idle[0], p99s, replicas, slowdowns, res)

    def _wait_rate(self, res) -> float:
        horizon = max(res.job_finish.values(), default=0.0)
        return max(res.total_wait / max(horizon, 1e-9), 1.0)

    def _record(self, dec: AutoscaleDecision) -> None:
        f = self.f
        self.decisions.append(dec)
        if not dec.committed:
            f.metrics.counter("sched.autoscale_rejects").inc()
        rec = f.recorder
        if rec.enabled:
            rec.instant(dec.action, ts=dec.time, track="autoscale",
                        model=dec.model, job=dec.job_id,
                        viol_saved_s=dec.viol_saved_s, cost_s=dec.cost_s,
                        committed=dec.committed)

    def try_scale_up(self, model: str, p99s: dict, replicas: dict,
                     slowdowns: dict, res) -> None:
        """Add one replica of ``model`` if a trial pays for its bring-up."""
        f = self.f
        cfg = self.cfg
        template = f.live[replicas[model][0]].graph
        new_id = max(f.jobs) + 1
        clone = clone_replica(template, new_id)
        if clone.n_procs > f.tracker.total_free():
            self._record(AutoscaleDecision(
                time=f.now, action="scale_up", model=model, job_id=-1,
                viol_saved_s=0.0, cost_s=0.0, committed=False))
            return
        # trial placement through the live strategy, rolled back — the
        # commit below re-claims the exact cores via admit(cores=...)
        snap = f.tracker.snapshot()
        try:
            local = f._strategy([clone], f.cluster, f.tracker)
        except ClusterFull:
            f.tracker.restore(snap)
            self._record(AutoscaleDecision(
                time=f.now, action="scale_up", model=model, job_id=-1,
                viol_saved_s=0.0, cost_s=0.0, committed=False))
            return
        f.tracker.restore(snap)
        cores = local.assignments[new_id]
        # warm trial: the changed fleet, scored by the shared machinery
        live_graphs = f._live_graphs() + [clone]
        trial = f.placement.copy()
        trial.assign(new_id, cores)
        res_new = f._sim.simulate_batch(live_graphs, [trial])[0]
        solo = self._solo_sim.simulate([clone], trial)
        solo_finish = max(solo.job_finish[new_id], 1e-9)
        replicas_new = {m: list(js) for m, js in replicas.items()}
        replicas_new[model] = sorted(replicas_new[model] + [new_id])
        slow_new = {jid: max(res_new.job_finish[jid]
                             / (solo_finish if jid == new_id
                                else self._solo_finish(jid)), 1.0)
                    for js in replicas_new.values() for jid in js}
        weights_new = {
            m: route_weights(js, {j: self.slos[m].service_rate
                                  / max(slow_new.get(j, 1.0), 1.0)
                                  for j in js}, mode=cfg.routing)
            for m, js in replicas_new.items()}
        p99s_new = fleet_p99s(self.slos, replicas_new, weights_new,
                              self.rates, slow_new)
        viol_now = self.projected_violation_s(
            p99s, self.rates, replicas, self.weights, slowdowns)
        viol_new = self.projected_violation_s(
            p99s_new, self.rates, replicas_new, weights_new, slow_new)
        saved = viol_now - viol_new
        bring_s = clone.n_procs * f.state_bytes_per_proc / f.cluster.nic_bw
        # the remap currency: both sides valued at the fleet's current
        # wait-accrual rate (it cancels — see module docstring)
        wait_rate = self._wait_rate(res)
        gain = saved * wait_rate
        cost = bring_s * f.migration_cost_factor * wait_rate
        committed = saved > 0.0 and gain > cost
        self._record(AutoscaleDecision(
            time=f.now, action="scale_up", model=model, job_id=new_id,
            viol_saved_s=saved, cost_s=cost / max(wait_rate, 1e-12),
            committed=committed))
        if not committed:
            return
        job = f.admit(clone, cores=cores, resident=True)
        job.last_clock = f.now
        # bring-up stall: the replica's state crosses the NIC before it
        # serves — same debt mechanics as a migration / restart
        job.restart_debt_s = bring_s
        f.metrics.counter("sched.scale_ups").inc()
        self.weights = weights_new
        f._reclock_fleet()
        f._maybe_schedule_remap()

    def try_scale_down(self, model: str, p99s: dict, replicas: dict,
                       slowdowns: dict, res) -> None:
        """Drop ``model``'s newest replica if the smaller fleet still
        meets every SLO (dropping frees cores and sheds contention; the
        trial must confirm no violation appears anywhere)."""
        f = self.f
        victim = max(replicas[model])
        survivors = [j.graph for jid, j in f.live.items() if jid != victim]
        res_new = (f._sim.simulate_batch(survivors, [f.placement])[0]
                   if survivors else None)
        replicas_new = {m: [j for j in js if j != victim]
                        for m, js in replicas.items()}
        slow_new = ({jid: max(res_new.job_finish[jid]
                              / self._solo_finish(jid), 1.0)
                     for js in replicas_new.values() for jid in js}
                    if res_new is not None else {})
        weights_new = {
            m: route_weights(js, {j: self.slos[m].service_rate
                                  / max(slow_new.get(j, 1.0), 1.0)
                                  for j in js}, mode=self.cfg.routing)
            for m, js in replicas_new.items()}
        p99s_new = fleet_p99s(self.slos, replicas_new, weights_new,
                              self.rates, slow_new)
        ok = all(p99s_new.get(m, 0.0) <= slo.p99_target_s
                 for m, slo in self.slos.items())
        self._record(AutoscaleDecision(
            time=f.now, action="scale_down", model=model, job_id=victim,
            viol_saved_s=0.0, cost_s=0.0, committed=ok))
        if not ok:
            return
        f.depart(victim, now=f.now)
        self._solo.pop(victim, None)
        f.metrics.counter("sched.scale_downs").inc()
        self.weights = weights_new
        f._drain_pending()
        f._reclock_fleet()
