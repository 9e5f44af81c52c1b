"""Serving-fleet closed-loop primitives (DESIGN.md §15).

The scheduler's serving scenario treats live jobs as **model replicas**
serving request streams against per-model p99-latency SLOs. This module
holds the pure-math layer of that loop — request streams, the latency
model and SLO accounting — with **no torch and no scheduler imports**,
so ``repro_torch.sched.autoscale`` can depend on it while the scheduler
package stays importable without the model stack.

The latency model reuses the queueing simulator's Lindley-scan
projection instead of duplicating it: a replica's *slowdown* is its
projected finish time under the current fleet contention divided by its
uncontended (solo) finish — exactly the inflation the simulator's
projected message waits induce. A replica that sustains
``service_rate`` requests/s uncontended serves ``service_rate /
slowdown`` under contention, and its p99 request latency is the M/M/1
sojourn tail ``ln(100) / (mu - lambda)`` for the request rate routed to
it. Per-model p99 is the worst replica's p99 (requests are split by
routing weight, each request lands on one replica).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from ..core.graphs import AppGraph

LN100 = math.log(100.0)


def model_key(name: str) -> str:
    """Template name of a replica graph (clones carry ``name@job_id``)."""
    return name.split("@", 1)[0]


def clone_replica(template: AppGraph, job_id: int) -> AppGraph:
    """Fresh replica AppGraph of a model template with a unique id.

    Traffic matrices are immutable downstream, so they are shared; the
    flat-message cache is NOT — its contents depend on ``job_id`` (the
    simulator's tie-break phases), so a shared cache would poison the
    clone. The dataclass default_factory makes the fresh cache.
    """
    return AppGraph(name=f"{model_key(template.name)}@{job_id}",
                    L=template.L, lam=template.lam, cnt=template.cnt,
                    job_id=job_id)


# ---------------------------------------------------------------------------
# SLOs and traffic
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelSLO:
    """One served model's latency objective and uncontended throughput."""

    model: str           # AppGraph template name, e.g. "qwen3-0.6b:decode_32k"
    p99_target_s: float  # p99 request-latency objective (seconds)
    service_rate: float  # req/s ONE uncontended replica sustains


@dataclasses.dataclass(frozen=True)
class TrafficSpike:
    """A multiplicative burst on one model's offered load."""

    model: str
    start: float
    duration: float
    multiplier: float


@dataclasses.dataclass(frozen=True)
class TrafficEpoch:
    """Offered load per model over ``[time, next epoch)`` (req/s)."""

    time: float
    rates: dict


class RequestStream:
    """Deterministic piecewise-constant offered-load stream.

    The expected rate of each model is ``base * diurnal(t) * spikes(t)``;
    with ``poisson=True`` each epoch's realised rate is a seeded Poisson
    draw of the expected request count over the epoch (the Poisson
    request stream, aggregated to the epoch grid the closed loop ticks
    on). All draws come from one ``default_rng(seed)`` in a fixed order
    (epoch-major, model name order), so a seed pins the whole stream.
    """

    def __init__(self, base_rates: dict, horizon: float, epoch_dt: float, *,
                 diurnal_period: float = 0.0, diurnal_amp: float = 0.0,
                 spikes: Sequence[TrafficSpike] = (),
                 poisson: bool = True, seed: int = 0) -> None:
        if horizon <= 0.0 or epoch_dt <= 0.0:
            raise ValueError("horizon and epoch_dt must be > 0")
        self.base_rates = dict(base_rates)
        self.horizon = float(horizon)
        self.epoch_dt = float(epoch_dt)
        self.diurnal_period = float(diurnal_period)
        self.diurnal_amp = float(diurnal_amp)
        self.spikes = tuple(spikes)
        self.poisson = poisson
        self.seed = seed

    def expected_rate(self, model: str, t: float) -> float:
        rate = self.base_rates.get(model, 0.0)
        if self.diurnal_period > 0.0 and self.diurnal_amp != 0.0:
            rate *= max(0.0, 1.0 + self.diurnal_amp
                        * math.sin(2.0 * math.pi * t / self.diurnal_period))
        for sp in self.spikes:
            if sp.model == model and sp.start <= t < sp.start + sp.duration:
                rate *= sp.multiplier
        return rate

    def epochs(self) -> list[TrafficEpoch]:
        """The epoch grid over ``[0, horizon]``.

        The final epoch lands exactly at ``horizon``: it carries no new
        interval, it is the closing tick that lets the accountant book
        the last interval's violation-seconds.
        """
        n = max(1, int(math.ceil(self.horizon / self.epoch_dt - 1e-9)))
        times = [k * self.epoch_dt for k in range(n)] + [self.horizon]
        rng = np.random.default_rng(self.seed)
        out: list[TrafficEpoch] = []
        for k, t in enumerate(times):
            dt = times[k + 1] - t if k + 1 < len(times) else self.epoch_dt
            rates = {}
            for m in sorted(self.base_rates):
                lam = self.expected_rate(m, t)
                if self.poisson and dt > 0.0:
                    lam = float(rng.poisson(lam * dt)) / dt
                rates[m] = float(lam)
            out.append(TrafficEpoch(time=float(t), rates=rates))
        return out


# ---------------------------------------------------------------------------
# The latency model — simulator slowdown + per-replica M/M/1 queueing term
# ---------------------------------------------------------------------------
def replica_p99(rate: float, service_rate: float, slowdown: float) -> float:
    """p99 request sojourn of one replica (seconds; inf when overloaded).

    ``slowdown`` is the simulator's projected-finish inflation under the
    current fleet contention (>= 1); it divides the replica's capacity,
    which is how the projected message wait enters request latency. The
    sojourn tail of an M/M/1 queue is Exponential(mu - lambda), so the
    99th percentile is ``ln(100) / (mu - lambda)``.
    """
    mu = service_rate / max(slowdown, 1.0)
    if mu <= 0.0 or rate >= mu:
        return math.inf
    return LN100 / (mu - rate)


def route_weights(jids: Sequence[int], caps: dict,
                  mode: str = "capacity") -> dict:
    """Request-routing split over a model's replicas.

    ``uniform`` is the static baseline; ``capacity`` routes in
    proportion to each replica's contended capacity, which is the
    placement-aware action — replicas squeezed by NIC contention
    receive less of the offered load.
    """
    if mode not in ("uniform", "capacity"):
        raise ValueError(f"unknown routing mode {mode!r}; "
                         f"known: ['capacity', 'uniform']")
    if not jids:
        return {}
    if mode == "capacity":
        total = sum(max(caps.get(j, 0.0), 0.0) for j in jids)
        if total > 0.0:
            return {j: max(caps.get(j, 0.0), 0.0) / total for j in jids}
    return {j: 1.0 / len(jids) for j in jids}


def fleet_p99s(slos: dict, replicas: dict, weights: dict, rates: dict,
               slowdowns: dict) -> dict:
    """Per-model p99 latency for the current fleet.

    ``replicas`` maps model -> live replica job-ids, ``weights`` maps
    model -> {job_id: routing fraction}, ``slowdowns`` maps job_id ->
    contended-finish inflation. A model with offered load and no live
    replica is unboundedly violating (inf).
    """
    p99s: dict = {}
    for m, slo in slos.items():
        lam = rates.get(m, 0.0)
        jids = replicas.get(m, [])
        if not jids:
            p99s[m] = math.inf if lam > 0.0 else 0.0
            continue
        w = weights.get(m) or {j: 1.0 / len(jids) for j in jids}
        p99s[m] = max(replica_p99(lam * w.get(j, 0.0), slo.service_rate,
                                  slowdowns.get(j, 1.0)) for j in jids)
    return p99s


# ---------------------------------------------------------------------------
# SLO accounting — violation-seconds integral + span tracking
# ---------------------------------------------------------------------------
class SLOAccountant:
    """Integrates per-model SLO-violation-seconds over traffic epochs.

    The closed loop ticks on the epoch grid; between ticks the p99
    projection is piecewise-constant, so the violation integral is a sum
    of full epoch widths where the projection exceeded the target.
    Contiguous violating intervals are tracked as spans (for trace
    timelines); :meth:`observe` returns the spans that closed at ``t0``
    and :meth:`close` flushes any still open.
    """

    def __init__(self, targets: dict) -> None:
        self.targets = dict(targets)
        self.violation_s = {m: 0.0 for m in self.targets}
        self._open: dict = {}          # model -> violation start time

    def observe(self, t0: float, t1: float,
                p99s: dict) -> tuple[dict, list]:
        """Accrue ``[t0, t1)`` under projection ``p99s``.

        Returns ``(accrued, closed)``: violation-seconds added per model
        and the ``(model, start, end)`` spans that ended at ``t0``.
        """
        dt = max(float(t1) - float(t0), 0.0)
        accrued: dict = {}
        closed: list = []
        for m, target in self.targets.items():
            if p99s.get(m, 0.0) > target:
                self.violation_s[m] += dt
                accrued[m] = dt
                self._open.setdefault(m, float(t0))
            elif m in self._open:
                closed.append((m, self._open.pop(m), float(t0)))
        return accrued, closed

    def close(self, t: float) -> list:
        """Flush all open violation spans at ``t`` (end of stream)."""
        closed = [(m, start, float(t)) for m, start
                  in sorted(self._open.items())]
        self._open.clear()
        return closed

    @property
    def total_violation_s(self) -> float:
        return float(sum(self.violation_s.values()))
