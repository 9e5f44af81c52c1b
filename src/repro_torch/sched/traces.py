"""Named arrival traces for scheduler benchmarks.

Each trace bundles (cluster topology, arrival stream, scheduler knobs) so
benchmarks and tests run the same scenario by name:

* ``table2_poisson`` … ``table5_poisson`` — Poisson arrivals over the
  paper's Table 2–5 synthetic job mixes on the paper's 16x4x4 cluster.
* ``npb_poisson`` — Poisson arrivals over the Table-6 NPB mix.
* ``serve_fleet`` — a serving fleet: decode/prefill jobs for the
  ``repro_torch.configs`` model zoo arriving Poisson on a 2-pod fleet
  (the ROADMAP's multi-tenant serving scenario). Its cluster comes from
  ``core.meshplan``, which this package does not hold yet: the trace
  raises ``NotImplementedError`` (its job mix, :func:`serve_fleet_mix`,
  builds).
* ``serve_slo`` — resident model replicas under a bursty request stream
  with per-model SLOs (the autoscaler's scenario).
* ``rack_oversub`` / ``fleet64`` / ``fleet1k`` — the oversubscribed-rack
  mix on 32-, 64- and 1,024-node hierarchies.

Fault injection (DESIGN.md §12): :func:`fault_trace` generates a seeded,
deterministic stream of :class:`NodeEvent` records — per-node exponential
MTBF failures with exponential repairs, correlated rack-blast failures,
and scheduled maintenance windows with a drain grace period — to feed
``FleetScheduler.submit_faults``. :func:`reference_fault_trace` is the
committed reference scenario the tests and ``fault_bench`` gate on.
"""
from __future__ import annotations

import dataclasses
import functools
from types import MappingProxyType
from typing import Callable

import numpy as np

from ..core.graphs import AppGraph, ClusterTopology
from ..core.hierarchy import NetLevel, NetworkHierarchy
from ..core.workloads import (Arrival, poisson_trace, rack_oversub_mix,
                              table_poisson_trace, npb_poisson_trace)
from ..serve.fleet import ModelSLO, RequestStream, TrafficSpike, clone_replica
from .events import DRAIN, NODE_FAIL, NODE_RECOVER

MB = 1 << 20


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """A runnable scheduler scenario."""

    name: str
    cluster: ClusterTopology
    arrivals: list[Arrival]
    count_scale: float          # message-count scale for the sim clock
    state_bytes_per_proc: float # migration payload per process


def _paper_cluster() -> ClusterTopology:
    return ClusterTopology()    # 16 nodes x 4 sockets x 4 cores, Table 1 b/w


def table_trace(table: int, rate: float = 0.5, n_arrivals: int = 16,
                seed: int = 0) -> TraceSpec:
    return TraceSpec(
        name=f"table{table}_poisson",
        cluster=_paper_cluster(),
        arrivals=table_poisson_trace(table, rate=rate, n_arrivals=n_arrivals,
                                     seed=seed),
        count_scale=0.02,
        state_bytes_per_proc=64 * MB,
    )


def npb_trace(rate: float = 0.25, n_arrivals: int = 12,
              seed: int = 0) -> TraceSpec:
    return TraceSpec(
        name="npb_poisson",
        cluster=_paper_cluster(),
        arrivals=npb_poisson_trace(rate=rate, n_arrivals=n_arrivals,
                                   seed=seed),
        count_scale=0.02,
        state_bytes_per_proc=64 * MB,
    )


# ---------------------------------------------------------------------------
# Rack-oversubscription trace — deep hierarchy, scarce uplinks (§9)
# ---------------------------------------------------------------------------
def rack_oversub_cluster(oversub: float = 4.0,
                         node_bw: float = 1e9) -> ClusterTopology:
    """32 nodes × 8 cores in 8 racks of 4 nodes, 2 pods of 4 racks.

    Every node has a ``node_bw`` uplink into its rack switch; the rack's
    shared uplink carries ``fan_in × node_bw / oversub`` — ``oversub`` is
    the classic fat-tree oversubscription ratio (1.0 = full bisection).
    The pod spine keeps the rack tier's aggregate (no extra taper), so
    the rack uplink is the scarce resource the mappers fight over.
    """
    rack_bw = 4 * node_bw / oversub
    hier = NetworkHierarchy([
        NetLevel("node", fan_in=8, bw=node_bw, latency=100e-9),
        NetLevel("rack", fan_in=4, bw=rack_bw, latency=300e-9),
        NetLevel("pod", fan_in=4, bw=rack_bw, latency=1e-6),
    ])
    return ClusterTopology(n_nodes=32, sockets_per_node=2,
                           cores_per_socket=4, nic_bw=node_bw,
                           hierarchy=hier)


def rack_oversub_trace(rate: float = 0.5, n_arrivals: int = 16,
                       seed: int = 0, oversub: float = 4.0) -> TraceSpec:
    return TraceSpec(
        name="rack_oversub",
        cluster=rack_oversub_cluster(oversub=oversub),
        arrivals=poisson_trace(rack_oversub_mix(), rate, n_arrivals,
                               seed=seed),
        count_scale=0.02,
        state_bytes_per_proc=64 * MB,
    )


def fleet64_cluster(oversub: float = 4.0,
                    node_bw: float = 1e9) -> ClusterTopology:
    """64 nodes × 8 cores in 16 racks of 4 nodes, 4 pods of 4 racks.

    The ≥64-node fleet the cell-sharded scheduler (DESIGN.md §13) is
    sized for: rack-granular cells hold 4 nodes / 32 cores each, so a
    single rack comfortably fits any job in the rack_oversub mix and
    most admissions stay cell-local.
    """
    rack_bw = 4 * node_bw / oversub
    hier = NetworkHierarchy([
        NetLevel("node", fan_in=8, bw=node_bw, latency=100e-9),
        NetLevel("rack", fan_in=4, bw=rack_bw, latency=300e-9),
        NetLevel("pod", fan_in=4, bw=rack_bw, latency=1e-6),
    ])
    return ClusterTopology(n_nodes=64, sockets_per_node=2,
                           cores_per_socket=4, nic_bw=node_bw,
                           hierarchy=hier)


def fleet64_trace(rate: float = 1.0, n_arrivals: int = 32,
                  seed: int = 0, oversub: float = 4.0) -> TraceSpec:
    return TraceSpec(
        name="fleet64",
        cluster=fleet64_cluster(oversub=oversub),
        arrivals=poisson_trace(rack_oversub_mix(), rate, n_arrivals,
                               seed=seed),
        count_scale=0.02,
        state_bytes_per_proc=64 * MB,
    )


def fleet1k_cluster(oversub: float = 4.0,
                    node_bw: float = 1e9) -> ClusterTopology:
    """1,024 nodes × 8 cores in 256 racks of 4 nodes, 16 pods of 16 racks.

    The 1k-node testbed the nested cell fabric (DESIGN.md §13/§14) is
    sized for: a rack cell holds 4 nodes / 32 cores (any single-rack job
    in the oversub mix fits), a pod owns 16 racks / 512 cores (every
    rack-spanning job fits a pod), so escalation past the pod layer is
    reserved for genuinely fleet-wide couplings.
    """
    rack_bw = 4 * node_bw / oversub
    hier = NetworkHierarchy([
        NetLevel("node", fan_in=8, bw=node_bw, latency=100e-9),
        NetLevel("rack", fan_in=4, bw=rack_bw, latency=300e-9),
        NetLevel("pod", fan_in=16, bw=rack_bw, latency=1e-6),
    ])
    return ClusterTopology(n_nodes=1024, sockets_per_node=2,
                           cores_per_socket=4, nic_bw=node_bw,
                           hierarchy=hier)


def fleet1k_trace(rate: float = 16.0, n_arrivals: int = 2048,
                  seed: int = 0, oversub: float = 4.0) -> TraceSpec:
    """The 1k-node benchmark stream (~100k scheduler events at the
    default size: each of the 2,048 jobs costs an arrival + admission +
    departure plus the superseded departure events its neighbours'
    re-keys leave in the heap). ``sched_bench --quick`` runs a trimmed
    ``n_arrivals`` so the CI gate stays fast; the defaults here are the
    full-scale row."""
    return TraceSpec(
        name="fleet1k",
        cluster=fleet1k_cluster(oversub=oversub),
        arrivals=poisson_trace(rack_oversub_mix(), rate, n_arrivals,
                               seed=seed),
        count_scale=0.02,
        state_bytes_per_proc=64 * MB,
    )


# ---------------------------------------------------------------------------
# Serving-fleet trace — configs/ model jobs on an accelerator fleet
# ---------------------------------------------------------------------------
# (arch, shape, mesh_axes) cells sized so several jobs share a 2-pod fleet.
_SERVE_MIX = (
    ("qwen3-0.6b", "decode_32k", {"data": 4, "model": 4}),
    ("granite-3-2b", "decode_32k", {"data": 4, "model": 8}),
    ("phi4-mini-3.8b", "prefill_32k", {"data": 2, "model": 8}),
    ("qwen2-moe-a2.7b", "decode_32k", {"data": 4, "model": 8}),
    ("yi-6b", "prefill_32k", {"data": 2, "model": 16}),
    ("mamba2-370m", "decode_32k", {"data": 8, "model": 2}),
)


def serve_fleet_mix(steps_per_sec: float = 4.0) -> list[AppGraph]:
    """AppGraph templates for the serving mix (vertices = mesh coords)."""
    from ..configs import get_config, SHAPES
    from ..core.commgraph import appgraph_for

    graphs = []
    for i, (arch, shape, axes) in enumerate(_SERVE_MIX):
        graphs.append(appgraph_for(get_config(arch), SHAPES[shape], axes,
                                   job_id=i, steps_per_sec=steps_per_sec))
    return graphs


def serve_fleet_trace(rate: float = 0.02, n_arrivals: int = 12,
                      seed: int = 0) -> TraceSpec:
    """The serving-fleet scenario: :func:`serve_fleet_mix` arriving
    Poisson on the 2-pod fleet topology of ``core.meshplan``."""
    raise NotImplementedError(
        "the serve_fleet trace runs on core.meshplan's fleet topology "
        "(tpu_topology), and this package does not hold core.meshplan yet")


# ---------------------------------------------------------------------------
# Fault injection — seeded node failures, rack blasts, maintenance drains
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NodeEvent:
    """One injected node-level event for ``FleetScheduler.submit_faults``."""

    time: float
    kind: str          # NODE_FAIL | NODE_RECOVER | DRAIN
    node: int
    deadline: float = 0.0   # DRAIN only: hard-kill time (>= time)


def fault_trace(cluster: ClusterTopology, *, horizon: float,
                node_mtbf: float | None = None, node_mttr: float = 50.0,
                rack_mtbf: float | None = None, rack_size: int = 4,
                n_drains: int = 0, drain_grace: float = 20.0,
                maintenance_s: float = 60.0,
                seed: int = 0) -> list[NodeEvent]:
    """Seeded, deterministic fault stream over ``[0, horizon)``.

    Three independent processes share one ``default_rng(seed)`` stream in
    a fixed generation order (per-node failures in node order, then rack
    blasts, then maintenance windows), so the same seed always yields the
    same event list:

    * **per-node failures** — each node fails with exponential
      inter-failure times of mean ``node_mtbf`` (None disables) and
      repairs with exponential mean ``node_mttr``;
    * **rack blasts** — correlated failures: with mean ``rack_mtbf``
      between blasts (None disables), a uniformly chosen rack of
      ``rack_size`` consecutive nodes fails at once and repairs together
      (one shared repair draw — that correlation is the point);
    * **maintenance windows** — ``n_drains`` DRAIN events at uniform
      times, each on a uniform node with ``deadline = time +
      drain_grace``, and the matching NODE_RECOVER at ``deadline +
      maintenance_s``.

    Overlapping windows are legal (a rack blast can hit an already-dead
    node); the scheduler treats NODE_FAIL on a dead node and NODE_RECOVER
    on a live one as idempotent no-ops, last event wins.
    """
    rng = np.random.default_rng(seed)
    out: list[NodeEvent] = []
    if node_mtbf is not None:
        for node in range(cluster.n_nodes):
            t = float(rng.exponential(node_mtbf))
            while t < horizon:
                repair = float(rng.exponential(node_mttr))
                out.append(NodeEvent(time=t, kind=NODE_FAIL, node=node))
                out.append(NodeEvent(time=t + repair, kind=NODE_RECOVER,
                                     node=node))
                t += repair + float(rng.exponential(node_mtbf))
    if rack_mtbf is not None:
        n_racks = max(1, cluster.n_nodes // rack_size)
        t = float(rng.exponential(rack_mtbf))
        while t < horizon:
            rack = int(rng.integers(n_racks))
            repair = float(rng.exponential(node_mttr))
            for node in range(rack * rack_size,
                              min((rack + 1) * rack_size, cluster.n_nodes)):
                out.append(NodeEvent(time=t, kind=NODE_FAIL, node=node))
                out.append(NodeEvent(time=t + repair, kind=NODE_RECOVER,
                                     node=node))
            t += repair + float(rng.exponential(rack_mtbf))
    for _ in range(n_drains):
        t = float(rng.uniform(0.0, horizon))
        node = int(rng.integers(cluster.n_nodes))
        deadline = t + drain_grace
        out.append(NodeEvent(time=t, kind=DRAIN, node=node,
                             deadline=deadline))
        out.append(NodeEvent(time=deadline + maintenance_s,
                             kind=NODE_RECOVER, node=node))
    out.sort(key=lambda e: (e.time, e.node, e.kind))
    return out


def reference_fault_trace(cluster: ClusterTopology,
                          horizon: float = 45.0) -> list[NodeEvent]:
    """THE committed reference fault scenario (tests + fault_bench gates).

    Sized for the paper's 16-node cluster over a table-trace run (the
    default ``table4_poisson`` workload finishes around t=48, so the
    default horizon keeps the faults inside the busy window): a handful
    of per-node failures, a rack blast, and two maintenance drains
    pinned to nodes/times where that workload keeps jobs resident — so
    the kill drain policy demonstrably loses work at the deadline while
    the proactive policy has free cores to evacuate into. Changing these
    constants invalidates the baselines in ``benchmarks/baselines.json``.
    """
    events = fault_trace(cluster, horizon=horizon,
                         node_mtbf=horizon * 4, node_mttr=horizon / 5,
                         rack_mtbf=horizon, rack_size=4,
                         n_drains=0, seed=1234)
    maintenance = horizon / 4
    for start, node, deadline in ((horizon / 11.25, 3, horizon / 6.9),
                                  (horizon / 4.8, 4, horizon / 3.75)):
        events.append(NodeEvent(time=start, kind=DRAIN, node=node,
                                deadline=deadline))
        events.append(NodeEvent(time=deadline + maintenance,
                                kind=NODE_RECOVER, node=node))
    events.sort(key=lambda e: (e.time, e.node, e.kind))
    return events


# ---------------------------------------------------------------------------
# Serving-under-SLOs trace — the autoscale closed loop's scenario (§15)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ServeTraceSpec(TraceSpec):
    """A serving scenario: resident replicas + a request stream + SLOs.

    ``arrivals`` is empty — the workload is the offered request load,
    not batch jobs. Runners submit every graph in ``replicas`` as a
    resident job at t=0, hand ``stream`` to
    ``FleetScheduler.submit_traffic``, and configure the autoscaler
    with ``slos``.
    """

    replicas: tuple = ()     # AppGraph replicas resident from t=0
    slos: tuple = ()         # ModelSLO per served model
    stream: RequestStream = None


# two models with opposite mesh shapes fight for the scarce rack uplinks;
# 16 procs each so two replicas of both fill a quarter of the fleet
_SERVE_SLO_MIX = (
    ("qwen3-0.6b", "decode_32k", {"data": 4, "model": 4}),
    ("mamba2-370m", "decode_32k", {"data": 8, "model": 2}),
)


def serve_slo_trace(seed: int = 0, horizon: float = 240.0,
                    epoch_dt: float = 4.0, n_replicas: int = 2,
                    oversub: float = 4.0) -> ServeTraceSpec:
    """Bursty serving scenario on the oversubscribed-rack cluster.

    Diurnal swell over the whole horizon plus a 3x spike on the qwen
    model through the middle of it: at spike peak the initial
    ``n_replicas`` are overloaded outright, and because the first racks
    are already occupied, replicas added by the autoscaler spill onto
    racks whose uplinks the other model's replicas contend for — the
    placement-aware routing has real asymmetry to exploit.
    """
    from ..configs import get_config, SHAPES
    from ..core.commgraph import appgraph_for

    replicas: list[AppGraph] = []
    slos: list[ModelSLO] = []
    base_rates: dict = {}
    jid = 0
    for i, (arch, shape, axes) in enumerate(_SERVE_SLO_MIX):
        template = appgraph_for(get_config(arch), SHAPES[shape], axes,
                                job_id=0, steps_per_sec=4.0)
        for _ in range(n_replicas):
            replicas.append(clone_replica(template, jid))
            jid += 1
        slos.append(ModelSLO(model=template.name, p99_target_s=0.5,
                             service_rate=100.0))
        base_rates[template.name] = 60.0 if i == 0 else 40.0
    spike = TrafficSpike(model=slos[0].model, start=0.4 * horizon,
                         duration=0.25 * horizon, multiplier=3.0)
    stream = RequestStream(base_rates, horizon, epoch_dt,
                           diurnal_period=horizon, diurnal_amp=0.3,
                           spikes=(spike,), seed=seed)
    return ServeTraceSpec(
        name="serve_slo",
        cluster=rack_oversub_cluster(oversub=oversub),
        arrivals=[],
        count_scale=1.0,            # serve graphs carry per-step counts
        state_bytes_per_proc=64 * MB,
        replicas=tuple(replicas),
        slos=tuple(slos),
        stream=stream,
    )


# ---------------------------------------------------------------------------
# The trace registry
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, Callable[..., TraceSpec]] = {
    "table2_poisson": functools.partial(table_trace, 2),
    "table3_poisson": functools.partial(table_trace, 3),
    "table4_poisson": functools.partial(table_trace, 4),
    "table5_poisson": functools.partial(table_trace, 5),
    "npb_poisson": npb_trace,
    "serve_fleet": serve_fleet_trace,
    "serve_slo": serve_slo_trace,
    "rack_oversub": rack_oversub_trace,
    "fleet64": fleet64_trace,
    "fleet1k": fleet1k_trace,
}

# read-only view kept for the historical import surface (callers used to
# reach into a bare module-level dict); new code goes through get_trace /
# trace_names
TRACES = MappingProxyType(_REGISTRY)


def trace_names() -> list[str]:
    """Sorted names of every registered trace."""
    return sorted(_REGISTRY)


def get_trace(name: str, **kwargs) -> TraceSpec:
    """Build a registered trace by name.

    Raises ``KeyError`` listing the known names (the same error contract
    as :func:`repro_torch.sched.scheduler.resolve_strategy`).
    """
    try:
        make = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown trace {name!r}; "
                       f"known: {trace_names()}") from None
    return make(**kwargs)
