"""FleetScheduler facade — event-driven placement under churn.

The paper places a *static* batch once on an empty cluster; this package
turns that machinery into a dynamic scheduler (DESIGN.md §3) split into
layered subsystems (DESIGN.md §14), each owning one concern and holding
a back-reference to this facade:

* ``sched.clock``     — WorkClock: work ledger + departure re-keying.
* ``sched.admission`` — AdmissionController: FIFO / windowed joint batch.
* ``sched.remap``     — RemapEngine: budgeted remap + cross-cell passes.
* ``sched.recovery``  — RecoveryEngine: fault / drain handling (§12).
* ``sched.cells``     — CellFabric: flat or nested placement domains
  (§13); ``cells=1`` aliases cell 0 to the global tracker so the
  sequential path stays byte-identical to the historical scheduler.

Determinism: no wall clock, no unseeded randomness — identical traces
yield identical schedules. Every decision emits a structured trace event
through ``repro_torch.obs`` (§11), and utilisation sampling routes through ONE
hook (:meth:`FleetScheduler._sample_mutation`) fired exactly once per
fleet mutation so :class:`FleetStats` percentiles weight mutations
uniformly.
"""
from __future__ import annotations

import sys
import warnings
from collections import deque
from typing import Callable, Iterable, Optional, Union

import numpy as np

from .. import obs
from ..ckpt.checkpoint import CheckpointCostModel  # noqa: F401
# ^ re-exported: the historical import surface of this module
from ..core.graphs import (AppGraph, ClusterFull, ClusterTopology,
                           FreeCoreTracker, Placement)
from ..core.simulator import SimHandle, resolve_backend, resolve_device
from ..core.workloads import Arrival
from .admission import AdmissionController
from .autoscale import AutoscaleDecision, AutoscaleEngine  # noqa: F401
from .cells import CellFabric, FleetCell
from .clock import SchedJob, WorkClock
from .config import (AdmissionConfig, AutoscaleConfig, CellConfig,  # noqa: F401
                     RecoveryConfig, RemapConfig, SchedulerConfig)
from .events import (ADMIT, ARRIVAL, DEPARTURE, DRAIN, NODE_FAIL,
                     NODE_RECOVER, REMAP, TRAFFIC, Event, EventQueue,
                     stale_event)
from .loads import projected_level_loads, projected_nic_loads  # noqa: F401
# ^ re-exported: the historical import surface of this module
from .recovery import RecoveryEngine
from .stats import FleetStats  # noqa: F401
# ^ re-exported: the historical import surface of this module
from .remap import RemapDecision, RemapEngine  # noqa: F401

MB = 1 << 20

StrategyLike = Union[str, Callable[..., Placement]]


class SchedulerInvariantError(RuntimeError):
    """Core accounting went wrong (leak / double-assignment / drift)."""


def resolve_strategy(strategy: StrategyLike,
                     device=None) -> Callable[..., Placement]:
    """Name -> strategy fn; accepts the fleet strategies and callables.

    The search strategies (``search:*``, ``anneal``) score their
    populations with ``simulate_batch`` on ``device`` (``None``: the
    CUDA card).
    """
    if callable(strategy):
        return strategy
    # new_tpu lives in meshplan (pulls in configs) — import lazily
    from ..core.meshplan import TPU_STRATEGIES, fleet_strategy
    if strategy in TPU_STRATEGIES:
        return fleet_strategy(strategy, device)
    known = sorted(TPU_STRATEGIES)
    raise KeyError(f"unknown strategy {strategy!r}; known: {known}")


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------
class FleetScheduler:
    """Event-driven multi-job scheduler over a shared cluster/fleet.

    A thin facade over the layered subsystems (DESIGN.md §14): it owns
    the shared fleet state — ``tracker`` / ``placement`` / ``live`` /
    ``pending`` / ``events`` / ``metrics`` / ``now`` — plus the two
    primitive mutations :meth:`admit` and :meth:`depart`, and routes
    every event to the owning subsystem (``clock`` / ``admission`` /
    ``remap`` / ``recovery`` / ``fabric``).

    Low-level API (direct, used by property tests): :meth:`admit` /
    :meth:`depart` mutate the fleet immediately and keep the free-core
    accounting consistent. High-level API: :meth:`submit` /
    :meth:`submit_trace` enqueue timestamped arrivals and :meth:`run`
    plays the event loop.
    """

    def __init__(self, cluster: ClusterTopology,
                 strategy: StrategyLike = "new", *,
                 config: Optional[SchedulerConfig] = None,
                 recorder: Optional[obs.Recorder] = None,
                 device=None,
                 **legacy):
        """``config`` groups every knob by owning subsystem (§15).

        The historical flat kwargs (``remap_interval=5.0`` etc.) still
        work as ``**legacy`` through :meth:`SchedulerConfig.from_legacy`
        with a ``DeprecationWarning`` — they build the identical config,
        so seeded runs replay byte-for-byte either way. Mixing ``config``
        with flat kwargs is an error; unknown names raise ``TypeError``
        exactly like the old signature did.

        ``device`` is where every simulation handle scans: ``None`` means
        the CUDA card (the ``kernel`` backend unless the config names
        another) and raises where CUDA is absent; ``"cpu"`` runs on the
        host (the ``segmented`` backend under ``sim_backend="auto"``).
        It is not part of the config, which is a device-free recipe.
        """
        if legacy:
            if config is not None:
                raise TypeError(
                    "pass either config= or legacy flat kwargs, not both "
                    f"(got {sorted(legacy)})")
            warnings.warn(
                "flat FleetScheduler kwargs are deprecated; compose a "
                "SchedulerConfig instead (DESIGN.md §15)",
                DeprecationWarning, stacklevel=2)
            config = SchedulerConfig.from_legacy(**legacy)
        elif config is None:
            config = SchedulerConfig()
        self.config = config
        self.cluster = cluster
        self.device = resolve_device(device)
        self.strategy_name = strategy if isinstance(strategy, str) else getattr(strategy, "__name__", "custom")
        self._strategy = resolve_strategy(strategy, self.device)
        self.tracker = FreeCoreTracker(cluster)
        self.placement = Placement(cluster)
        # the config is a frozen recipe; the facade copies it onto plain
        # mutable attributes (tests steer a running scheduler through
        # them, e.g. ``sched.remap_interval = 5.0``)
        self.remap_interval = config.remap.interval
        self.util_threshold = config.remap.util_threshold
        self.migration_cost_factor = config.remap.migration_cost_factor
        self.max_migrations_per_job = config.remap.max_migrations_per_job
        self.state_bytes_per_proc = config.state_bytes_per_proc
        self.count_scale = config.count_scale
        self.sim_backend = resolve_backend(config.sim_backend, self.device)
        self.remap_candidates = max(1, config.remap.candidates)
        # remap_budget switches the remap pass from fixed reseed trials
        # to the budgeted population search (DESIGN.md §10); the budget
        # caps placements scored per pass
        self.remap_budget = config.remap.budget
        self.remap_population = max(1, config.remap.population)
        self.cross_cell_migration = config.cells.cross_cell_migration
        self.reclock = config.reclock
        count_scale = config.count_scale
        # warm-start simulation handle: every projection below goes through
        # it so per-event cost is delta assembly + scans, not full rebuilds
        self._sim = SimHandle(cluster, count_scale=count_scale,
                              backend=self.sim_backend, device=self.device)
        self._last_res = None     # SimResult for the CURRENT live set +
        # placement, invalidated by every fleet mutation — remap ticks on
        # an unchanged fleet reuse it instead of re-simulating

        self.now = 0.0
        self.live: dict[int, SchedJob] = {}
        self.done: dict[int, SchedJob] = {}
        # FIFO of queued job_ids; deque so the per-event head drain is
        # O(1) instead of list.pop(0)'s O(n) shift. Requeue-restarts
        # append at the tail (same as fresh queued arrivals), batch
        # admission re-queues non-fitting jobs in place, preserving order
        self.pending: deque[int] = deque()
        self.jobs: dict[int, SchedJob] = {}   # every job ever submitted
        self.events = EventQueue()
        self._arrivals_pending = 0    # un-popped ARRIVAL events; counted
        # here because scanning the heap would touch every superseded
        # departure event the re-clock leaves behind (lazy deletion)
        # all utilisation sampling lives in the metrics registry (§11):
        # histogram sched.peak_sim_util, series util.nic / util.level.*,
        # each fed by the ONE per-mutation hook _sample_mutation
        self.metrics = obs.Metrics()
        # trace recorder: the explicit argument wins; otherwise whatever
        # is installed process-wide at event time (NULL no-op default)
        self._recorder = recorder
        # -- layered subsystems (DESIGN.md §14) ----------------------------
        self.clock = WorkClock(self)
        self.recovery = RecoveryEngine(
            self, failure_policy=config.recovery.failure_policy,
            drain_policy=config.recovery.drain_policy,
            ckpt_model=config.recovery.ckpt_model,
            elastic_model_size=config.recovery.elastic_model_size)
        self.admission = AdmissionController(
            self, window=config.admission.window, k=config.admission.k,
            lookahead=config.admission.lookahead,
            rng_seed=config.admission.rng_seed,
            reclock=config.reclock)
        self.remap = RemapEngine(self, rng_seed=config.remap.rng_seed)
        self.autoscale = AutoscaleEngine(self, config.autoscale)
        if self.autoscale.enabled and not config.reclock:
            raise ValueError("autoscale requires reclock=True "
                             "(replica projections re-key the fleet)")
        # incremental node -> resident job-ids index; replaces the
        # _jobs_on_node linear scan over the live set (updated on every
        # admit / evict / depart / remap-commit / shrink, validated by
        # check_invariants against a fresh scan)
        self._node_jobs: list[set] = [set() for _ in range(cluster.n_nodes)]
        # -- fleet cells (DESIGN.md §13) -----------------------------------
        self.fabric = CellFabric(cluster, config.cells.cells,
                                 count_scale=count_scale,
                                 backend=self.sim_backend,
                                 device=self.device,
                                 global_tracker=self.tracker,
                                 global_sim=self._sim,
                                 metrics=self.metrics)
        if self.fabric.n_cells > 1 and not config.reclock:
            raise ValueError("cells > 1 requires reclock=True "
                             "(cell-local re-clocks)")

    # -- back-compat attribute surface (subsystem-owned state) ---------------
    @property
    def recorder(self) -> obs.Recorder:
        """The active trace recorder (NULL no-op when tracing is off)."""
        return self._recorder if self._recorder is not None else obs.current()

    @property
    def _util_samples(self) -> list[float]:
        """Historical attribute: a view into the metrics registry."""
        return self.metrics.histogram("sched.peak_sim_util").samples

    @property
    def decisions(self) -> list[RemapDecision]:
        return self.remap.decisions

    @property
    def monitor(self):
        return self.recovery.monitor

    @property
    def draining(self) -> dict[int, float]:
        return self.recovery.draining

    @property
    def failure_policy(self) -> str:
        return self.recovery.failure_policy

    @property
    def drain_policy(self) -> str:
        return self.recovery.drain_policy

    @property
    def ckpt(self) -> CheckpointCostModel:
        return self.recovery.ckpt

    @property
    def admission_window(self) -> float:
        return self.admission.window

    @property
    def cells(self) -> list[FleetCell]:
        return self.fabric.cells

    @property
    def n_cells(self) -> int:
        return self.fabric.n_cells

    # -- subsystem delegators (kept as methods so tests can subclass or
    #    monkeypatch the historical hook points) -----------------------------
    def _advance_work(self) -> None:
        self.clock.advance()

    def _reclock(self, res=None) -> None:
        self.clock.reclock(res)

    def _reclock_fleet(self) -> None:
        self.clock.reclock_fleet()

    def _drain_pending(self) -> bool:
        return self.admission.drain_pending()

    def _admit_batch(self) -> bool:
        return self.admission.admit_batch()

    def _maybe_schedule_remap(self) -> None:
        self.remap.maybe_schedule()

    def _remap_pass(self) -> None:
        self.remap.run_pass()

    def _remap_search(self, live, res) -> None:
        self.remap.search(live, res)

    def _evacuate(self, node: int) -> None:
        self.recovery.evacuate(node)

    # -- the node->jobs index ------------------------------------------------
    def _index_add(self, jid: int, cores: np.ndarray) -> None:
        for node in np.unique(self.cluster.node_of(cores)):
            self._node_jobs[int(node)].add(jid)

    def _index_remove(self, jid: int, cores: np.ndarray) -> None:
        for node in np.unique(self.cluster.node_of(cores)):
            self._node_jobs[int(node)].discard(jid)

    def _node_cores(self, node: int) -> np.ndarray:
        cpn = self.cluster.cores_per_node
        return np.arange(node * cpn, (node + 1) * cpn, dtype=np.int64)

    def _jobs_on_node(self, node: int) -> list[int]:
        # served by the incremental node->jobs index (validated in
        # check_invariants) — the old per-call scan touched every live
        # job's core array on every fault-path query
        return sorted(self._node_jobs[node])

    # -- low-level fleet mutations (immediate) -------------------------------
    def admit(self, graph: AppGraph, now: Optional[float] = None,
              state_bytes_per_proc: Optional[float] = None, *,
              cores: Optional[np.ndarray] = None,
              cell: Optional[FleetCell] = None,
              resident: bool = False) -> SchedJob:
        """Place one job right now against the fragmented free pool.

        Raises :class:`ClusterFull` (a ``RuntimeError``) if the job does
        not fit — callers that want queueing use :meth:`submit` +
        :meth:`run`. Every engine that tries a placement skips only
        ``ClusterFull``: any other error (a kernel that does not launch,
        no CUDA device) propagates. ``cores`` commits an
        externally chosen placement (the joint admission batch);
        ``cell`` pins the placement to one cell's tracker view;
        ``resident`` marks a serving replica that never departs on its
        own (§15).
        """
        now = self.now if now is None else now
        if graph.n_procs > self.cluster.n_cores:
            raise ValueError(f"job {graph.job_id} needs {graph.n_procs} cores; "
                             f"cluster has {self.cluster.n_cores}")
        if graph.n_procs > self.tracker.total_free():
            raise ClusterFull(f"job {graph.job_id} does not fit "
                               f"({graph.n_procs} > {self.tracker.total_free()} free)")
        job = self.jobs.get(graph.job_id)
        if job is None:
            job = SchedJob(job_id=graph.job_id, graph=graph, arrival=now,
                           state_bytes_per_proc=state_bytes_per_proc
                           if state_bytes_per_proc is not None
                           else self.state_bytes_per_proc,
                           resident=resident)
            self.jobs[job.job_id] = job
        if job.job_id in self.live:
            raise ValueError(f"job {job.job_id} already live")
        if cores is not None:
            # joint admission chose the placement; claim it everywhere
            self.tracker.take_cores(cores)
            self.fabric.claim(cores)
        elif self.fabric.n_cells > 1:
            if cell is None:
                cell = self.fabric.route(graph)
            if cell is not None:
                # in-cell placement: the strategy claims the cell view,
                # mirror into the global tracker and any other
                # overlapping views (the enclosing pod, when nested)
                snap = cell.tracker.snapshot()
                try:
                    local = self._strategy([graph], self.cluster,
                                           cell.tracker)
                except ClusterFull:
                    # fragmented cell — roll back the partial claim the
                    # failed strategy left behind, fall back to global
                    cell.tracker.restore(snap)
                    cell = None
            if cell is not None:
                cores = local.assignments[graph.job_id]
                self.tracker.take_cores(cores)
                self.fabric.claim(cores, settled=cell.tracker)
            else:
                # no single cell fits: place globally (spanning job)
                local = self._strategy([graph], self.cluster, self.tracker)
                cores = local.assignments[graph.job_id]
                self.fabric.claim(cores)
        else:
            local = self._strategy([graph], self.cluster, self.tracker)
            cores = local.assignments[graph.job_id]
        self.placement.assign(job.job_id, cores)
        job.cores = cores
        job.placed_at = now
        self.live[job.job_id] = job
        self._index_add(job.job_id, cores)
        self.fabric.bind(job.job_id, cores, graph)
        self._last_res = None
        killed_at = self.recovery.kill_time.pop(job.job_id, None)
        if killed_at is not None:
            # recovery completes when the restarted job holds cores again
            self.metrics.histogram("fault.mttr").observe(now - killed_at)
        rec = self.recorder
        if rec.enabled:
            rec.instant("admit", ts=now, track="events", job=job.job_id,
                        job_name=graph.name, procs=graph.n_procs,
                        nodes=int(np.unique(self.cluster.node_of(cores)).size),
                        strategy=self.strategy_name)
        return job

    def depart(self, job_id: int, now: Optional[float] = None) -> SchedJob:
        """Release a live job's cores back to the free pool."""
        now = self.now if now is None else now
        job = self.live.pop(job_id, None)
        if job is None:
            raise KeyError(f"job {job_id} is not live")
        cores = self.placement.remove(job_id)
        self.tracker.release_cores(cores)
        self.fabric.release(cores)
        self._index_remove(job_id, cores)
        self.fabric.unbind(job_id, cores, job.graph)
        job.departure = now if job.departure is None else job.departure
        self.done[job_id] = job
        self._last_res = None
        rec = self.recorder
        if rec.enabled:
            rec.instant("depart", ts=now, track="events", job=job_id,
                        msg_wait=job.msg_wait, migrations=job.n_migrations)
            if job.placed_at is not None:
                # the job's whole residency as one span on its own track
                rec.span(f"job:{job_id}", ts=job.placed_at,
                         dur=now - job.placed_at, track=f"job:{job_id:03d}",
                         job=job_id, job_name=job.graph.name,
                         procs=job.graph.n_procs, msg_wait=job.msg_wait,
                         migrations=job.n_migrations)
        return job

    # -- high-level event API ------------------------------------------------
    def submit(self, graph: AppGraph, at: float = 0.0,
               state_bytes_per_proc: Optional[float] = None, *,
               resident: bool = False) -> None:
        """Enqueue a timestamped arrival for :meth:`run`.

        ``resident`` marks a serving replica (§15): it is placed like any
        arrival but never departs on its own — only an autoscale
        drop-replica action or the run horizon ends its residency.
        """
        if graph.n_procs > self.cluster.n_cores:
            raise ValueError(f"job {graph.job_id} needs {graph.n_procs} cores; "
                             f"cluster has {self.cluster.n_cores}")
        if graph.job_id in self.jobs:
            raise ValueError(f"duplicate job_id {graph.job_id}")
        self.jobs[graph.job_id] = SchedJob(
            job_id=graph.job_id, graph=graph, arrival=at,
            state_bytes_per_proc=state_bytes_per_proc
            if state_bytes_per_proc is not None else self.state_bytes_per_proc,
            resident=resident)
        self.events.push(Event(time=at, kind=ARRIVAL, job_id=graph.job_id))
        self._arrivals_pending += 1

    def submit_trace(self, trace: Iterable[Arrival]) -> None:
        for a in trace:
            self.submit(a.graph, at=a.time)

    def submit_faults(self, faults: Iterable) -> None:
        """Enqueue injected node events for :meth:`run` (DESIGN.md §12).

        Accepts anything with ``time`` / ``kind`` / ``node`` (and, for
        DRAIN, ``deadline``) attributes, e.g. ``traces.fault_trace``
        records. Requires ``reclock=True``.
        """
        if not self.reclock:
            raise ValueError("fault injection requires reclock=True "
                             "(recovery re-keys departures)")
        for f in faults:
            if f.kind not in (NODE_FAIL, NODE_RECOVER, DRAIN):
                raise ValueError(f"not a node event kind: {f.kind!r}")
            node = int(f.node)
            if node < 0 or node >= self.cluster.n_nodes:
                raise ValueError(f"node {node} out of range")
            deadline = float(getattr(f, "deadline", 0.0))
            if f.kind == DRAIN and deadline < f.time:
                raise ValueError(f"drain deadline {deadline} before start "
                                 f"{f.time}")
            self.events.push(Event(time=float(f.time), kind=f.kind,
                                   node=node, deadline=deadline))

    def submit_traffic(self, stream) -> None:
        """Enqueue a request stream's traffic-epoch ticks (§15).

        ``stream`` is a ``repro_torch.serve.RequestStream`` (or any object with
        an ``epochs()`` method, or a plain epoch sequence). Each epoch
        becomes one TRAFFIC event driving the autoscale closed loop;
        requires ``AutoscaleConfig(enabled=True, slos=...)``.
        """
        if not self.autoscale.enabled:
            raise ValueError("submit_traffic requires "
                             "AutoscaleConfig(enabled=True) with slos")
        epochs = stream.epochs() if hasattr(stream, "epochs") else list(stream)
        self.autoscale.set_epochs(epochs)
        for k, ep in enumerate(epochs):
            self.events.push(Event(time=ep.time, kind=TRAFFIC, epoch=k))

    def step(self) -> Optional[Event]:
        """Pop and handle ONE event; ``None`` once the queue is drained.

        Exposed so property tests can interleave ``check_invariants()``
        with event processing; :meth:`run` is the plain drain loop.
        """
        if not self.events:
            return None
        ev = self.events.pop()
        if self.reclock and ev.kind == DEPARTURE:
            job = self.live.get(ev.job_id)
            if stale_event(ev.epoch, None if job is None else job.epoch):
                # superseded by a re-key (or already departed): skip
                # before the clock advance — re-clocking leaves dead
                # events in the heap. Stale mode keeps the full path
                # (its rare stale events DID advance the clock).
                return ev
        self.now = max(self.now, ev.time)
        rec = self.recorder
        if rec.enabled:
            rec.set_clock(self.now)
        if self.reclock:
            self.clock.advance()
        if ev.kind == ARRIVAL:
            self._arrivals_pending -= 1
            self.admission.handle_arrival(self.jobs[ev.job_id])
        elif ev.kind == DEPARTURE:
            self._handle_departure(ev)
        elif ev.kind == NODE_FAIL:
            self.recovery.node_fail(ev)
        elif ev.kind == NODE_RECOVER:
            self.recovery.node_recover(ev)
        elif ev.kind == DRAIN:
            self.recovery.drain(ev)
        elif ev.kind == ADMIT:
            self.admission.scheduled = False
            if self.admission.admit_batch():
                self.clock.reclock_fleet()
                self.remap.maybe_schedule()
        elif ev.kind == TRAFFIC:
            self.autoscale.on_traffic(ev)
        elif ev.kind == REMAP:
            self.remap.scheduled = False
            self._remap_pass()
            self.remap.maybe_schedule()
        return ev

    def run(self, until: Optional[float] = None) -> FleetStats:
        """Play all events; returns aggregate fleet statistics.

        ``until`` bounds the run to events at or before that time —
        serving fleets need it because resident replicas never drain the
        queue on their own; when autoscale is enabled it defaults to the
        traffic stream's horizon. Batch runs (``until=None``, autoscale
        off) drain the queue exactly as before.

        With a recorder active, any escaping exception carries the
        flight recorder's event tail as a note / stderr dump.
        """
        if until is None and self.autoscale.enabled:
            until = self.autoscale.horizon or None
        try:
            while True:
                if until is not None:
                    nxt = self.events.peek()
                    if nxt is None or nxt.time > until:
                        break
                if self.step() is None:
                    break
        except Exception as e:
            rec = self.recorder
            if rec.enabled and not isinstance(e, SchedulerInvariantError):
                dump = rec.flight_dump()
                if dump and hasattr(e, "add_note"):      # py3.11+
                    e.add_note(dump)
                elif dump:                               # pragma: no cover
                    print(dump, file=sys.stderr)
            raise
        if until is not None and self.now < until:
            # settle the clock at the bound so resident replicas' work
            # and wait integrals cover the full run window
            self.now = until
            if self.reclock:
                self.clock.advance()
        return self.stats()

    def _handle_departure(self, ev: Event) -> None:
        job = self.live.get(ev.job_id)
        # stale event: the job's departure was re-keyed (re-clock or remap
        # commit bumped its epoch) or the job already departed
        if stale_event(ev.epoch, None if job is None else job.epoch):
            return
        self.depart(ev.job_id, now=self.now)
        # departures free cores — drain the FIFO head while it fits
        placed_any = self.admission.drain_pending()
        if self.reclock:
            # one simulate covers the drained jobs AND the survivors'
            # speed-up now that the departed job's traffic is gone
            self.clock.reclock_fleet()
        if self.recovery.draining \
                and self.recovery.drain_policy == "proactive":
            # freed cores may unblock a stalled evacuation — retry every
            # draining node before its deadline hard-kills the leftovers
            for node in sorted(self.recovery.draining):
                self.recovery.evacuate(node)
        if placed_any:
            # drain-placements change contention like arrivals do — keep
            # the periodic remap tick alive (it previously lapsed here)
            self.remap.maybe_schedule()

    # -- introspection -------------------------------------------------------
    def _live_graphs(self) -> list[AppGraph]:
        return [j.graph for j in self.live.values()]

    def _sample_mutation(self, res) -> None:
        """THE utilisation-sampling hook (DESIGN.md §11).

        Every post-mutation simulate result lands here exactly once and
        nowhere else, so the sampled percentiles weight every fleet
        mutation uniformly regardless of how often remap ticks fire.
        """
        self.metrics.histogram("sched.peak_sim_util").observe(
            res.max_server_utilisation)
        self.metrics.gauge("sched.live_jobs").set(len(self.live), self.now)
        if not self.live:
            return
        levels = projected_level_loads(self._live_graphs(), self.placement,
                                       self.cluster)
        top = self.cluster.net_hierarchy().levels[-1].name
        rec = self.recorder
        for name, d in levels.items():
            util = np.maximum(d["tx"], d["rx"]) / d["bw"]
            self.metrics.series(f"util.level.{name}").append(self.now, util)
            if rec.enabled:
                rec.counter(f"util.level.{name}",
                            {"max": float(util.max()),
                             "mean": float(util.mean())}, ts=self.now)
            if name == top:
                # historical per-node NIC view: TX+RX over nic_bw
                nic = (d["tx"] + d["rx"]) / self.cluster.nic_bw
                self.metrics.series("util.nic").append(self.now, nic)
                if rec.enabled:
                    rec.counter("util.nic",
                                {"max": float(nic.max()),
                                 "mean": float(nic.mean())}, ts=self.now)

    def _invariant(self, msg: str) -> None:
        """Raise :class:`SchedulerInvariantError`, attaching the flight
        recorder's event tail when tracing is on."""
        err = SchedulerInvariantError(msg)
        rec = self.recorder
        if rec.enabled:
            dump = rec.flight_dump()
            if dump and hasattr(err, "add_note"):
                err.add_note(dump)
            elif dump:                               # pragma: no cover
                print(dump, file=sys.stderr)
        raise err

    def check_invariants(self) -> None:
        """free cores == all cores - live cores; live placements intact."""
        used = np.zeros(self.cluster.n_cores, dtype=bool)
        if set(self.placement.assignments) != set(self.live):
            self._invariant(
                f"placement jobs {sorted(self.placement.assignments)} != "
                f"live jobs {sorted(self.live)}")
        for jid, job in self.live.items():
            cores = self.placement.assignments[jid]
            if job.cores is None or not np.array_equal(cores, job.cores):
                self._invariant(f"job {jid} placement drifted")
            if cores.size != job.graph.n_procs:
                self._invariant(f"job {jid} lost processes")
            if cores.min() < 0 or cores.max() >= self.cluster.n_cores:
                self._invariant(f"job {jid} core out of range")
            if used[cores].any():
                self._invariant(f"job {jid} double-assigned core")
            used[cores] = True
        if not np.array_equal(used, self.tracker.used):
            leaked = int((self.tracker.used & ~used).sum())
            phantom = int((used & ~self.tracker.used).sum())
            self._invariant(
                f"tracker drift: {leaked} leaked, {phantom} phantom cores")
        # failure-mode invariants (§12): nothing lives on a dead node, and
        # the offline mask is exactly the dead + draining nodes' cores
        dead = np.flatnonzero(~self.monitor.alive)
        if dead.size:
            for jid, job in self.live.items():
                if np.isin(self.cluster.node_of(job.cores), dead).any():
                    self._invariant(f"job {jid} placed on dead node")
        expect_off = np.zeros(self.cluster.n_cores, dtype=bool)
        for node in dead:
            expect_off[self._node_cores(node)] = True
        for node in self.draining:
            expect_off[self._node_cores(node)] = True
        if not np.array_equal(self.tracker.offline, expect_off):
            drift = int((self.tracker.offline ^ expect_off).sum())
            self._invariant(f"offline mask drift on {drift} cores")
        # the incremental node->jobs index must equal a fresh scan
        expect_idx: list[set] = [set() for _ in range(self.cluster.n_nodes)]
        for jid, job in self.live.items():
            for node in np.unique(self.cluster.node_of(job.cores)):
                expect_idx[int(node)].add(jid)
        if expect_idx != self._node_jobs:
            bad = [n for n in range(self.cluster.n_nodes)
                   if expect_idx[n] != self._node_jobs[n]]
            self._invariant(f"node->jobs index drift on nodes {bad}")
        # cell-fabric tiling + binding invariants (§13/§14) live with
        # the fabric itself
        if self.n_cells > 1:
            self.fabric.check_tiling(self.live, self.tracker,
                                     self._invariant)

    def stats(self) -> FleetStats:
        adm = self.admission
        if adm.hol_since is not None:
            # fold the open HOL-blocked interval into the counter, then
            # re-arm so a mid-run stats() call does not lose the tail
            adm.accrue_hol()
            adm.hol_since = self.now
        finished = [j for j in self.jobs.values() if j.departure is not None]
        placed = [j for j in self.jobs.values() if j.placed_at is not None]
        peak_hist = self.metrics.histogram("sched.peak_sim_util")
        nic_p99 = self.metrics.series("util.nic").percentile(99)
        level_p99 = {}
        sample_counts = {"peak_sim_util": peak_hist.n,
                         "nic_util": self.metrics.series("util.nic").n}
        for name in self.metrics.names():
            if not name.startswith("util.level."):
                continue
            s = self.metrics.series(name)
            level = name[len("util.level."):]
            level_p99[level] = s.percentile(99)
            sample_counts[f"level.{level}"] = s.n
        mttr = self.metrics.histogram("fault.mttr")
        goodput = (max(self.clock.useful_core_s, 0.0)
                   / self.clock.alloc_core_s
                   if self.clock.alloc_core_s > 0.0 else 1.0)
        return FleetStats(
            n_jobs=len(self.jobs),
            makespan=max((j.departure for j in finished), default=0.0),
            total_queue_wait=float(sum(j.queue_wait for j in placed)),
            total_msg_wait=float(sum(j.msg_wait for j in placed)),
            nic_p99_util=nic_p99,
            peak_sim_util=max(peak_hist.samples, default=0.0),
            n_remap_commits=sum(1 for d in self.decisions if d.committed),
            n_remap_rejects=sum(1 for d in self.decisions if not d.committed),
            migrated_bytes=float(sum(j.migrated_bytes for j in self.jobs.values())),
            per_job={j.job_id: {
                "name": j.graph.name,
                "arrival": j.arrival,
                "placed_at": j.placed_at,
                "departure": j.departure,
                "queue_wait": j.queue_wait,
                "msg_wait": j.msg_wait,
                "n_migrations": j.n_migrations,
                "n_restarts": j.n_restarts,
                "lost_work_s": j.lost_work_s,
            } for j in self.jobs.values()},
            level_p99_util=level_p99,
            sample_counts=sample_counts,
            goodput=goodput,
            useful_core_s=self.clock.useful_core_s,
            alloc_core_s=self.clock.alloc_core_s,
            lost_work_s=self.metrics.counter("fault.lost_work_s").total,
            mttr_mean=(sum(mttr.samples) / mttr.n) if mttr.n else 0.0,
            n_node_failures=self.metrics.counter("fault.node_failures").n,
            n_node_recoveries=self.metrics.counter(
                "fault.node_recoveries").n,
            n_restarts=self.metrics.counter("fault.restarts").n,
            n_shrinks=self.metrics.counter("fault.shrinks").n,
            n_drains=self.metrics.counter("fault.drains").n,
            n_evacuations=self.metrics.counter("fault.evacuations").n,
            n_drain_kills=int(self.metrics.counter(
                "fault.drain_kills").total),
            hol_blocked_core_s=self.metrics.counter(
                "sched.hol_blocked").total,
            n_joint_batches=self.metrics.counter("sched.joint_batches").n,
            n_joint_admitted=int(self.metrics.counter(
                "sched.joint_admitted").total),
            n_spanning_jobs=self.metrics.counter("sched.spanning_jobs").n,
            n_cell_escalations=self.metrics.counter(
                "sched.cell_escalations").n,
            n_cross_cell_migrations=self.metrics.counter(
                "sched.cross_cell_migrations").n,
            slo_violation_s=self.autoscale.acct.total_violation_s,
            slo_violation_by_model=dict(self.autoscale.acct.violation_s),
            n_scale_ups=self.metrics.counter("sched.scale_ups").n,
            n_scale_downs=self.metrics.counter("sched.scale_downs").n,
            n_autoscale_rejects=self.metrics.counter(
                "sched.autoscale_rejects").n,
            n_routing_shifts=int(self.metrics.counter(
                "sched.routing_shifts").total),
        )
