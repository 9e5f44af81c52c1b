"""Accelerator-fleet mesh planning with the paper's mapping strategy.

Hierarchy mapping (DESIGN.md §2):

    paper node / socket / core  ->  fleet host / 4-chip group / chip
    paper NIC (1/node)          ->  per-host DCN NIC at the pod boundary
    paper memory channel        ->  intra-pod ICI

The planner treats one sharded job's logical mesh coordinates as the
paper's "processes" (AG from :mod:`repro_torch.core.commgraph` — exact
per-step collective bytes), the fleet as the CTG, runs Blocked / Cyclic /
DRB / NewMapping, and emits:

* a **device permutation** (logical coord i -> physical chip id), and
* static contention metrics: pod-crossing bytes per host NIC (max = the
  contended-queue proxy), ICI bytes — plus full queueing simulation via
  :mod:`repro_torch.core.simulator` on the fleet's topology.

Multi-job placement (the paper's actual scenario — several jobs sharing
a fleet) reuses the identical strategy functions; see :func:`place_jobs`.

Host numpy throughout. The search strategies (``search:*``, ``anneal``)
score their populations with ``simulate_batch`` on ``device`` (``None``:
the CUDA card, which raises where there is none); the one-shot strategies
never touch a device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Sequence

import numpy as np

from ..configs import FLEET, FleetConfig, ModelConfig, ShapeSpec
from .commgraph import appgraph_for
from .graphs import (AppGraph, ClusterFull, ClusterTopology, FreeCoreTracker,
                     Placement)
from .mapping import (ONE_SHOT_STRATEGIES, STRATEGIES, _sorted_jobs,
                      make_search_strategy)


def tpu_topology(n_pods: int = 2, fleet: FleetConfig = FLEET,
                 steps_per_sec: float = 1.0) -> ClusterTopology:
    """The fleet's CTG. One 'node' = one host (8 chips).

    ``steps_per_sec`` is accepted for the reference's signature and unused.
    """
    del steps_per_sec
    return ClusterTopology(
        n_nodes=n_pods * fleet.hosts_per_pod,
        sockets_per_node=2,                       # 4-chip ICI neighbourhoods
        cores_per_socket=4,
        mem_bw=fleet.ici_bw_per_link * 4,         # intra-host ICI aggregate
        cache_bw=fleet.ici_bw_per_link * 4,
        cache_msg_cap=float(1 << 62),             # no cache-size cliff
        nic_bw=fleet.dcn_bw_per_host,             # the contended resource
        switch_latency=1e-6,                      # DCN switch
        numa_remote_penalty=0.0,
        pods=n_pods,
        ici_bw=fleet.ici_bw_per_link * fleet.ici_links_per_chip,
    )


# ---------------------------------------------------------------------------
# Fleet-adapted NewMapping (DESIGN.md §2 — the key hardware adaptation)
# ---------------------------------------------------------------------------
# The paper's cluster routes EVERY inter-node byte through a NIC, so
# spreading heavy communicators across nodes always relieves the NIC. On
# the fleet the fast domain (intra-pod ICI) spans 256 chips and the NIC
# sits at the POD boundary — spreading a job across pods *creates* the
# very traffic the paper wants to relieve. The faithful adaptation keeps
# the paper's two decisions but re-targets them:
#   * "no threshold if the job fits locally"  ->  use the fewest pods that
#     fit (blocked at pod level);
#   * "cap heavy communicators per node at eq.2's threshold"  ->  cap POD-
#     CROSSING endpoints per host at
#         Threshold = ceil( sum_i(w_i) / hosts_per_pod ),  w_i = cd^x_i/max cd^x
#     where cd^x_i is process i's pod-crossing demand — eq. 2 evaluated on
#     the crossing subgraph — and relocate excess crossing processes to
#     under-loaded hosts of the SAME pod (swapping with the lowest-CD
#     non-crossing process, the paper's step-3.3 ordering in reverse).
def _nic_balance_pass(cores: np.ndarray, ag: AppGraph,
                      topo: ClusterTopology) -> np.ndarray:
    demand = ag.sym_demand
    pods = topo.pod_of(cores)
    cross_dem = np.where(pods[:, None] != pods[None, :], demand, 0.0).sum(1)
    crossing = cross_dem > 0
    if not crossing.any():
        return cores
    w = cross_dem[crossing] / cross_dem[crossing].max()
    hosts_per_pod = topo.nodes_per_pod
    threshold = max(int(np.ceil(w.sum() / hosts_per_pod)), 1)

    cores = cores.copy()
    cd = ag.comm_demand()
    for pod in range(topo.pods):
        in_pod = np.flatnonzero((pods == pod))
        if in_pod.size == 0:
            continue
        hosts = topo.node_of(cores[in_pod])
        # per-host crossing counts within this pod
        uniq = np.unique(hosts)
        count = {h: int((crossing[in_pod] & (hosts == h)).sum())
                 for h in uniq}
        over = [h for h in uniq if count[h] > threshold]
        for h in over:
            movers = [p for p in in_pod[(hosts == h) & crossing[in_pod]]]
            movers.sort(key=lambda p: -cross_dem[p])
            excess = movers[threshold:]
            for p in excess:
                # host with fewest crossing procs that has a non-crossing
                # proc to swap with
                cands = sorted((h2 for h2 in uniq if count[h2] < threshold),
                               key=lambda h2: count[h2])
                swapped = False
                for h2 in cands:
                    others = in_pod[(topo.node_of(cores[in_pod]) == h2)
                                    & ~crossing[in_pod]]
                    if others.size == 0:
                        continue
                    q = others[np.argmin(cd[others])]
                    cores[p], cores[q] = cores[q], cores[p]
                    count[h2] += 1
                    count[h] -= 1
                    swapped = True
                    break
                if not swapped:
                    break
    return cores


def new_mapping_tpu(jobs, topo: ClusterTopology,
                    tracker: Optional[FreeCoreTracker] = None) -> Placement:
    """Paper Fig.1 re-targeted to the fleet hierarchy (see block comment).

    ``tracker`` (optional) is a pre-fragmented free-core view — the online
    scheduler passes live fleet state; default is an empty fleet. A job
    that does not fit raises :class:`ClusterFull` (a ``RuntimeError``, as
    the reference raises), so the scheduler's engines queue it or skip the
    trial as they do for every other strategy.
    """
    placement = Placement(topo)
    tracker = tracker if tracker is not None else FreeCoreTracker(topo)
    chips_per_pod = topo.nodes_per_pod * topo.cores_per_node
    for size_class in ("large", "medium", "small"):
        pool = [j for j in jobs if j.size_class() == size_class]
        for job in _sorted_jobs(pool):
            # pod-level blocked: fewest pods that fit, most-free first
            free_mask = tracker.free_mask()
            free_per_pod = np.array([
                int(free_mask[p * chips_per_pod:(p + 1) * chips_per_pod]
                    .sum()) for p in range(topo.pods)])
            order = np.argsort(-free_per_pod, kind="stable")
            chosen: list[int] = []
            need = job.n_procs
            for p in order:
                if need <= 0:
                    break
                take = min(need, int(free_per_pod[p]))
                if take > 0:
                    chosen.append(int(p))
                    need -= take
            if need > 0:
                raise ClusterFull("fleet full")
            # blocked assignment inside the chosen pods (logical order
            # preserved -> TP/DP neighbours stay topologically compact)
            cores = np.empty(job.n_procs, dtype=np.int64)
            free = np.flatnonzero(tracker.free_mask())
            free = free[np.isin(topo.pod_of(free), chosen)]
            cores[:] = free[:job.n_procs]
            # the paper's threshold, applied to pod-crossing endpoints
            cores = _nic_balance_pass(cores, job, topo)
            # claim through the tracker API so a double-take fails here,
            # not later in the scheduler's invariant audit
            tracker.take_cores(cores)
            placement.assign(job.job_id, cores)
    return placement


TPU_STRATEGIES = dict(STRATEGIES, new_tpu=new_mapping_tpu)
# the batched search seeded from the fleet-adapted heuristic (the generic
# search:* / anneal entries arrive via STRATEGIES, DESIGN.md §10)
TPU_STRATEGIES["search:new_tpu"] = make_search_strategy("new_tpu")


def fleet_strategy(name: str, device=None) -> Callable[..., Placement]:
    """``TPU_STRATEGIES[name]`` with ``device`` bound on the search
    strategies (they score on it; ``None`` is the CUDA card); the one-shot
    strategies use no device."""
    fn = TPU_STRATEGIES[name]
    if name in ONE_SHOT_STRATEGIES or name == "new_tpu":
        return fn
    return functools.partial(fn, device=device)


# ---------------------------------------------------------------------------
# Single-job device-order planning
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class MeshPlanResult:
    strategy: str
    perm: np.ndarray               # logical coord index -> physical chip id
    metrics: dict


def chip_metrics(ag: AppGraph, cores: np.ndarray,
                 topo: ClusterTopology) -> dict:
    """Static contention metrics for one job mapped to chips.

    ``level_loads`` reports per-hierarchy-level link pressure (max and
    total bytes/s over that level's TX/RX servers, DESIGN.md §9); the
    flat ``dcn/ici/nic`` keys keep their historical pod-boundary meaning.
    """
    demand = ag.demand                       # bytes/s between logical procs
    src, dst = np.nonzero(demand)
    s_core, r_core = cores[src], cores[dst]
    s_node, r_node = topo.node_of(s_core), topo.node_of(r_core)
    s_pod, r_pod = topo.pod_of(s_core), topo.pod_of(r_core)
    vals = demand[src, dst]
    cross_pod = s_pod != r_pod
    inter_node = (s_node != r_node) & ~cross_pod
    nic_tx = np.zeros(topo.n_nodes)
    np.add.at(nic_tx, s_node[cross_pod], vals[cross_pod])
    nic_rx = np.zeros(topo.n_nodes)
    np.add.at(nic_rx, r_node[cross_pod], vals[cross_pod])
    loads = topo.net_hierarchy().link_loads(
        s_core, r_core, vals, n_cores=topo.n_cores,
        active=s_node != r_node)
    return {
        "dcn_bytes": float(vals[cross_pod].sum()),
        "ici_bytes": float(vals[inter_node].sum()),
        "local_bytes": float(vals[~cross_pod & ~inter_node].sum()),
        "max_nic_load": float(max(nic_tx.max(), nic_rx.max())),
        "mean_nic_load": float((nic_tx.sum() + nic_rx.sum())
                               / (2 * topo.n_nodes)),
        "level_loads": {
            name: {"max": float(max(d["tx"].max(), d["rx"].max())),
                   "total": float(d["tx"].sum()),
                   "utilisation": float(max(d["tx"].max(), d["rx"].max())
                                        / d["bw"])}
            for name, d in loads.items()},
    }


def plan_device_order(cfg: ModelConfig, shape: ShapeSpec,
                      mesh_axes: dict[str, int],
                      topo: Optional[ClusterTopology] = None,
                      strategy: str = "new", device=None) -> MeshPlanResult:
    """Map one job's logical mesh onto the fleet with a named strategy.

    The job must exactly fill the fleet or fit within it. ``perm`` is a
    permutation of chip ids (logical coord i -> physical chip) and nothing
    more: building a device mesh in that order belongs to the launch layer,
    which this package does not hold yet. ``device`` is where a search
    strategy scores.
    """
    n = int(np.prod(list(mesh_axes.values())))
    if topo is None:
        topo = tpu_topology(n_pods=mesh_axes.get("pod", 1))
    assert topo.n_cores >= n, (topo.n_cores, n)
    ag = appgraph_for(cfg, shape, mesh_axes)
    placement = fleet_strategy(strategy, device)([ag], topo)
    cores = placement.assignments[ag.job_id]
    return MeshPlanResult(strategy=strategy, perm=cores,
                          metrics=chip_metrics(ag, cores, topo))


def compare_strategies(cfg: ModelConfig, shape: ShapeSpec,
                       mesh_axes: dict[str, int],
                       topo: Optional[ClusterTopology] = None,
                       strategies: Sequence[str] = ("blocked", "cyclic",
                                                    "drb", "new", "new_tpu",
                                                    "recursive_bisect"),
                       device=None) -> dict:
    return {s: plan_device_order(cfg, shape, mesh_axes, topo, s, device)
            for s in strategies}


# ---------------------------------------------------------------------------
# Multi-job fleet placement (the paper's scenario at fleet scale)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class JobSpec:
    name: str
    cfg: ModelConfig
    shape: ShapeSpec
    mesh_axes: dict[str, int]
    job_id: int = 0

    def appgraph(self, steps_per_sec: float = 1.0) -> AppGraph:
        return appgraph_for(self.cfg, self.shape, self.mesh_axes,
                            job_id=self.job_id, steps_per_sec=steps_per_sec)


def place_jobs(jobs: Sequence[JobSpec], topo: ClusterTopology,
               strategy: str = "new",
               steps_per_sec: float = 1.0,
               placement: Placement | None = None,
               tracker: FreeCoreTracker | None = None,
               device=None,
               ) -> tuple[Placement, list[AppGraph]]:
    """Place a batch of jobs; optionally incrementally on a live fleet.

    Batch mode (default): jobs are (re-)numbered 0..n-1 (``job_id`` is
    set on each :class:`JobSpec`) and placed onto an empty fleet — the
    paper's one-shot scenario.

    Incremental mode: pass the existing ``placement`` (and, optionally, a
    ``tracker`` mirroring it — derived from the placement when omitted).
    New jobs receive ids after the current maximum and are placed into the
    remaining fragmented free cores; existing assignments are untouched.

    ``device`` is where a search strategy scores (``None``: the CUDA card).
    """
    if placement is None:
        placement = Placement(topo)
        next_id = 0
    else:
        next_id = max(placement.assignments, default=-1) + 1
    if tracker is None:
        tracker = FreeCoreTracker.from_placement(placement)
    graphs = []
    for i, j in enumerate(jobs):
        j.job_id = next_id + i
        graphs.append(j.appgraph(steps_per_sec))
    # strategies claim cores as they go and can raise mid-batch (fleet
    # full) — roll the caller's tracker back so it stays in sync with the
    # placement instead of leaking the partial batch's cores
    snap = tracker.snapshot()
    try:
        new_placement = fleet_strategy(strategy, device)(graphs, topo, tracker)
    except Exception:
        tracker.restore(snap)
        raise
    for jid, cores in new_placement.assignments.items():
        placement.assign(jid, cores)
    return placement, graphs


def fleet_nic_load(placement: Placement, graphs: Sequence[AppGraph],
                   topo: ClusterTopology) -> dict:
    """Aggregate per-host NIC load over all jobs (bytes/s, pod-crossing).

    ``level_utilisation`` adds the fleet-wide per-level view: for every
    hierarchy level, the most-loaded link's share of that level's
    bandwidth (DESIGN.md §9).
    """
    nic = np.zeros(topo.n_nodes)
    ici = 0.0
    hier = topo.net_hierarchy()
    agg: dict[str, np.ndarray] = {}
    for g in graphs:
        cores = placement.assignments[g.job_id]
        demand = g.demand
        src, dst = np.nonzero(demand)
        s_core, r_core = cores[src], cores[dst]
        vals = demand[src, dst]
        inter = topo.node_of(s_core) != topo.node_of(r_core)
        cross = topo.pod_of(s_core) != topo.pod_of(r_core)
        ici += float(vals[inter & ~cross].sum())
        np.add.at(nic, topo.node_of(s_core)[cross], vals[cross])
        np.add.at(nic, topo.node_of(r_core)[cross], vals[cross])
        for name, d in hier.link_loads(s_core, r_core, vals,
                                       n_cores=topo.n_cores,
                                       active=inter).items():
            agg[name + "/tx"] = agg.get(name + "/tx", 0.0) + d["tx"]
            agg[name + "/rx"] = agg.get(name + "/rx", 0.0) + d["rx"]
    level_util = {
        lv.name: float(max(np.max(agg[lv.name + "/tx"]),
                           np.max(agg[lv.name + "/rx"])) / lv.bw)
        for lv in hier.levels if lv.name + "/tx" in agg}
    return {"max_nic_load": float(nic.max()),
            "total_dcn_bytes": float(nic.sum() / 2),
            "ici_bytes": float(ici),
            "nic_utilisation": float(nic.max() / topo.nic_bw),
            "level_utilisation": level_util}
