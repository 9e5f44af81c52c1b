"""Process -> core mapping strategies.

Implements the paper's Figure-1 algorithm (``new_mapping``), the three
comparison methods it evaluates against — ``blocked``, ``cyclic`` and
``drb`` (dual recursive bipartitioning, the Scotch-style
graph-partitioning mapper) — and ``recursive_bisect``, the
hierarchy-aware recursive bisection over the cluster's explicit
``NetworkHierarchy`` (DESIGN.md §9).

Every strategy has the same signature::

    placement = strategy(jobs, cluster, tracker=None)

where ``jobs`` is a sequence of :class:`~repro_torch.core.graphs.AppGraph` and the
result maps each job's process ranks to global core ids. ``tracker`` is an
optional pre-fragmented :class:`~repro_torch.core.graphs.FreeCoreTracker` — the
online scheduler passes the live fleet state so jobs land
in whatever free cores remain after earlier arrivals/departures; omitting it
keeps the paper's batch semantics (place onto an empty cluster). Strategies
MUTATE the tracker they are given (cores are claimed as they are assigned).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np

from .graphs import (AppGraph, ClusterFull, ClusterTopology, FreeCoreTracker,
                     Placement)

Strategy = Callable[..., Placement]


# ---------------------------------------------------------------------------
# Blocked — fill a node completely, then move to the next (paper sec. 3)
# ---------------------------------------------------------------------------
def blocked(jobs: Sequence[AppGraph], cluster: ClusterTopology,
            tracker: Optional[FreeCoreTracker] = None) -> Placement:
    placement = Placement(cluster)
    tracker = tracker if tracker is not None else FreeCoreTracker(cluster)
    for job in jobs:
        cores = np.empty(job.n_procs, dtype=np.int64)
        node = 0
        for p in range(job.n_procs):
            tries = 0
            while tracker.free_in_node(node) == 0:
                node = (node + 1) % cluster.n_nodes
                tries += 1
                if tries > cluster.n_nodes:
                    raise ClusterFull("cluster full")
            cores[p] = tracker.take_core(node, socket=None)
        placement.assign(job.job_id, cores)
    return placement


# ---------------------------------------------------------------------------
# Cyclic — round-robin processes over nodes (max nodes, min cores per node)
# ---------------------------------------------------------------------------
def cyclic(jobs: Sequence[AppGraph], cluster: ClusterTopology,
           tracker: Optional[FreeCoreTracker] = None) -> Placement:
    placement = Placement(cluster)
    tracker = tracker if tracker is not None else FreeCoreTracker(cluster)
    node = 0
    for job in jobs:
        cores = np.empty(job.n_procs, dtype=np.int64)
        for p in range(job.n_procs):
            tries = 0
            while tracker.free_in_node(node) == 0:
                node = (node + 1) % cluster.n_nodes
                tries += 1
                if tries > cluster.n_nodes:
                    raise ClusterFull("cluster full")
            cores[p] = tracker.take_core(node, socket=None)
            node = (node + 1) % cluster.n_nodes
        placement.assign(job.job_id, cores)
    return placement


# ---------------------------------------------------------------------------
# DRB — dual recursive bipartitioning (Scotch-style)
# ---------------------------------------------------------------------------
def _bisect_greedy(weights: np.ndarray, seed_order: np.ndarray) -> np.ndarray:
    """Split vertices into two balanced halves minimising cut weight.

    Greedy growth from the heaviest vertex + one Kernighan–Lin refinement
    sweep. ``weights`` is the symmetric demand matrix. Returns a boolean
    side mask (True = side A) with |A| = ceil(n/2).
    """
    n = weights.shape[0]
    half = (n + 1) // 2
    side = np.zeros(n, dtype=bool)
    # grow side A from the globally heaviest vertex, always absorbing the
    # unassigned vertex with the strongest connection to A
    start = int(seed_order[0])
    side[start] = True
    conn = weights[start].copy()
    for _ in range(half - 1):
        conn_masked = np.where(side, -np.inf, conn)
        nxt = int(np.argmax(conn_masked))
        if not np.isfinite(conn_masked[nxt]):  # disconnected — take by order
            remaining = [v for v in seed_order if not side[v]]
            nxt = int(remaining[0])
        side[nxt] = True
        conn += weights[nxt]
    # one KL refinement sweep: swap pairs that reduce the cut
    for _ in range(2):
        improved = False
        gain_a = weights[:, ~side].sum(axis=1) - weights[:, side].sum(axis=1)
        gain_b = weights[:, side].sum(axis=1) - weights[:, ~side].sum(axis=1)
        a_idx = np.where(side)[0]
        b_idx = np.where(~side)[0]
        if a_idx.size == 0 or b_idx.size == 0:
            break
        best_a = a_idx[int(np.argmax(gain_a[a_idx]))]
        best_b = b_idx[int(np.argmax(gain_b[b_idx]))]
        gain = gain_a[best_a] + gain_b[best_b] - 2 * weights[best_a, best_b]
        if gain > 0:
            side[best_a] = False
            side[best_b] = True
            improved = True
        if not improved:
            break
    return side


def _drb_assign(procs: np.ndarray, cores: np.ndarray, weights: np.ndarray,
                cluster: ClusterTopology, out: np.ndarray) -> None:
    """Recursively co-bisect process set and core set (paper sec. 3 DRB)."""
    if len(procs) == 0:
        return
    if len(procs) == 1:
        out[procs[0]] = cores[0]
        return
    sub = weights[np.ix_(procs, procs)]
    order = np.argsort(-sub.sum(axis=1), kind="stable")
    side = _bisect_greedy(sub, order)
    procs_a, procs_b = procs[side], procs[~side]
    # split cores along the hardware hierarchy: sort by (node, socket, slot)
    # and cut contiguously so each half is topologically compact
    cores_sorted = np.sort(cores)
    cut = len(procs_a)
    cores_a, cores_b = cores_sorted[:cut], cores_sorted[cut:]
    _drb_assign(procs_a, cores_a, weights, cluster, out)
    _drb_assign(procs_b, cores_b, weights, cluster, out)


def drb(jobs: Sequence[AppGraph], cluster: ClusterTopology,
        tracker: Optional[FreeCoreTracker] = None) -> Placement:
    placement = Placement(cluster)
    tracker = tracker if tracker is not None else FreeCoreTracker(cluster)
    for job in jobs:
        # DRB packs each job into the most compact free region (locality first)
        free = np.where(tracker.free_mask())[0]
        if free.size < job.n_procs:
            raise ClusterFull("cluster full")
        chosen = free[:job.n_procs]  # compact block of free cores
        out = np.full(job.n_procs, -1, dtype=np.int64)
        _drb_assign(np.arange(job.n_procs), chosen, job.sym_demand, cluster, out)
        # claim through the tracker API — writing ``used`` directly would
        # bypass the double-take check that snapshot/restore and the
        # scheduler's invariant audit rely on
        tracker.take_cores(chosen)
        placement.assign(job.job_id, out)
    return placement


# ---------------------------------------------------------------------------
# Recursive bisection over the network hierarchy (DESIGN.md §9)
# ---------------------------------------------------------------------------
def _bisect_sized(weights: np.ndarray, seed_order: np.ndarray,
                  size_a: int) -> np.ndarray:
    """Split vertices into sides of EXACTLY (size_a, n - size_a) vertices,
    minimising the cut weight.

    Same greedy growth + KL refinement as :func:`_bisect_greedy`, but the
    target size follows the capacity of the hardware domain the A side
    will land in instead of being n/2.
    """
    n = weights.shape[0]
    size_a = max(0, min(n, size_a))
    side = np.zeros(n, dtype=bool)
    if size_a == 0:
        return side
    start = int(seed_order[0])
    side[start] = True
    conn = weights[start].copy()
    for _ in range(size_a - 1):
        conn_masked = np.where(side, -np.inf, conn)
        nxt = int(np.argmax(conn_masked))
        if not np.isfinite(conn_masked[nxt]):  # disconnected — take by order
            remaining = [v for v in seed_order if not side[v]]
            nxt = int(remaining[0])
        side[nxt] = True
        conn += weights[nxt]
    for _ in range(2):                         # size-preserving KL sweeps
        gain_a = weights[:, ~side].sum(axis=1) - weights[:, side].sum(axis=1)
        gain_b = weights[:, side].sum(axis=1) - weights[:, ~side].sum(axis=1)
        a_idx = np.where(side)[0]
        b_idx = np.where(~side)[0]
        if a_idx.size == 0 or b_idx.size == 0:
            break
        best_a = a_idx[int(np.argmax(gain_a[a_idx]))]
        best_b = b_idx[int(np.argmax(gain_b[b_idx]))]
        gain = gain_a[best_a] + gain_b[best_b] - 2 * weights[best_a, best_b]
        if gain <= 0:
            break
        side[best_a] = False
        side[best_b] = True
    return side


def _rb_domains(cluster: ClusterTopology) -> list[int]:
    """Descending domain sizes (cores) the mapper recurses through:
    hierarchy levels outermost-first, then node, then socket."""
    sizes = {int(g) for g in cluster.net_hierarchy().group_cores}
    sizes.add(cluster.cores_per_node)
    sizes.add(cluster.cores_per_socket)
    return sorted((s for s in sizes if s > 1), reverse=True)


def _rb_assign(procs: np.ndarray, cores: np.ndarray, weights: np.ndarray,
               sizes: list[int], out: np.ndarray) -> None:
    """Top-down co-partition of processes and free cores.

    At each domain size (pod → rack → node → socket): if the process set
    fits inside the single candidate domain with the most free cores,
    descend into it (locality first — never cross a level that can be
    avoided); otherwise bisect the domains into two capacity-balanced
    halves and split the processes with a cut-minimising sized bisection,
    so the traffic crossing that level's (possibly oversubscribed) links
    is as small as the partitioner can make it.
    """
    if len(procs) == 0:
        return
    if len(procs) == 1:
        out[procs[0]] = cores[0]
        return
    while sizes:
        g = sizes[0]
        groups, counts = np.unique(cores // g, return_counts=True)
        if len(groups) == 1:
            sizes = sizes[1:]
            continue
        fits = counts >= len(procs)
        if fits.any():
            # most-free candidate domain that holds the whole job slice
            best = groups[fits][int(np.argmax(counts[fits]))]
            _rb_assign(procs, cores[cores // g == best], weights,
                       sizes[1:], out)
            return
        # split domains into two capacity-balanced halves (group order =
        # hardware order, so halves stay topologically contiguous)
        half = np.cumsum(counts) <= counts.sum() / 2
        if not half.any():
            half[0] = True
        if half.all():
            half[-1] = False
        left = np.isin(cores // g, groups[half])
        cap_l = int(left.sum())
        cap_r = len(cores) - cap_l
        n = len(procs)
        target = int(round(n * cap_l / (cap_l + cap_r)))
        target = max(n - cap_r, min(cap_l, target))
        sub = weights[np.ix_(procs, procs)]
        order = np.argsort(-sub.sum(axis=1), kind="stable")
        side = _bisect_sized(sub, order, target)
        _rb_assign(procs[side], cores[left], weights, sizes, out)
        _rb_assign(procs[~side], cores[~left], weights, sizes, out)
        return
    out[procs] = cores[:len(procs)]


def recursive_bisect(jobs: Sequence[AppGraph], cluster: ClusterTopology,
                     tracker: Optional[FreeCoreTracker] = None) -> Placement:
    """Hierarchy-aware recursive bisection (DESIGN.md §9).

    Unlike :func:`drb` — which grabs the first compact block of free
    cores and halves it by core id — this mapper walks the explicit
    ``NetworkHierarchy`` top-down: a job that fits inside one pod / rack
    / node never crosses that level, and a job that must split is cut
    where its communication graph is thinnest, level by level. On
    oversubscribed trees that directly minimises the bytes queued at the
    scarce uplinks.
    """
    placement = Placement(cluster)
    tracker = tracker if tracker is not None else FreeCoreTracker(cluster)
    sizes = _rb_domains(cluster)
    for job in jobs:
        free = np.flatnonzero(tracker.free_mask())
        if free.size < job.n_procs:
            raise ClusterFull("cluster full")
        out = np.full(job.n_procs, -1, dtype=np.int64)
        _rb_assign(np.arange(job.n_procs), free, job.sym_demand, sizes, out)
        tracker.take_cores(out)
        placement.assign(job.job_id, out)
    return placement


# ---------------------------------------------------------------------------
# The paper's new mapping strategy (Figure 1)
# ---------------------------------------------------------------------------
def job_threshold(job: AppGraph, tracker: FreeCoreTracker,
                  n_nodes: int) -> int | None:
    """Steps 3.2: decide the per-node process cap for this job.

    * ``Adj_avg <= FreeCores_avg - 1``  ->  no threshold (job fits locally)
    * otherwise eq. 2:  floor( sum_i Adj_pi/Adj_max / num_of_nodes ), min 1.
    """
    if job.adj_avg <= tracker.free_cores_avg() - 1:
        return None
    adj = job.adjacency_counts().astype(float)
    adj_max = max(job.adj_max, 1)
    threshold = math.floor(adj.sum() / adj_max / n_nodes)
    return max(threshold, 1)


def _sorted_jobs(jobs: Sequence[AppGraph]) -> list[AppGraph]:
    """Step 2: most-adjacent jobs first (they need the free cores most)."""
    return sorted(jobs, key=lambda j: (-j.adj_avg, j.job_id))


def _map_one_job(job: AppGraph, tracker: FreeCoreTracker,
                 cluster: ClusterTopology) -> np.ndarray:
    """Steps 3.3–3.9 for a single job."""
    P = job.n_procs
    threshold = job_threshold(job, tracker, cluster.n_nodes)
    cap = threshold if threshold is not None else cluster.cores_per_node

    cores = np.full(P, -1, dtype=np.int64)
    per_node_count = np.zeros(cluster.n_nodes, dtype=np.int64)  # this job only
    cd = job.comm_demand()
    sym = job.sym_demand
    unmapped = set(range(P))

    def node_for_next() -> int:
        """Node with most free cores among nodes still under the job cap."""
        frees = tracker.free_per_node().astype(float)
        frees[per_node_count >= cap] = -np.inf
        frees[tracker.free_per_node() == 0] = -np.inf
        best = int(np.argmax(frees))
        if not np.isfinite(frees[best]):
            # every node is at cap — relax the cap (cluster must absorb the job)
            frees = tracker.free_per_node().astype(float)
            frees[tracker.free_per_node() == 0] = -np.inf
            best = int(np.argmax(frees))
            if not np.isfinite(frees[best]):
                raise ClusterFull("cluster full")
        return best

    def place(proc: int, node: int) -> None:
        cores[proc] = tracker.take_core(node)
        per_node_count[node] += 1
        unmapped.discard(proc)

    while unmapped:
        # 3.4: unmapped process with the highest communication demand
        cand = sorted(unmapped, key=lambda p: (-cd[p], p))
        crnt = cand[0]
        # 3.5/3.6/3.7: node with most free cores (socket chosen inside)
        node = node_for_next()
        place(crnt, node)
        # 3.8: adjacent processes sorted by pairwise demand with crnt
        adjs = [p for p in np.argsort(-sym[crnt], kind="stable")
                if sym[crnt, p] > 0 and p in unmapped]
        # 3.9: co-locate adjacents up to the threshold, then spill to the
        # node with the next-most free cores
        for p in adjs:
            if per_node_count[node] >= cap or tracker.free_in_node(node) == 0:
                node = node_for_next()
            place(int(p), node)
    return cores


def new_mapping(jobs: Sequence[AppGraph], cluster: ClusterTopology,
                tracker: Optional[FreeCoreTracker] = None) -> Placement:
    """The paper's strategy: size classes -> job order -> thresholded placement."""
    placement = Placement(cluster)
    tracker = tracker if tracker is not None else FreeCoreTracker(cluster)
    for size_class in ("large", "medium", "small"):  # steps 1, 4, 6
        pool = [j for j in jobs if j.size_class() == size_class]
        for job in _sorted_jobs(pool):  # steps 2 + 3.1
            placement.assign(job.job_id, _map_one_job(job, tracker, cluster))
    return placement


# the one-shot heuristics — each commits to its first answer. The search
# strategies below use this tuple as their portfolio of initial seeds.
ONE_SHOT_STRATEGIES: tuple[str, ...] = (
    "blocked", "cyclic", "drb", "new", "recursive_bisect")

STRATEGIES: dict[str, Strategy] = {
    "blocked": blocked,
    "cyclic": cyclic,
    "drb": drb,
    "new": new_mapping,
    "recursive_bisect": recursive_bisect,
}


# ---------------------------------------------------------------------------
# Batched placement search (repro_torch.search, DESIGN.md §10) — registered here
# so every STRATEGIES consumer (place_jobs / compare_strategies /
# FleetScheduler / benches) can use the optimizer by name. The wrappers
# import lazily: repro_torch.search itself imports this module.
# ---------------------------------------------------------------------------
def make_search_strategy(seed: str, anneal: bool = False,
                         **defaults) -> Strategy:
    """Strategy-contract wrapper around ``repro_torch.search``: seed with the
    named one-shot strategy, refine with simulate_batch-scored neighbour
    populations (hill-climbing, or simulated annealing when ``anneal``).
    ``defaults`` (budget, population, rng_seed, device, ...) bind search
    knobs onto the fixed ``(jobs, cluster, tracker)`` call signature;
    without a ``device`` the search scores on the CUDA card."""

    def _search(jobs, cluster, tracker=None, **kw):
        from ..search import search_strategy  # lazy — avoids import cycle
        merged = dict(defaults, **kw)
        return search_strategy(jobs, cluster, tracker, seed=seed,
                               anneal=anneal, **merged)

    _search.__name__ = "anneal" if anneal else f"search:{seed}"
    _search.__qualname__ = _search.__name__
    return _search


for _seed in ONE_SHOT_STRATEGIES:
    STRATEGIES[f"search:{_seed}"] = make_search_strategy(_seed)
STRATEGIES["anneal"] = make_search_strategy("new", anneal=True)
