"""Joint-batch placement candidates for window-batched admission.

The admission-in-isolation bug (DESIGN.md §13): scoring each arriving
job alone optimises the arrival's own wait while ignoring the collateral
contention it dumps on the live set — on ``table4_poisson`` that lost
75% message wait to the plain one-shot ``new`` strategy. The fix is a
*joint* candidate generator: K complete placements of the whole arrival
batch, scored downstream against the full live set in one warm
``simulate_batch`` call, so the objective finally sees cross-job
contention at admission time.

Candidates come from three families:

* **portfolio seeds** — each one-shot strategy places the whole batch
  sequentially against the free pool (the strategies already accept a
  live tracker);
* **per-job strategy assignments** — mixed draws where every batch job
  independently picks a one-shot strategy, covering heterogeneous
  batches no single heuristic handles;
* **search moves** — swap / migrate / subtree neighbours over the batch
  jobs only (``repro_torch.search.moves``), seeded from the first portfolio
  candidate. Cross-job swaps are allowed: none of the batch jobs holds
  live state yet, so a swap costs nothing.

Generation is deterministic under the caller's RNG; duplicates are
pruned so the simulate budget is spent on distinct placements.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core.graphs import (AppGraph, ClusterFull, ClusterTopology,
                           FreeCoreTracker)
from .moves import SearchState, neighbours

JointCandidate = dict[int, np.ndarray]    # job_id -> core ids


def _scratch_tracker(cluster: ClusterTopology,
                     free: np.ndarray) -> FreeCoreTracker:
    """A tracker whose free pool is exactly ``free`` (claimed elsewhere)."""
    tracker = FreeCoreTracker(cluster)
    busy = np.flatnonzero(~free)
    if busy.size:
        tracker.take_cores(busy)
    return tracker


def _place_with(strategy, graphs: Sequence[AppGraph],
                cluster: ClusterTopology,
                free: np.ndarray) -> Optional[JointCandidate]:
    tracker = _scratch_tracker(cluster, free)
    try:
        local = strategy(graphs, cluster, tracker)
    except ClusterFull:       # does not fit; any other error is a fault
        return None
    return {g.job_id: local.assignments[g.job_id] for g in graphs}


def _key(cand: JointCandidate) -> tuple:
    return tuple((jid, cand[jid].tobytes()) for jid in sorted(cand))


def joint_candidates(graphs: Sequence[AppGraph], cluster: ClusterTopology,
                     free: np.ndarray, rng: np.random.Generator, k: int,
                     *, n_mixed: int = 4,
                     sizes: Optional[Sequence[int]] = None,
                     extra=None, prefer: str = "new") -> list[JointCandidate]:
    """Up to ``k`` distinct joint placements of ``graphs`` into ``free``.

    ``free`` is the schedulable-core mask the batch may claim (the
    cell's or the cluster's free pool). ``extra`` is an optional
    additional strategy (e.g. the scheduler's configured search
    strategy) seeded into the pool as one more whole-batch candidate.
    Returns at least one candidate whenever the batch fits at all; the
    caller scores the list in a single ``simulate_batch`` against the
    live set and commits the best.

    Candidate ORDER matters downstream: the caller breaks score ties by
    list position, and on an empty or lightly loaded pool every
    placement projects (near-)zero wait — so the ``prefer`` strategy
    leads the list, making the contention-robust mapper (the paper's
    ``new``) the tie winner. ``extra`` sits second: it can win the
    joint score under contention, never mere ties.
    """
    from ..core.mapping import ONE_SHOT_STRATEGIES, STRATEGIES

    graphs = list(graphs)
    out: list[JointCandidate] = []
    seen: set = set()

    def push(cand: Optional[JointCandidate]) -> None:
        if cand is None or len(out) >= k:
            return
        key = _key(cand)
        if key not in seen:
            seen.add(key)
            out.append(cand)

    # 1. portfolio seeds: every one-shot strategy places the whole
    # batch. The preferred (tie-winning) strategy leads the list —
    # ``extra`` comes second so an expensive search strategy can win
    # the joint score under contention but never wins mere ties
    names = sorted(ONE_SHOT_STRATEGIES, key=lambda n: n != prefer)
    push(_place_with(STRATEGIES[names[0]], graphs, cluster, free))
    if extra is not None:
        push(_place_with(extra, graphs, cluster, free))
    for name in names[1:]:
        push(_place_with(STRATEGIES[name], graphs, cluster, free))
    if not out:
        return out            # batch does not fit — caller re-queues
    # 2. mixed per-job strategy assignments (deterministic rng draws)
    names = list(ONE_SHOT_STRATEGIES)
    for _ in range(n_mixed):
        if len(out) >= k or len(graphs) < 2:
            break
        tracker = _scratch_tracker(cluster, free)
        cand: JointCandidate = {}
        for g in graphs:
            strat = STRATEGIES[names[int(rng.integers(len(names)))]]
            try:
                local = strat([g], cluster, tracker)
            except ClusterFull:
                cand = {}
                break
            cand[g.job_id] = local.assignments[g.job_id]
        if cand:
            push(cand)
    # 3. neighbour moves over the batch jobs, seeded from candidate 0
    budget = k - len(out)
    if budget > 0:
        seed = out[0]
        state_free = free.copy()
        for cores in seed.values():
            state_free[cores] = False
        state = SearchState(cluster,
                            {jid: c.copy() for jid, c in seed.items()},
                            state_free)
        batch_ids = sorted(seed)
        for _, nxt in neighbours(rng, state, budget, jobs=batch_ids,
                                 allow_cross_job=True, sizes=sizes):
            push({jid: nxt.assignments[jid] for jid in batch_ids})
    return out
