"""Strategy adapters — the search as a drop-in mapping strategy.

``search:<seed>`` and ``anneal`` obey the exact contract of the one-shot
strategies (``mapping`` module docstring): called as
``strategy(jobs, cluster, tracker=None)``, return a ``Placement``, and
claim the winning cores from the tracker they were given. That makes the
optimizer usable everywhere a strategy name goes today — ``place_jobs``,
``compare_strategies``, ``FleetScheduler`` admission, the benches.
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..core.graphs import AppGraph, ClusterTopology, FreeCoreTracker, Placement
from .optimizer import SearchResult, search_placement


def search_strategy(jobs: Sequence[AppGraph], cluster: ClusterTopology,
                    tracker: Optional[FreeCoreTracker] = None, *,
                    seed="new", anneal: bool = False,
                    **kwargs) -> Placement:
    """Run the batched search and claim the winning cores.

    Keyword arguments pass through to
    :func:`repro_torch.search.optimizer.search_placement` (budget, population,
    rng_seed, objective_scale, backend, device, ...).
    """
    res = search_placement(jobs, cluster, tracker, seed=seed, anneal=anneal,
                           **kwargs)
    _claim(res, jobs, tracker)
    return res.placement


def search_strategy_result(jobs: Sequence[AppGraph], cluster: ClusterTopology,
                           tracker: Optional[FreeCoreTracker] = None, *,
                           seed="new", anneal: bool = False,
                           **kwargs) -> SearchResult:
    """Like :func:`search_strategy` but returns the full
    :class:`SearchResult` (benches want the trajectory and eval count)."""
    res = search_placement(jobs, cluster, tracker, seed=seed, anneal=anneal,
                           **kwargs)
    _claim(res, jobs, tracker)
    return res


def _claim(res: SearchResult, jobs: Sequence[AppGraph],
           tracker: Optional[FreeCoreTracker]) -> None:
    if tracker is None:
        return
    for job in jobs:
        # take_cores raises on a double-take, so a search that ever
        # escaped its free pool fails here instead of corrupting the
        # caller's accounting
        tracker.take_cores(res.placement.assignments[job.job_id])
