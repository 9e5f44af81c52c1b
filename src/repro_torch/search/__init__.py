"""Batched placement search — simulator-in-the-loop mapping (DESIGN.md §10).

Public surface:
  moves      — neighbour generation (swap / migrate / subtree) + SearchState
  optimizer  — search_placement: portfolio seeding, greedy hill-climbing,
               simulated annealing, all scored through simulate_batch
  strategy   — search_strategy: the optimizer wearing the one-shot
               strategy contract (registered as ``search:<seed>`` and
               ``anneal`` in STRATEGIES)
  joint      — joint_candidates: K whole-batch placements for the
               scheduler's window-batched admission (DESIGN.md §13)
"""
from .joint import joint_candidates
from .moves import Move, SearchState, domain_sizes, neighbours, propose
from .optimizer import (DEFAULT_BUDGET, DEFAULT_POPULATION, SearchResult,
                        auto_objective_scale, objective_of, quantize,
                        search_placement)
from .strategy import search_strategy, search_strategy_result

__all__ = [
    "Move", "SearchState", "domain_sizes", "neighbours", "propose",
    "DEFAULT_BUDGET", "DEFAULT_POPULATION", "SearchResult",
    "auto_objective_scale", "objective_of", "quantize", "search_placement",
    "search_strategy", "search_strategy_result",
    "joint_candidates",
]
