"""Batched placement search — mapping as an optimisation problem.

Every shipped strategy (``blocked`` / ``cyclic`` / ``drb`` / ``new`` /
``recursive_bisect``) commits to its first answer; "Mapping Matters"
(Korndörfer et al., 2020) shows no single one-shot heuristic dominates
across topologies. This module closes the loop: seed from any existing
strategy, generate neighbour populations (``repro_torch.search.moves``), score
whole populations with ``simulate_batch`` — one batched scan on the
torch/kernel backends, the segmented numpy scan on the host — and refine by
greedy hill-climbing or a simulated-annealing schedule (DESIGN.md §10).

Budget semantics: ``budget`` caps the number of *placements scored* by
the simulator (initial seeds included), the honest unit of work — every
candidate costs one Lindley pass over the workload regardless of how it
was generated. The search never returns anything worse than its seed:
the incumbent starts at the seed placement and only improves.

Determinism: one ``numpy.random.Generator`` seeded by ``rng_seed``
drives every draw, and objective scores are quantized to 7 significant
digits before any comparison, so sub-tolerance float noise between
simulator backends (<= 1e-9, DESIGN.md §8) cannot flip an accept
decision — a fixed seed yields a bit-identical trajectory on every
backend.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np

from .. import obs
from ..core.graphs import (AppGraph, ClusterTopology, FreeCoreTracker,
                           Placement)
from ..core.mapping import ONE_SHOT_STRATEGIES, STRATEGIES
from ..core.simulator import resolve_device, simulate_batch
from .moves import SearchState, domain_sizes, neighbours

SeedLike = Union[str, Callable[..., Placement]]

#: default cap on placements scored per search call (acceptance: <= 500)
DEFAULT_BUDGET = 240
DEFAULT_POPULATION = 16
#: adaptive objective resolution — pick count_scale so one evaluation
#: flattens to about this many messages (relative ranking is preserved;
#: the budget buys breadth, not per-eval depth)
DEFAULT_TARGET_MSGS = 20_000


def quantize(x: float) -> float:
    """Round to 7 significant digits — the comparison grain of the search.

    Backend agreement is <= 1e-9 relative (DESIGN.md §8); comparing at
    1e-6 grain makes accept/reject decisions backend-independent.
    """
    return float(f"{x:.6e}")


@dataclasses.dataclass
class SearchResult:
    """Outcome of one search call (DESIGN.md §10)."""

    placement: Placement
    objective: float             # quantized simulated total wait (s)
    seed_objective: float        # quantized objective of the named seed
    seed_name: str
    evaluations: int             # placements scored, seeds included
    accepted: int                # moves accepted into the incumbent
    trajectory: list[tuple]      # (evaluations-so-far, move descriptor, score)
    seeds_scored: dict[str, float]
    objective_scale: float       # count_scale the objective was run at

    @property
    def gain_vs_seed(self) -> float:
        """Fractional improvement over the named seed placement."""
        if self.seed_objective <= 0:
            return 0.0
        return 1.0 - self.objective / self.seed_objective


def _resolve_seed(seed: SeedLike) -> tuple[Callable[..., Placement], str]:
    if callable(seed):
        return seed, getattr(seed, "__name__", "custom")
    if seed.startswith("search:") or seed == "anneal":
        raise ValueError(f"search seed {seed!r} is itself a search strategy")
    if seed in STRATEGIES:
        return STRATEGIES[seed], seed
    known = sorted(ONE_SHOT_STRATEGIES)
    raise KeyError(f"unknown search seed {seed!r}; known: {known} "
                   f"(fleet seeds such as 'new_tpu' live in core.meshplan, "
                   f"which this package does not hold yet)")


def auto_objective_scale(jobs: Sequence[AppGraph],
                         target_msgs: int = DEFAULT_TARGET_MSGS) -> float:
    """The count_scale a search would pick for this job set (DESIGN.md §10):
    small enough that one evaluation flattens to ~``target_msgs`` messages,
    never above 1.0. Benches use it to score one-shot strategies at the
    same resolution the search optimised under."""
    total = sum(int(j.cnt.sum()) for j in jobs)
    if total <= 0:
        return 1.0
    return min(1.0, target_msgs / total)


def _score(jobs, placements, cluster, scale, backend, device) -> list[float]:
    res = simulate_batch(jobs, placements, cluster, count_scale=scale,
                         backend=backend, device=device)
    return [quantize(r.total_wait) for r in res]


def search_placement(jobs: Sequence[AppGraph], cluster: ClusterTopology,
                     tracker: Optional[FreeCoreTracker] = None, *,
                     seed: SeedLike = "new",
                     budget: int = DEFAULT_BUDGET,
                     population: int = DEFAULT_POPULATION,
                     anneal: bool = False,
                     multi_seed: bool = True,
                     rng_seed: int = 0,
                     objective_scale: Optional[float] = None,
                     target_msgs: int = DEFAULT_TARGET_MSGS,
                     backend: str = "auto",
                     device=None,
                     allow_cross_job: bool = True,
                     t0_frac: float = 0.05,
                     t_end_frac: float = 1e-3) -> SearchResult:
    """Optimise the placement of ``jobs`` on the free cores of ``tracker``.

    The named ``seed`` strategy anchors the search: its placement opens
    the incumbent and the result is never worse than it on the simulated
    objective. With ``multi_seed`` (the default) every other one-shot
    strategy that fits joins the initial population — the motivation's
    "best of all strategies per scenario" for a handful of evaluations —
    before neighbour moves refine the winner. ``anneal`` switches the
    refinement from greedy hill-climbing to Boltzmann-weighted population
    annealing on a geometric temperature schedule (DESIGN.md §10); the
    best-so-far state is tracked either way, preserving the never-worse
    guarantee. The caller's ``tracker`` is treated as read-only context
    (seed strategies run against scratch copies); claiming the winning
    cores is the strategy adapter's job (``repro_torch.search.strategy``).
    ``device`` is where ``simulate_batch`` scores the populations
    (``None`` means the CUDA card and raises without one).
    """
    seed_fn, seed_name = _resolve_seed(seed)
    device = resolve_device(device)
    rec = obs.current()
    t0_wall = time.perf_counter() if rec.enabled else 0.0
    if rec.enabled:
        rec.instant("search_begin", cat=obs.CAT_SEARCH, track="search",
                    seed=seed_name, budget=budget, population=population,
                    anneal=anneal, n_jobs=len(jobs))
    # offline cores (dead / draining nodes) are as unusable as occupied ones
    base_used = ((tracker.used | tracker.offline).copy() if tracker is not None
                 else np.zeros(cluster.n_cores, dtype=bool))
    usable = ~base_used
    scale = (objective_scale if objective_scale is not None
             else auto_objective_scale(jobs, target_msgs))
    rng = np.random.default_rng(rng_seed)

    # -- initial population: the named seed + the one-shot portfolio -------
    names = [seed_name]
    fns = [seed_fn]
    if multi_seed:
        for name in ONE_SHOT_STRATEGIES:
            if name != seed_name:
                names.append(name)
                fns.append(STRATEGIES[name])
        # budget counts every placement scored, seeds included — a tiny
        # budget trims the portfolio rather than silently overshooting
        names, fns = names[:max(1, budget)], fns[:max(1, budget)]
    states: list[SearchState] = []
    kept: list[str] = []
    for name, fn in zip(names, fns):
        scratch = FreeCoreTracker(cluster, occupied=base_used)
        try:
            pl = fn(jobs, cluster, scratch)
        except RuntimeError:
            if name == seed_name:
                raise  # the anchor seed must fit — mirrors one-shot behaviour
            continue  # a portfolio member that cannot place this set is skipped
        states.append(SearchState.from_placement(cluster, pl, usable))
        kept.append(name)
    scores = _score(jobs, [s.placement() for s in states], cluster, scale,
                    backend, device)
    evaluations = len(scores)
    seeds_scored = dict(zip(kept, scores))
    seed_objective = scores[0]
    best_i = min(range(len(scores)), key=lambda i: (scores[i], i))
    best, best_score = states[best_i], scores[best_i]
    cur, cur_score = best, best_score
    sizes = domain_sizes(cluster)
    trajectory: list[tuple] = []
    if best_i != 0:
        trajectory.append((evaluations, ("seed", kept[best_i]), best_score))
    if rec.enabled:
        rec.instant("search_seeds", cat=obs.CAT_SEARCH, track="search",
                    n_seeds=len(kept), best_seed=kept[best_i],
                    best_score=best_score, evals=evaluations)

    # -- refinement rounds -------------------------------------------------
    rounds = max(0, (budget - evaluations) // max(population, 1))
    temps = _temperature_schedule(rounds, seed_objective, t0_frac, t_end_frac)
    for rnd in range(rounds):
        base = cur if anneal else best
        cands = neighbours(rng, base, population,
                           allow_cross_job=allow_cross_job, sizes=sizes)
        if not cands:
            break  # no legal move exists (e.g. one 1-process job, full cluster)
        cand_states = [s for _, s in cands]
        cand_scores = _score(jobs, [s.placement() for s in cand_states],
                             cluster, scale, backend, device)
        evaluations += len(cand_scores)
        if anneal:
            pick = _boltzmann_pick(rng, cur_score, cand_scores, temps[rnd])
            if pick is not None:
                cur, cur_score = cand_states[pick], cand_scores[pick]
        else:
            pick = min(range(len(cand_scores)),
                       key=lambda i: (cand_scores[i], i))
            if cand_scores[pick] >= best_score:
                if rec.enabled:
                    rec.instant("search_reject", cat=obs.CAT_SEARCH,
                                track="search", evals=evaluations,
                                best_score=best_score)
                continue
            cur, cur_score = cand_states[pick], cand_scores[pick]
        if cur_score < best_score:
            best, best_score = cur, cur_score
            trajectory.append((evaluations, cands[pick][0].describe(),
                               best_score))
            if rec.enabled:
                rec.instant("search_accept", cat=obs.CAT_SEARCH,
                            track="search", evals=evaluations,
                            move=str(trajectory[-1][1]), score=best_score)
        elif rec.enabled:
            rec.instant("search_reject", cat=obs.CAT_SEARCH, track="search",
                        evals=evaluations, best_score=best_score)

    if rec.enabled:
        wall = time.perf_counter() - t0_wall
        rec.metrics.counter("search.evals").inc(evaluations)
        rec.metrics.counter("search.accepts").inc(len(trajectory))
        rec.metrics.gauge("search.evals_per_s", wall=True).set(
            evaluations / wall if wall > 0 else 0.0)
        rec.instant("search_end", cat=obs.CAT_SEARCH, track="search",
                    evals=evaluations, accepted=len(trajectory),
                    objective=best_score, seed_objective=seed_objective,
                    wall=wall)
    return SearchResult(
        placement=best.placement(), objective=best_score,
        seed_objective=seed_objective, seed_name=seed_name,
        evaluations=evaluations,
        accepted=len(trajectory),
        trajectory=trajectory, seeds_scored=seeds_scored,
        objective_scale=scale)


def _temperature_schedule(rounds: int, seed_objective: float,
                          t0_frac: float, t_end_frac: float) -> np.ndarray:
    """Geometric cooling, scaled to the seed objective so the schedule is
    workload-size invariant: T_0 = t0_frac * seed objective."""
    if rounds <= 0:
        return np.zeros(0)
    t0 = max(t0_frac * max(seed_objective, 1e-12), 1e-12)
    t_end = max(t_end_frac * max(seed_objective, 1e-12), 1e-15)
    return t0 * (t_end / t0) ** (np.arange(rounds) / max(rounds - 1, 1))


def _boltzmann_pick(rng: np.random.Generator, cur_score: float,
                    cand_scores: list[float], temp: float) -> Optional[int]:
    """Sample the next state over {stay, candidates} with Boltzmann
    weights exp(-(score - best)/T); returns ``None`` to stay put.

    Quantized scores in, plain float arithmetic throughout — identical
    draws on every backend for a fixed rng stream.
    """
    s = np.array([cur_score] + list(cand_scores))
    w = np.exp(-(s - s.min()) / max(temp, 1e-300))
    p = w / w.sum()
    r = float(rng.random())
    idx = int(np.searchsorted(np.cumsum(p), r, side="right"))
    idx = min(idx, len(cand_scores))  # guard the r ~ 1.0 edge
    return None if idx == 0 else idx - 1


def objective_of(jobs: Sequence[AppGraph], placement: Placement,
                 cluster: ClusterTopology, *, objective_scale: float,
                 backend: str = "auto", device=None) -> float:
    """Quantized search objective of one placement (for benches/tests)."""
    return _score(jobs, [placement], cluster, objective_scale, backend,
                  resolve_device(device))[0]
