"""Neighbour moves for the batched placement search (DESIGN.md §10).

A search *state* is the per-job core assignment of the jobs being
optimised plus the pool of free cores those jobs may expand into. Moves
are small, local and composable:

* ``swap``    — exchange the cores of two placed processes (same or,
  when allowed, different jobs); needs no free cores, so it keeps
  working on a 100%-occupied cluster where nothing else can.
* ``migrate`` — move one process onto a free core.
* ``subtree`` — move every process one job has inside one hardware
  group (socket / node / rack / pod, DESIGN.md §9) into the free cores
  of another group at the same level, preserving process order. This
  relocates a whole communication cluster across the tree in one step
  instead of a long random walk of single migrations.

Generation is driven by a caller-owned ``numpy.random.Generator``, so a
fixed seed yields a bit-identical move stream; simulator scores never
feed back into generation except through the accepted state.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..core.graphs import ClusterTopology, Placement

MOVE_KINDS = ("swap", "migrate", "subtree")


@dataclasses.dataclass(frozen=True)
class Move:
    """One applied neighbour move, recorded in the search trajectory."""

    kind: str
    detail: tuple  # deterministic descriptor: job ids, process ranks, cores

    def describe(self) -> tuple:
        return (self.kind,) + self.detail


@dataclasses.dataclass
class SearchState:
    """Assignments + free pool; cheap to fork for candidate populations."""

    cluster: ClusterTopology
    assignments: dict[int, np.ndarray]  # job_id -> (n_procs,) global core ids
    free: np.ndarray                    # (n_cores,) bool, cores the search may use

    @classmethod
    def from_placement(cls, cluster: ClusterTopology, placement: Placement,
                       usable: np.ndarray) -> "SearchState":
        """State whose free pool is ``usable`` minus the placed cores."""
        free = usable.copy()
        for cores in placement.assignments.values():
            free[cores] = False
        return cls(cluster, {j: c.copy() for j, c in
                             placement.assignments.items()}, free)

    def placement(self) -> Placement:
        return Placement(self.cluster,
                         {j: c.copy() for j, c in self.assignments.items()})

    def fork(self, touched: Sequence[int]) -> "SearchState":
        """Copy that shares untouched jobs' arrays (copy-on-write)."""
        assignments = dict(self.assignments)
        for jid in touched:
            assignments[jid] = assignments[jid].copy()
        return SearchState(self.cluster, assignments, self.free.copy())


def domain_sizes(cluster: ClusterTopology) -> list[int]:
    """Descending group sizes (cores) the subtree move operates over —
    the hierarchy levels plus node and socket, same as the recursive
    bisection mapper walks (``mapping._rb_domains``)."""
    from ..core.mapping import _rb_domains

    return _rb_domains(cluster)


def _job_sizes(state: SearchState, jobs: Sequence[int]) -> np.ndarray:
    return np.array([state.assignments[j].size for j in jobs], dtype=np.int64)


def _pick_proc(rng: np.random.Generator, state: SearchState,
               jobs: Sequence[int]) -> tuple[int, int]:
    """Uniformly pick one (job, rank) over all placed processes."""
    sizes = _job_sizes(state, jobs)
    flat = int(rng.integers(int(sizes.sum())))
    bounds = np.cumsum(sizes)
    j = int(np.searchsorted(bounds, flat, side="right"))
    rank = flat - (int(bounds[j - 1]) if j else 0)
    return jobs[j], rank


def propose(rng: np.random.Generator, state: SearchState, *,
            jobs: Optional[Sequence[int]] = None,
            allow_cross_job: bool = True,
            sizes: Optional[Sequence[int]] = None) -> Optional[tuple[Move, SearchState]]:
    """Draw ONE random neighbour of ``state``; ``None`` when the draw
    found no legal move (caller retries — retries still consume the rng
    stream, keeping trajectories deterministic).

    ``jobs`` restricts which jobs may be touched (the scheduler's remap
    search moves one live job at a time); ``allow_cross_job`` gates
    swaps between different jobs (meaningless at placement time cost-wise,
    but two migrations when live state must move).
    """
    jobs = sorted(state.assignments) if jobs is None else sorted(jobs)
    if not jobs:
        return None
    n_free = int(state.free.sum())
    kinds = ["swap"]
    if n_free > 0:
        kinds += ["migrate", "subtree"]
    kind = kinds[int(rng.integers(len(kinds)))]
    if kind == "swap":
        return _propose_swap(rng, state, jobs, allow_cross_job)
    if kind == "migrate":
        return _propose_migrate(rng, state, jobs)
    return _propose_subtree(rng, state, jobs, sizes)


def _propose_swap(rng, state: SearchState, jobs, allow_cross_job):
    total = int(_job_sizes(state, jobs).sum())
    if total < 2:
        return None
    ja, ra = _pick_proc(rng, state, jobs)
    jb, rb = _pick_proc(rng, state, jobs)
    if (ja, ra) == (jb, rb):
        return None
    if not allow_cross_job and ja != jb:
        return None
    ca = int(state.assignments[ja][ra])
    cb = int(state.assignments[jb][rb])
    nxt = state.fork({ja, jb})
    nxt.assignments[ja][ra] = cb
    nxt.assignments[jb][rb] = ca
    return Move("swap", (ja, ra, jb, rb, ca, cb)), nxt


def _propose_migrate(rng, state: SearchState, jobs):
    free_idx = np.flatnonzero(state.free)
    if free_idx.size == 0:
        return None
    j, r = _pick_proc(rng, state, jobs)
    dst = int(free_idx[int(rng.integers(free_idx.size))])
    src = int(state.assignments[j][r])
    nxt = state.fork({j})
    nxt.assignments[j][r] = dst
    nxt.free[dst] = False
    nxt.free[src] = True
    return Move("migrate", (j, r, src, dst)), nxt


def _propose_subtree(rng, state: SearchState, jobs, sizes):
    sizes = domain_sizes(state.cluster) if sizes is None else list(sizes)
    if not sizes:
        return None
    g = int(sizes[int(rng.integers(len(sizes)))])
    j = jobs[int(rng.integers(len(jobs)))]
    cores = state.assignments[j]
    groups = np.unique(cores // g)
    src_group = int(groups[int(rng.integers(groups.size))])
    in_group = cores // g == src_group
    k = int(in_group.sum())
    free_idx = np.flatnonzero(state.free)
    free_counts = np.bincount(free_idx // g,
                              minlength=-(-state.cluster.n_cores // g))
    targets = np.flatnonzero(free_counts >= k)
    targets = targets[targets != src_group]
    if targets.size == 0:
        return None
    dst_group = int(targets[int(rng.integers(targets.size))])
    dst_cores = free_idx[free_idx // g == dst_group][:k]
    ranks = np.flatnonzero(in_group)
    nxt = state.fork({j})
    nxt.assignments[j][ranks] = dst_cores
    nxt.free[dst_cores] = False
    nxt.free[cores[ranks]] = True
    return Move("subtree", (j, g, src_group, dst_group,
                            tuple(int(r) for r in ranks))), nxt


def neighbours(rng: np.random.Generator, state: SearchState, k: int, *,
               jobs: Optional[Sequence[int]] = None,
               allow_cross_job: bool = True,
               sizes: Optional[Sequence[int]] = None,
               max_tries_per: int = 4) -> list[tuple[Move, SearchState]]:
    """Up to ``k`` random neighbours of ``state`` (fewer when draws keep
    failing — e.g. a single 1-process job on a full cluster has none)."""
    out: list[tuple[Move, SearchState]] = []
    tries = 0
    while len(out) < k and tries < k * max_tries_per:
        tries += 1
        cand = propose(rng, state, jobs=jobs, allow_cross_job=allow_cross_job,
                       sizes=sizes)
        if cand is not None:
            out.append(cand)
    return out
