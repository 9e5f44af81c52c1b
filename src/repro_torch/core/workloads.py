"""Workload definitions — paper Tables 2–5 (synthetic) and 6–9 (NPB real).

Synthetic workloads reproduce the tables verbatim. Real workloads encode
NPB communication *signatures* (pattern mix, message length, rate, count)
per benchmark/class, taken from published MPI-traffic characterisations of
NPB 3 (FT/IS are alltoall-dominated; CG/BT/SP/LU are neighbour exchanges;
MG mixes neighbour + small reductions; EP is almost silent). Absolute
fidelity to NPB byte counts is secondary — the workloads must reproduce
the paper's heavy/medium/light spread, which these do.

Arrival traces (``Arrival`` / ``poisson_trace``) extend the static tables
to the dynamic regime the online scheduler targets: the
same job mixes, but arriving over time as a Poisson process instead of
being placed once on an empty cluster. See DESIGN.md §3.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from .graphs import AppGraph

KB = 1 << 10
MB = 1 << 20


# ---------------------------------------------------------------------------
# Synthetic workloads (Tables 2–5)
# ---------------------------------------------------------------------------
def _synt(rows: Sequence[tuple[str, int, float, float, int]]) -> list[AppGraph]:
    jobs = []
    for jid, (pattern, procs, length, rate, count) in enumerate(rows):
        jobs.append(AppGraph.from_pattern(
            name=f"job{jid}_{pattern}", pattern=pattern, n_procs=procs,
            length=length, rate=rate, count=count, job_id=jid))
    return jobs


def synt_workload_1() -> list[AppGraph]:
    """Table 2: 4 jobs x 64 procs, 64KB @ 100 msg/s, 2000 msgs."""
    return _synt([(p, 64, 64 * KB, 100.0, 2000) for p in
                  ("all_to_all", "bcast_scatter", "gather_reduce", "linear")])


def synt_workload_2() -> list[AppGraph]:
    """Table 3: 4 jobs x 64 procs, 2MB @ 10 msg/s, 2000 msgs."""
    return _synt([(p, 64, 2 * MB, 10.0, 2000) for p in
                  ("all_to_all", "bcast_scatter", "gather_reduce", "linear")])


def synt_workload_3() -> list[AppGraph]:
    """Table 4: 8 jobs x 32 procs; 4 @ 2MB + 4 @ 64KB, 10 msg/s, 2000 msgs."""
    patterns = ("all_to_all", "bcast_scatter", "gather_reduce", "linear")
    rows = [(p, 32, 2 * MB, 10.0, 2000) for p in patterns]
    rows += [(p, 32, 64 * KB, 10.0, 2000) for p in patterns]
    return _synt(rows)


def synt_workload_4() -> list[AppGraph]:
    """Table 5: 8 jobs x 24 procs; 4 @ 2MB + 4 @ 64KB, 10 msg/s, 2000 msgs."""
    patterns = ("all_to_all", "bcast_scatter", "gather_reduce", "linear")
    rows = [(p, 24, 2 * MB, 10.0, 2000) for p in patterns]
    rows += [(p, 24, 64 * KB, 10.0, 2000) for p in patterns]
    return _synt(rows)


# ---------------------------------------------------------------------------
# NPB benchmark signatures
# ---------------------------------------------------------------------------
# benchmark -> class -> list of (pattern, length(bytes), rate(msg/s), count)
# Components are summed into one AppGraph (largest length kept per pair).
_NPB: dict[str, dict[str, list[tuple[str, float, float, int]]]] = {
    # IS: bucket-sort key exchange, alltoallv every iteration — heavy A2A
    "IS": {
        "B": [("all_to_all", 512 * KB, 20.0, 220)],
        "C": [("all_to_all", 2 * MB, 10.0, 220)],
    },
    # FT: 3D-FFT transpose — large alltoall each iteration
    "FT": {
        "B": [("all_to_all", 1 * MB, 10.0, 400)],
        "C": [("all_to_all", 4 * MB, 5.0, 400)],
    },
    # CG: sparse matvec — row/col neighbour exchange (linear-ish) + reductions
    "CG": {
        "B": [("linear", 150 * KB, 80.0, 1600), ("gather_reduce", 8.0, 80.0, 1600)],
        "C": [("linear", 300 * KB, 60.0, 1600), ("gather_reduce", 8.0, 60.0, 1600)],
    },
    # MG: multigrid halo exchange, mixed sizes, modest rate
    "MG": {
        "B": [("linear", 64 * KB, 50.0, 800), ("gather_reduce", 1 * KB, 20.0, 200)],
        "C": [("linear", 128 * KB, 40.0, 800), ("gather_reduce", 1 * KB, 20.0, 200)],
    },
    # BT/SP: 2D grid pencil exchanges — neighbour (linear ring) medium msgs
    "BT": {
        "B": [("linear", 40 * KB, 60.0, 1200)],
        "C": [("linear", 160 * KB, 40.0, 1200)],
    },
    "SP": {
        "B": [("linear", 35 * KB, 80.0, 1600)],
        "C": [("linear", 140 * KB, 50.0, 1600)],
    },
    # LU: wavefront pipeline — tiny messages, very high count
    "LU": {
        "B": [("linear", 2 * KB, 400.0, 8000)],
        "C": [("linear", 4 * KB, 300.0, 8000)],
    },
    # EP: embarrassingly parallel — a handful of tiny reductions
    "EP": {
        "B": [("gather_reduce", 256.0, 1.0, 10)],
        "C": [("gather_reduce", 256.0, 1.0, 10)],
    },
}


def npb_job(benchmark: str, klass: str, n_procs: int, job_id: int) -> AppGraph:
    comps = _NPB[benchmark][klass]
    return AppGraph.from_components(
        name=f"job{job_id}_{benchmark}.{klass}", components=comps,
        n_procs=n_procs, job_id=job_id)


def _real(rows: Sequence[tuple[int, str, str]]) -> list[AppGraph]:
    return [npb_job(bench, klass, procs, jid)
            for jid, (procs, bench, klass) in enumerate(rows)]


def real_workload_1() -> list[AppGraph]:
    """Table 6 — IS/FT heavy (communication intensive)."""
    return _real([(25, "SP", "C"), (32, "IS", "C"), (32, "FT", "B"),
                  (16, "FT", "B"), (16, "IS", "C"), (32, "CG", "C"),
                  (8, "IS", "B"), (25, "BT", "C"), (16, "CG", "B")])


def real_workload_2() -> list[AppGraph]:
    """Table 7 — IS/FT/MG/CG mix (communication intensive)."""
    return _real([(8, "IS", "B"), (32, "FT", "B"), (32, "IS", "C"),
                  (32, "MG", "C"), (32, "CG", "C"), (32, "IS", "B"),
                  (32, "MG", "B"), (32, "CG", "B"), (16, "BT", "C")])


def real_workload_3() -> list[AppGraph]:
    """Table 8 — class-B spread (medium communication)."""
    return _real([(25, "BT", "B"), (32, "CG", "B"), (32, "EP", "B"),
                  (32, "FT", "B"), (32, "IS", "B"), (25, "LU", "B"),
                  (32, "MG", "B"), (25, "SP", "B")])


def real_workload_4() -> list[AppGraph]:
    """Table 9 — light communication (EP/MG/CG/SP only)."""
    return _real([(25, "SP", "C"), (32, "CG", "C"), (32, "EP", "C"),
                  (32, "MG", "C")])


# ---------------------------------------------------------------------------
# Rack-oversubscription mix (DESIGN.md §9)
# ---------------------------------------------------------------------------
def rack_oversub_mix() -> list[AppGraph]:
    """Job mix for the oversubscribed-rack hierarchy scenario.

    Sized against the `rack_oversub` cluster (8-core nodes, 4-node
    racks): small jobs fit inside a node or rack, large ones are forced
    across rack uplinks — the scarce, oversubscribed links where the
    mapper's cut placement decides the waiting time. Pattern/length mix
    follows the Table-4 heavy/light split.
    """
    rows = [
        ("all_to_all", 24, 2 * MB, 10.0, 2000),
        ("all_to_all", 12, 64 * KB, 100.0, 2000),
        ("bcast_scatter", 16, 1 * MB, 20.0, 2000),
        ("gather_reduce", 16, 64 * KB, 100.0, 2000),
        ("linear", 48, 2 * MB, 10.0, 2000),
        ("linear", 8, 64 * KB, 100.0, 2000),
    ]
    return _synt(rows)


# ---------------------------------------------------------------------------
# Arrival traces — dynamic job streams for the online scheduler
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Arrival:
    """One timestamped job arrival in a scheduler trace."""

    time: float          # seconds (simulated clock)
    graph: AppGraph


def _respawn(template: AppGraph, job_id: int) -> AppGraph:
    """Fresh AppGraph instance of a template job with a unique id.

    Traffic matrices are never mutated downstream, so they are shared.
    """
    return AppGraph(name=f"{template.name}@{job_id}", L=template.L,
                    lam=template.lam, cnt=template.cnt, job_id=job_id)


def poisson_trace(mix: Sequence[AppGraph], rate: float, n_arrivals: int,
                  seed: int = 0, shuffle: bool = True) -> list[Arrival]:
    """Poisson arrival stream drawn from a job mix.

    ``mix`` supplies the job *templates* (e.g. a Table 2–5 workload); each
    arrival clones one with a fresh ``job_id`` (= arrival index). Inter-
    arrival gaps are Exponential(``rate``) — ``rate`` is jobs/second of
    simulated time. With ``shuffle`` the mix order is randomised per cycle
    (every template appears once per len(mix) arrivals, like the paper's
    tables); without it templates cycle in table order. Deterministic for
    a given seed.
    """
    if not mix:
        raise ValueError("empty job mix")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n_arrivals)
    times = np.cumsum(gaps)
    order: list[int] = []
    while len(order) < n_arrivals:
        cycle = np.arange(len(mix))
        if shuffle:
            rng.shuffle(cycle)
        order.extend(int(c) for c in cycle)
    return [Arrival(time=float(times[k]), graph=_respawn(mix[order[k]], k))
            for k in range(n_arrivals)]


def table_poisson_trace(table: int, rate: float = 0.5, n_arrivals: int = 16,
                        seed: int = 0) -> list[Arrival]:
    """Poisson trace over one of the paper's synthetic tables (2–5)."""
    factories: dict[int, Callable[[], list[AppGraph]]] = {
        2: synt_workload_1, 3: synt_workload_2,
        4: synt_workload_3, 5: synt_workload_4,
    }
    if table not in factories:
        raise ValueError(f"table must be one of {sorted(factories)}")
    return poisson_trace(factories[table](), rate, n_arrivals, seed=seed)


def npb_poisson_trace(rate: float = 0.5, n_arrivals: int = 16,
                      seed: int = 0) -> list[Arrival]:
    """Poisson trace over the Table-6 NPB mix (communication intensive)."""
    return poisson_trace(real_workload_1(), rate, n_arrivals, seed=seed)


SYNTHETIC = {
    "synt_workload_1": synt_workload_1,
    "synt_workload_2": synt_workload_2,
    "synt_workload_3": synt_workload_3,
    "synt_workload_4": synt_workload_4,
}
REAL = {
    "real_workload_1": real_workload_1,
    "real_workload_2": real_workload_2,
    "real_workload_3": real_workload_3,
    "real_workload_4": real_workload_4,
}
ALL_WORKLOADS = {**SYNTHETIC, **REAL}
