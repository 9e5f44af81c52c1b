"""Derive the paper's Application Graph for a sharded model job.

The paper builds AG edges from MPI message traces (size x rate). For a
sharded model job the traffic is *structured*: it is exactly the per-step
collective inventory implied by (arch config x input shape x sharding
plan). This module enumerates that inventory analytically and expands it
into chip-to-chip traffic matrices (ring schedules for AG/AR/RS — what
a collective library runs — and pairwise exchange for all-to-all), producing an
:class:`~repro_torch.core.graphs.AppGraph` whose vertices are mesh coordinates.

Byte counts are per training/serve STEP; ``steps_per_sec`` converts to
the paper's rate units.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..configs import ModelConfig, ShapeSpec
from .graphs import AppGraph

BF16 = 2


@dataclasses.dataclass(frozen=True)
class Collective:
    kind: str            # all_reduce | all_gather | reduce_scatter | all_to_all
    axis: str            # mesh axis name ('data' includes 'pod' when present)
    bytes_per_chip: float  # payload each participating chip contributes
    count_per_step: int  # how many times per step (e.g. per layer)
    tag: str = ""        # provenance for reports


def job_collectives(cfg: ModelConfig, shape: ShapeSpec,
                    dp: int, tp: int) -> list[Collective]:
    """Analytic per-step collective inventory for one (arch x shape).

    Baseline plan semantics (parallel/sharding.py): DP over data axes,
    TP/EP over 'model', sequence-parallel residuals for train.
    """
    out: list[Collective] = []
    b_local = max(shape.global_batch // dp, 1)
    d = cfg.d_model
    L = cfg.n_layers

    if shape.kind == "train":
        tokens_local = b_local * shape.seq_len
        act = tokens_local * d * BF16
        # sequence-parallel TP: AG + RS around each of the 2 sub-blocks,
        # forward and backward -> 8 ring collectives per layer.
        n_attn = (cfg.n_attn_layers() if cfg.family == "hybrid"
                  else (L if cfg.family != "ssm" else 0))
        n_block = L + n_attn if cfg.family == "hybrid" else L
        if tp > 1:
            out.append(Collective("all_gather", "model", act, 4 * n_block,
                                  "tp-activations-fwd"))
            out.append(Collective("reduce_scatter", "model", act, 4 * n_block,
                                  "tp-activations-bwd"))
        # MoE expert-parallel all-to-all (fwd + bwd): top_k routed copies
        if cfg.moe is not None and cfg.moe.n_experts % tp == 0 and tp > 1:
            a2a = tokens_local * cfg.moe.top_k * d * BF16
            out.append(Collective("all_to_all", "model", a2a, 2 * L,
                                  "ep-dispatch-combine"))
        # DP gradient exchange: reduce-scatter grads + all-gather params
        # (ZeRO-1), ring volume == one all-reduce of the model-shard bytes.
        if dp > 1:
            shard_bytes = cfg.param_count() * BF16 / tp
            out.append(Collective("all_reduce", "data", shard_bytes, 1,
                                  "dp-grad-exchange"))
    elif shape.kind == "prefill":
        tokens_local = b_local * shape.seq_len
        act = tokens_local * d * BF16
        if tp > 1:
            out.append(Collective("all_gather", "model", act, 2 * L,
                                  "tp-activations"))
            out.append(Collective("reduce_scatter", "model", act, 2 * L,
                                  "tp-activations"))
        if cfg.moe is not None and cfg.moe.n_experts % tp == 0 and tp > 1:
            out.append(Collective("all_to_all", "model",
                                  tokens_local * cfg.moe.top_k * d * BF16, L,
                                  "ep-dispatch-combine"))
    else:  # decode: one token per slot
        act = b_local * d * BF16
        if tp > 1:
            out.append(Collective("all_reduce", "model", act, 2 * L,
                                  "tp-partial-sums"))
        if cfg.moe is not None and cfg.moe.n_experts % tp == 0 and tp > 1:
            out.append(Collective("all_to_all", "model",
                                  b_local * cfg.moe.top_k * d * BF16, L,
                                  "ep-dispatch-combine"))
    return out


# ---------------------------------------------------------------------------
# Expand collectives into a chip-to-chip AppGraph
# ---------------------------------------------------------------------------
def _ring_edges(members: np.ndarray, payload: float, count: int,
                L: np.ndarray, lam: np.ndarray, cnt: np.ndarray,
                steps_per_sec: float, factor: float) -> None:
    """Bidirectional-ring schedule: each member sends factor*payload to +1."""
    n = members.size
    if n < 2:
        return
    per_msg = factor * payload
    for i in range(n):
        src, dst = members[i], members[(i + 1) % n]
        L[src, dst] = max(L[src, dst], per_msg)
        lam[src, dst] += count * steps_per_sec
        cnt[src, dst] += count


def _a2a_edges(members: np.ndarray, payload: float, count: int,
               L: np.ndarray, lam: np.ndarray, cnt: np.ndarray,
               steps_per_sec: float) -> None:
    n = members.size
    if n < 2:
        return
    per_msg = payload / n
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            src, dst = members[i], members[j]
            L[src, dst] = max(L[src, dst], per_msg)
            lam[src, dst] += count * steps_per_sec
            cnt[src, dst] += count


def traffic_appgraph(name: str, collectives: Sequence[Collective],
                     mesh_axes: dict[str, int], job_id: int = 0,
                     steps_per_sec: float = 1.0) -> AppGraph:
    """Vertices = logical mesh coordinates in row-major order.

    'data' groups include the 'pod' axis when present (DP spans pods).
    """
    names = list(mesh_axes)
    sizes = [mesh_axes[a] for a in names]
    n = int(np.prod(sizes))
    coords = np.indices(sizes).reshape(len(sizes), -1)   # (naxes, n)
    L = np.zeros((n, n))
    lam = np.zeros((n, n))
    cnt = np.zeros((n, n), dtype=np.int64)

    def groups_over(axis_names: list[str]) -> list[np.ndarray]:
        other = [i for i, a in enumerate(names) if a not in axis_names]
        key = np.zeros(n, dtype=np.int64)
        for i in other:
            key = key * sizes[i] + coords[i]
        order = np.argsort(key, kind="stable")
        boundaries = np.flatnonzero(np.diff(key[order])) + 1
        return np.split(order, boundaries)

    for c in collectives:
        if c.axis == "data":
            axes = [a for a in ("pod", "data") if a in names]
        else:
            axes = [c.axis]
        factor = {"all_reduce": 2.0, "all_gather": 1.0,
                  "reduce_scatter": 1.0}.get(c.kind)
        for members in groups_over(axes):
            k = members.size
            if k < 2:
                continue
            if c.kind == "all_to_all":
                _a2a_edges(members, c.bytes_per_chip, c.count_per_step,
                           L, lam, cnt, steps_per_sec)
            else:
                _ring_edges(members, c.bytes_per_chip, c.count_per_step,
                            L, lam, cnt, steps_per_sec,
                            factor * (k - 1) / k)
    return AppGraph(name=name, L=L, lam=lam, cnt=cnt, job_id=job_id)


def appgraph_for(cfg: ModelConfig, shape: ShapeSpec,
                 mesh_axes: dict[str, int], job_id: int = 0,
                 steps_per_sec: float = 1.0) -> AppGraph:
    dp = int(np.prod([mesh_axes.get(a, 1) for a in ("pod", "data")]))
    tp = mesh_axes.get("model", 1)
    cols = job_collectives(cfg, shape, dp, tp)
    return traffic_appgraph(f"{cfg.arch_id}:{shape.name}", cols, mesh_axes,
                            job_id=job_id, steps_per_sec=steps_per_sec)


def total_collective_bytes(collectives: Sequence[Collective],
                           mesh_axes: dict[str, int]) -> float:
    """Wire bytes per chip per step (ring-schedule accounting)."""
    total = 0.0
    for c in collectives:
        if c.axis == "data":
            k = int(np.prod([mesh_axes.get(a, 1) for a in ("pod", "data")]))
        else:
            k = mesh_axes.get(c.axis, 1)
        if k < 2:
            continue
        factor = {"all_reduce": 2.0, "all_gather": 1.0,
                  "reduce_scatter": 1.0, "all_to_all": 1.0}[c.kind]
        total += factor * (k - 1) / k * c.bytes_per_chip * c.count_per_step
    return total
