"""Projected link-load views of a live placement (DESIGN.md §9/§11).

Pure functions over (graphs, placement, cluster) — no scheduler state —
used by the facade's per-mutation metrics hook and exported for
benchmarks/tests that want the same per-level utilisation view.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core.graphs import AppGraph, ClusterTopology, Placement


def projected_level_loads(graphs: Sequence[AppGraph], placement: Placement,
                          cluster: ClusterTopology) -> dict[str, dict]:
    """Per-hierarchy-level link loads (bytes/s) implied by current demand.

    For every level of the cluster's :class:`NetworkHierarchy`, sums each
    link's TX and RX load over all live jobs along the simulator's LCA
    path rule (DESIGN.md §9). Returns ``{level: {"tx", "rx", "bw"}}``.
    """
    hier = cluster.net_hierarchy()
    agg: dict[str, dict] = {}
    for g in graphs:
        cores = placement.assignments[g.job_id]
        demand = g.demand
        src, dst = np.nonzero(demand)
        s_core, r_core = cores[src], cores[dst]
        inter = cluster.node_of(s_core) != cluster.node_of(r_core)
        loads = hier.link_loads(s_core, r_core, demand[src, dst],
                                n_cores=cluster.n_cores, active=inter)
        for name, d in loads.items():
            if name not in agg:
                agg[name] = d
            else:
                agg[name] = {"tx": agg[name]["tx"] + d["tx"],
                             "rx": agg[name]["rx"] + d["rx"],
                             "bw": d["bw"]}
    return agg


def projected_nic_loads(graphs: Sequence[AppGraph], placement: Placement,
                        cluster: ClusterTopology) -> np.ndarray:
    """Per-link load (bytes/s, TX+RX) at the hierarchy's OUTERMOST level.

    With the default hierarchies this reproduces the historical view:
    paper mode — every inter-node byte at the per-node NIC; pod mode —
    pod-crossing bytes at the per-node DCN NIC.
    """
    hier = cluster.net_hierarchy()
    top = hier.levels[-1].name
    loads = projected_level_loads(graphs, placement, cluster)
    if top not in loads:
        units = -(-cluster.n_cores // hier.attach[-1])
        return np.zeros(units)
    return loads[top]["tx"] + loads[top]["rx"]
