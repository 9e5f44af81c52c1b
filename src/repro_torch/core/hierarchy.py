"""Explicit multi-level network hierarchy (DESIGN.md §9).

The paper's cluster has exactly one shared inter-node channel (the NIC);
the TPU-fleet extension bolted a second one on (intra-pod ICI vs
pod-crossing DCN). Real machines have a full level hierarchy —
core→chip→node→rack→pod — whose per-level fan-in and bandwidth decide
mapping quality (arXiv:2005.10413, arXiv:0810.2150). This module makes
that hierarchy explicit and replaces both hard-coded cases.

Model
-----
A :class:`NetworkHierarchy` is an ordered list of :class:`NetLevel`s,
innermost first. Level ``k`` defines a DOMAIN of ``prod(fan_in[:k+1])``
cores; a message *crosses* level ``k`` when sender and receiver sit in
different level-``k`` groups. Crossings nest: crossing level ``k``
implies crossing every level below it, so the crossed set of a message
is always a prefix ``{0..lca}`` where ``lca`` is the outermost crossed
level — the lowest-common-ancestor rule.

Each level owns full-duplex contention-server pairs: one TX and one RX
FIFO server per *attach unit* (by default the level's own groups — the
group's uplink toward its parent; ``attach_cores`` overrides the
granularity, e.g. a per-host DCN NIC attached at the pod level). A
message queues, in order, at the TX server of every crossed level going
up (innermost→outermost), pays the LCA level's ``latency`` once at the
apex, then queues at the RX server of every crossed level coming down.

``express=True`` marks a level whose links bypass the fabric below
(per-host DCN NICs do not ride the ICI to leave the pod): when an
express level is crossed, all crossed levels below it drop out of the
path. The two-level default hierarchy synthesized from a
``ClusterTopology`` uses exactly this to reproduce the previous
hard-coded model bit-for-bit: ``node`` (ICI or NIC uplink) + express
``pod`` (per-node DCN) — see :func:`default_hierarchy`.

Intra-node traffic never enters the hierarchy — it rides the paper's
cache/memory channels unchanged (`repro_torch.core.simulator`).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class NetLevel:
    """One level of the network hierarchy (innermost-first ordering).

    ``fan_in``  — child units per group at this level; the innermost
                  level's children are cores, every other level's are the
                  previous level's groups.
    ``bw``      — per-link bandwidth (bytes/s) of this level's servers.
    ``latency`` — apex latency (s), paid once by messages whose LCA is
                  this level, between the last TX and first RX hop.
    ``express`` — links attach directly to the attach unit and bypass all
                  lower levels (e.g. a per-host DCN NIC at the pod
                  boundary).
    ``attach_cores`` — cores per server-owning unit; ``None`` means the
                  level's own group size (one TX/RX pair per group).
    """

    name: str
    fan_in: int
    bw: float
    latency: float = 0.0
    express: bool = False
    attach_cores: int | None = None

    def __post_init__(self):
        if self.fan_in < 1:
            raise ValueError(f"level {self.name!r}: fan_in must be >= 1")
        if self.bw <= 0:
            raise ValueError(f"level {self.name!r}: bw must be > 0")


@dataclasses.dataclass(frozen=True)
class Hop:
    """One queueing stage of the hierarchy path, at PAIR granularity.

    ``server``/``service`` are aligned with the routed pair arrays and
    only valid where ``mask``. ``latency`` is non-zero only on the first
    RX hop of each pair (the apex crossing).
    """

    level: int
    name: str
    direction: str          # "tx" | "rx"
    mask: np.ndarray        # (P,) bool
    server: np.ndarray      # (P,) int64 — globally disjoint id space
    service: np.ndarray     # (P,) float64 seconds
    latency: np.ndarray     # (P,) float64 seconds added on arrival


class NetworkHierarchy:
    """Validated level stack + vectorised LCA routing."""

    def __init__(self, levels: Sequence[NetLevel]):
        if not levels:
            raise ValueError("hierarchy needs at least one level")
        self.levels = tuple(levels)
        sizes = []
        size = 1
        for lv in self.levels:
            size *= lv.fan_in
            sizes.append(size)
        self.group_cores = tuple(sizes)      # cores per level-k group
        self.attach = tuple(
            lv.attach_cores if lv.attach_cores is not None else sizes[k]
            for k, lv in enumerate(self.levels))
        for k, a in enumerate(self.attach):
            if a < 1 or sizes[k] % a:
                raise ValueError(
                    f"level {self.levels[k].name!r}: attach_cores={a} must "
                    f"divide the group size {sizes[k]}")

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def __repr__(self) -> str:
        inner = ", ".join(
            f"{lv.name}(x{lv.fan_in}, {lv.bw:.3g}B/s"
            f"{', express' if lv.express else ''})" for lv in self.levels)
        return f"NetworkHierarchy[{inner}]"

    def describe(self) -> list[dict]:
        return [{"name": lv.name, "fan_in": lv.fan_in, "bw": lv.bw,
                 "latency": lv.latency, "express": lv.express,
                 "group_cores": self.group_cores[k],
                 "attach_cores": self.attach[k]}
                for k, lv in enumerate(self.levels)]

    # -- routing -------------------------------------------------------------
    def crossings(self, s_core: np.ndarray, r_core: np.ndarray) -> np.ndarray:
        """(L, P) bool — does pair p cross level k? (prefix property holds)"""
        s_core = np.asarray(s_core)
        r_core = np.asarray(r_core)
        return np.stack([s_core // g != r_core // g
                         for g in self.group_cores])

    def lca_level(self, s_core: np.ndarray, r_core: np.ndarray) -> np.ndarray:
        """Outermost crossed level per pair (-1 = same innermost group)."""
        cross = self.crossings(s_core, r_core)
        return cross.sum(axis=0) - 1

    def path_mask(self, s_core: np.ndarray, r_core: np.ndarray,
                  active: np.ndarray | None = None):
        """(in_path, lca) under the LCA + express path rule.

        ``in_path`` is (L, P) bool — pair p queues at level k's servers;
        ``lca`` is (P,) — the outermost crossed level (-1: none). This is
        THE routing invariant: :meth:`pair_hops` (what the simulator
        queues) and :meth:`link_loads` (what the scheduler/planner
        project) must never disagree, so both derive from here.
        """
        cross = self.crossings(s_core, r_core)
        if active is not None:
            cross &= np.asarray(active, dtype=bool)
        # express rule: the outermost crossed express level truncates the
        # path below it (its links bypass the lower fabric entirely)
        start = np.zeros(np.shape(s_core), dtype=np.int64)
        for k, lv in enumerate(self.levels):
            if lv.express:
                start = np.where(cross[k], k, start)
        in_path = cross & (start[None, :] <= np.arange(
            self.n_levels)[:, None])
        lca = cross.sum(axis=0) - 1            # valid where any crossing
        return in_path, lca

    def pair_hops(self, s_core: np.ndarray, r_core: np.ndarray,
                  size: np.ndarray, n_cores: int,
                  active: np.ndarray | None = None,
                  server_base: int = 0) -> list[Hop]:
        """Ordered queueing stages for routed pairs (the LCA path rule).

        ``active`` restricts routing to a subset of pairs (the simulator
        passes its inter-node mask). Server ids start at ``server_base``
        and each (level, direction) occupies its own disjoint block sized
        from ``n_cores``, so one segmented scan can cover any mix of hops
        and ids are stable across placements of the same cluster.

        Returns hops in topological order: TX innermost→outermost, then
        RX outermost→innermost. Empty hops are dropped.
        """
        s_core = np.asarray(s_core)
        r_core = np.asarray(r_core)
        size = np.asarray(size, dtype=np.float64)
        path, lca = self.path_mask(s_core, r_core, active)
        n_units = [int(-(-int(n_cores) // a)) for a in self.attach]

        base = int(server_base)
        tx_hops: list[Hop] = []
        rx_hops: list[Hop] = []
        for k, lv in enumerate(self.levels):
            in_path = path[k]
            for direction, core in (("tx", s_core), ("rx", r_core)):
                server = np.zeros(core.shape, dtype=np.int64)
                service = np.zeros(core.shape, dtype=np.float64)
                latency = np.zeros(core.shape, dtype=np.float64)
                if in_path.any():
                    server[in_path] = base + core[in_path] // self.attach[k]
                    service[in_path] = size[in_path] / lv.bw
                    if direction == "rx" and lv.latency:
                        apex = in_path & (lca == k)
                        latency[apex] = lv.latency
                base += n_units[k]
                hop = Hop(level=k, name=lv.name, direction=direction,
                          mask=in_path, server=server, service=service,
                          latency=latency)
                (tx_hops if direction == "tx" else rx_hops).append(hop)
        hops = [h for h in tx_hops + rx_hops[::-1] if h.mask.any()]
        return hops

    def link_loads(self, s_core: np.ndarray, r_core: np.ndarray,
                   vals: np.ndarray, n_cores: int,
                   active: np.ndarray | None = None) -> dict[str, dict]:
        """Static per-level link loads implied by a traffic matrix.

        ``vals`` is the per-edge demand (bytes/s). Follows the same LCA +
        express path rule as :meth:`pair_hops`: an edge loads every level
        it queues at. Returns ``{level name: {"tx", "rx", "bw"}}`` with
        per-attach-unit TX/RX arrays.
        """
        s_core = np.asarray(s_core)
        r_core = np.asarray(r_core)
        vals = np.asarray(vals, dtype=np.float64)
        path, _ = self.path_mask(s_core, r_core, active)
        out: dict[str, dict] = {}
        for k, lv in enumerate(self.levels):
            in_path = path[k]
            units = int(-(-int(n_cores) // self.attach[k]))
            tx = np.bincount(s_core[in_path] // self.attach[k],
                             weights=vals[in_path], minlength=units)
            rx = np.bincount(r_core[in_path] // self.attach[k],
                             weights=vals[in_path], minlength=units)
            out[lv.name] = {"tx": tx, "rx": rx, "bw": lv.bw}
        return out

    # -- stage scheduling ----------------------------------------------------
    @staticmethod
    def merge_stages(hops: Sequence[Hop]) -> list[list[Hop]]:
        """Pack topologically-ordered hops into multi-server scan stages.

        A hop may join the current stage only if no pair already has a
        hop there (disjoint masks == no intra-stage dependency); server
        id blocks are disjoint by construction, so merged hops form one
        valid segmented Lindley pass. The default two-level hierarchy
        merges to exactly two stages — the previous TX-then-RX rounds.
        """
        stages: list[list[Hop]] = []
        acc: np.ndarray | None = None
        for hop in hops:
            if acc is None or (acc & hop.mask).any():
                stages.append([hop])
                acc = hop.mask.copy()
            else:
                stages[-1].append(hop)
                acc |= hop.mask
        return stages


def default_hierarchy(cluster) -> NetworkHierarchy:
    """PR-2-equivalent hierarchy synthesized from a ``ClusterTopology``.

    * Paper mode (``ici_bw is None``): one ``node`` level — every
      inter-node message queues at the sender's NIC-TX and receiver's
      NIC-RX, ``switch_latency`` at the apex.
    * TPU-fleet mode (``ici_bw`` set): ``node`` level at ICI bandwidth
      (same-pod inter-node traffic) plus an express ``pod`` level whose
      per-node DCN NICs (``attach_cores = cores_per_node``) carry
      pod-crossing traffic without riding the ICI.
    """
    node = NetLevel("node", fan_in=cluster.cores_per_node,
                    bw=cluster.ici_bw if cluster.ici_bw is not None
                    else cluster.nic_bw,
                    latency=cluster.switch_latency)
    if cluster.ici_bw is None:
        return NetworkHierarchy([node])
    return NetworkHierarchy([
        node,
        NetLevel("pod", fan_in=cluster.nodes_per_pod, bw=cluster.nic_bw,
                 latency=cluster.switch_latency, express=True,
                 attach_cores=cluster.cores_per_node),
    ])
