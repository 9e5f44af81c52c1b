"""Fleet cells — the placement-domain layer of the scheduler (§13).

A *cell* is a contiguous block of nodes carved out of the cluster's
:class:`~repro_torch.core.hierarchy.NetworkHierarchy` (DESIGN.md §13). Each
cell owns

* a **tracker view** — a full-cluster :class:`FreeCoreTracker` whose
  out-of-cell cores are permanently offline, so the one-shot mapping
  strategies (which walk ``free_mask()``) place inside the cell without
  knowing cells exist. In-cell ``used``/``offline`` bits mirror the
  scheduler's global tracker exactly; ``check_invariants`` proves the
  per-cell views tile the global tracker.
* a warm **SimHandle** — per-cell delta workload assembly, so a
  mutation inside one cell re-simulates only that cell's live set and
  event-loop throughput scales with cells instead of total live jobs.
* a cached **last_res** — the cell-local analogue of the scheduler's
  ``_last_res``, invalidated by any mutation that touches the cell.
* a running **load** — aggregate communication demand (bytes/s) of the
  jobs resident in the cell; the cross-cell balancer routes arrivals to
  the fitting cell with the least projected level-load
  ``(load + job demand) / uplink capacity``.

**Nesting** (``cells="pod/rack"``): leaf cells (racks) sit under parent
cells (pods). A parent cell owns its children's node range with its own
tracker view and warm handle; a job that spans racks inside one pod
*binds to the pod* instead of going global, so escalation walks up ONE
level at a time — rack → pod → global — and only jobs spanning pods
couple the whole fleet.

With ``cells=1`` the scheduler aliases cell 0's tracker and handle to
its own global ones, so the sharded code path degenerates to exactly
the sequential scheduler (the byte-identity contract of DESIGN.md §13).

:class:`CellFabric` is the layer's façade-facing object: it owns the
cell list, the node→cell map, the job→cell bindings, the spanning
count and the dirty set, and provides the claim/release/bind/route
operations every other subsystem uses. Layering: this module imports
only ``repro_torch.core`` — never the scheduler subsystems.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from ..core.graphs import AppGraph, ClusterTopology, FreeCoreTracker
from ..core.simulator import SimHandle

GLOBAL_CELL = -1      # job spans cells: placed globally, escalates reclock


@dataclasses.dataclass
class FleetCell:
    """One shard of the fleet: node range + tracker view + warm sim."""

    cell_id: int
    nodes: np.ndarray             # contiguous node ids
    cores: np.ndarray             # the nodes' core ids
    tracker: FreeCoreTracker      # full-cluster view, out-of-cell offline
    sim: SimHandle                # warm per-cell simulation handle
    uplink_bw: float              # aggregate egress capacity (bytes/s)
    last_res: object = None       # SimResult for the cell's live set
    load: float = 0.0             # resident jobs' demand (bytes/s)
    live: set = dataclasses.field(default_factory=set)   # resident job ids
    parent: Optional[int] = None  # enclosing cell id (nested fabrics)
    children: list = dataclasses.field(default_factory=list)  # child ids

    def total_free(self) -> int:
        return self.tracker.total_free()


def derive_cell_nodes(cluster: ClusterTopology,
                      cells: Union[int, str]) -> list[np.ndarray]:
    """Split the cluster's nodes into cell groups.

    ``cells`` is either a cell count (contiguous equal node blocks — must
    divide ``n_nodes``) or a hierarchy level name (``"rack"`` / ``"pod"``
    ...), in which case each level-group becomes one cell.
    """
    n_nodes = cluster.n_nodes
    if isinstance(cells, str):
        hier = cluster.net_hierarchy()
        for k, lv in enumerate(hier.levels):
            if lv.name == cells:
                nodes_per = max(1, hier.group_cores[k]
                                // cluster.cores_per_node)
                break
        else:
            known = [lv.name for lv in hier.levels]
            raise KeyError(f"unknown hierarchy level {cells!r}; "
                           f"known: {known}")
        n_cells = -(-n_nodes // nodes_per)
    else:
        n_cells = int(cells)
        if n_cells < 1:
            raise ValueError(f"cells must be >= 1, got {n_cells}")
        if n_nodes % n_cells:
            raise ValueError(f"cells={n_cells} does not divide "
                             f"{n_nodes} nodes evenly")
        nodes_per = n_nodes // n_cells
    groups = [np.arange(i * nodes_per, min((i + 1) * nodes_per, n_nodes),
                        dtype=np.int64) for i in range(n_cells)]
    return [g for g in groups if g.size]


def _fresh_cell(cluster: ClusterTopology, cid: int, nodes: np.ndarray, *,
                count_scale: float, backend: str, device) -> FleetCell:
    cpn = cluster.cores_per_node
    cores = (nodes[:, None] * cpn + np.arange(cpn)).reshape(-1)
    tracker = FreeCoreTracker(cluster)
    outside = np.ones(cluster.n_cores, dtype=bool)
    outside[cores] = False
    tracker.set_offline(np.flatnonzero(outside))
    sim = SimHandle(cluster, count_scale=count_scale, backend=backend,
                    device=device)
    return FleetCell(cell_id=cid, nodes=nodes, cores=cores,
                     tracker=tracker, sim=sim,
                     uplink_bw=float(nodes.size) * cluster.nic_bw)


def build_cells(cluster: ClusterTopology, cells: Union[int, str], *,
                count_scale: float, backend: str, device=None,
                global_tracker: Optional[FreeCoreTracker] = None,
                global_sim: Optional[SimHandle] = None) -> list[FleetCell]:
    """Construct the cell shards (DESIGN.md §13).

    A single cell aliases the scheduler's global tracker and SimHandle —
    the byte-identity guarantee that ``cells=1`` IS the sequential
    scheduler. Multi-cell trackers are fresh full-cluster views with
    every out-of-cell core marked offline.

    A ``"parent/leaf"`` spec (e.g. ``"pod/rack"``) builds a two-level
    nested fabric: leaf cells first (ids ``0..L-1``), then one parent
    cell per parent-level group (ids ``L..``), linked via
    ``parent``/``children``. Leaf groups must nest inside exactly one
    parent group each.

    ``device`` is where every fresh cell's handle scans (``None``: the
    CUDA card, raising without one).
    """
    if isinstance(cells, str) and "/" in cells:
        parent_lv, leaf_lv = (s.strip() for s in cells.split("/", 1))
        if "/" in leaf_lv:
            raise ValueError(f"cell nesting is two levels "
                             f"('parent/leaf'), got {cells!r}")
        leaf_groups = derive_cell_nodes(cluster, leaf_lv)
        parent_groups = derive_cell_nodes(cluster, parent_lv)
        if len(parent_groups) >= len(leaf_groups):
            raise ValueError(
                f"nested spec {cells!r}: parent level {parent_lv!r} "
                f"({len(parent_groups)} groups) must be coarser than "
                f"leaf level {leaf_lv!r} ({len(leaf_groups)} groups)")
        out = [_fresh_cell(cluster, cid, nodes, count_scale=count_scale,
                           backend=backend, device=device)
               for cid, nodes in enumerate(leaf_groups)]
        parent_of_node = np.empty(cluster.n_nodes, dtype=np.int64)
        for k, nodes in enumerate(parent_groups):
            parent_of_node[nodes] = k
        for k, nodes in enumerate(parent_groups):
            pid = len(leaf_groups) + k
            parent = _fresh_cell(cluster, pid, nodes,
                                 count_scale=count_scale, backend=backend,
                                 device=device)
            out.append(parent)
        for leaf in out[:len(leaf_groups)]:
            owners = np.unique(parent_of_node[leaf.nodes])
            if owners.size != 1:
                raise ValueError(
                    f"leaf cell {leaf.cell_id} straddles parent groups "
                    f"{owners.tolist()} — {leaf_lv!r} does not nest "
                    f"inside {parent_lv!r}")
            pid = len(leaf_groups) + int(owners[0])
            leaf.parent = pid
            out[pid].children.append(leaf.cell_id)
        return out
    groups = derive_cell_nodes(cluster, cells)
    cpn = cluster.cores_per_node
    out = []
    single = len(groups) == 1
    for cid, nodes in enumerate(groups):
        cores = (nodes[:, None] * cpn + np.arange(cpn)).reshape(-1)
        if single and global_tracker is not None:
            tracker = global_tracker
            sim = global_sim if global_sim is not None else SimHandle(
                cluster, count_scale=count_scale, backend=backend,
                device=device)
            out.append(FleetCell(cell_id=cid, nodes=nodes, cores=cores,
                                 tracker=tracker, sim=sim,
                                 uplink_bw=float(nodes.size)
                                 * cluster.nic_bw))
        else:
            out.append(_fresh_cell(cluster, cid, nodes,
                                   count_scale=count_scale,
                                   backend=backend, device=device))
    return out


class CellFabric:
    """Placement domains over the cluster: cells, bindings, routing.

    Owns everything cell-shaped the scheduler used to carry inline —
    the cell list, the node→leaf-cell map, job→cell bindings, the
    global-spanning count and the dirty set consumed by the re-clock —
    and exposes the mutation mirrors (claim/release/set_offline/
    set_online) every fleet mutation routes through. All methods are
    no-ops for a single-cell fabric, preserving the sequential path
    byte-for-byte.
    """

    def __init__(self, cluster: ClusterTopology, spec: Union[int, str], *,
                 count_scale: float, backend: str, device=None,
                 global_tracker: Optional[FreeCoreTracker] = None,
                 global_sim: Optional[SimHandle] = None,
                 metrics=None) -> None:
        self.cluster = cluster
        self.metrics = metrics
        self.cells = build_cells(cluster, spec, count_scale=count_scale,
                                 backend=backend, device=device,
                                 global_tracker=global_tracker,
                                 global_sim=global_sim)
        self.n_cells = len(self.cells)
        self.n_leaves = sum(1 for c in self.cells if not c.children)
        self.job_cell: dict[int, int] = {}   # live job -> cell (or GLOBAL)
        self.n_spanning = 0                  # live jobs spanning globally
        self.dirty: set = set()              # leaf cells touched since reclock
        if self.n_cells > 1:
            # one warm flat handle per cell plus the global one must
            # coexist in the flat-assembly cache or warm starts thrash
            from ..core import sim_scan
            sim_scan.set_flat_cache_size(2 * self.n_cells + 4)
            self.node_cell = np.empty(cluster.n_nodes, dtype=np.int64)
            for cell in self.leaves:
                self.node_cell[cell.nodes] = cell.cell_id

    @property
    def leaves(self) -> list[FleetCell]:
        return self.cells[:self.n_leaves]

    @property
    def parents(self) -> list[FleetCell]:
        return self.cells[self.n_leaves:]

    # -- views ---------------------------------------------------------------
    def cells_of_cores(self, cores: np.ndarray) -> np.ndarray:
        """Leaf cell ids a core set touches (sorted, unique)."""
        return np.unique(self.node_cell[self.cluster.node_of(cores)])

    def _affected(self, cores: np.ndarray) -> list[tuple[FleetCell,
                                                         np.ndarray]]:
        """Every cell a core set overlaps — leaves first, then their
        parents — paired with the overlapping core subset."""
        node_ids = self.cluster.node_of(cores)
        leaf_ids = self.node_cell[node_ids]
        parts: list[tuple[FleetCell, np.ndarray]] = []
        by_parent: dict[int, list[np.ndarray]] = {}
        for cid in np.unique(leaf_ids):
            sub = cores[leaf_ids == cid]
            leaf = self.cells[int(cid)]
            parts.append((leaf, sub))
            if leaf.parent is not None:
                by_parent.setdefault(leaf.parent, []).append(sub)
        for pid, subs in by_parent.items():
            parts.append((self.cells[pid],
                          subs[0] if len(subs) == 1
                          else np.concatenate(subs)))
        return parts

    def cell_jobs(self, cell: FleetCell) -> list[int]:
        """Sorted resident job ids of a cell's subtree (the cell's own
        residents plus, for a parent, every child's residents)."""
        if not cell.children:
            return sorted(cell.live)
        jids = set(cell.live)
        for cid in cell.children:
            jids |= self.cells[cid].live
        return sorted(jids)

    def subtree_load(self, cell: FleetCell) -> float:
        """Aggregate resident demand of a cell's subtree (bytes/s)."""
        return cell.load + sum(self.cells[cid].load
                               for cid in cell.children)

    # -- dirty tracking ------------------------------------------------------
    def mark_dirty(self, cores: np.ndarray) -> None:
        """A mutation touched these cores: invalidate the owning cells'
        cached results (leaf AND enclosing parent) and queue the leaves
        for the next fleet re-clock."""
        if self.n_cells == 1:
            return
        for cid in self.cells_of_cores(cores):
            cell = self.cells[int(cid)]
            cell.last_res = None
            if cell.parent is not None:
                self.cells[cell.parent].last_res = None
            self.dirty.add(int(cid))

    def reclock_domains(self, dirty: set) -> list[int]:
        """Resolve dirty leaves to the domains the re-clock must visit:
        a dirty leaf whose pod holds pod-spanning residents escalates
        ONE level up (the pod re-clock covers the coupled subtree); a
        pod domain shadows its own dirty children. Flat fabrics return
        ``sorted(dirty)`` unchanged."""
        domains: set[int] = set()
        promoted: set[int] = set()
        for cid in dirty:
            cell = self.cells[cid]
            p = cell.parent
            if p is not None and self.cells[p].live:
                domains.add(p)
                promoted.add(p)
            else:
                domains.add(cid)
        if promoted and self.metrics is not None:
            # walking up rack -> pod is an escalation, same currency as
            # the flat fabric's cell -> global escalations
            self.metrics.counter("sched.cell_escalations").inc(
                len(promoted))
        drop = {c for cid in domains for c in self.cells[cid].children}
        return sorted(domains - drop)

    def pass_domains(self) -> list[FleetCell]:
        """The placement domains a remap tick visits: pods holding
        pod-spanning residents (their subtree is coupled), and every
        leaf under a quiet pod. Flat fabrics: every cell."""
        if not self.parents:
            return list(self.cells)
        out: list[FleetCell] = []
        hot: set[int] = set()
        for p in self.parents:
            if p.live:
                out.append(p)
                hot.add(p.cell_id)
        for leaf in self.leaves:
            if leaf.parent not in hot:
                out.append(leaf)
        return out

    # -- mutation mirrors ----------------------------------------------------
    def claim(self, cores: np.ndarray,
              settled: Optional[FreeCoreTracker] = None) -> None:
        """Mirror a core claim into every overlapping cell view (no-op
        for the single-cell alias). ``settled`` names a tracker the
        strategy already claimed on, skipped here."""
        if self.n_cells == 1:
            return
        for cell, sub in self._affected(cores):
            if cell.tracker is settled:
                continue
            cell.tracker.take_cores(sub)

    def release(self, cores: np.ndarray) -> None:
        if self.n_cells == 1:
            return
        for cell, sub in self._affected(cores):
            cell.tracker.release_cores(sub)

    def set_offline(self, node: int) -> None:
        if self.n_cells == 1:
            return
        cpn = self.cluster.cores_per_node
        node_cores = np.arange(node * cpn, (node + 1) * cpn,
                               dtype=np.int64)
        leaf = self.cells[int(self.node_cell[node])]
        leaf.tracker.set_offline(node_cores)
        leaf.last_res = None
        self.dirty.add(leaf.cell_id)
        if leaf.parent is not None:
            parent = self.cells[leaf.parent]
            parent.tracker.set_offline(node_cores)
            parent.last_res = None

    def set_online(self, node: int) -> None:
        if self.n_cells == 1:
            return
        cpn = self.cluster.cores_per_node
        node_cores = np.arange(node * cpn, (node + 1) * cpn,
                               dtype=np.int64)
        leaf = self.cells[int(self.node_cell[node])]
        leaf.tracker.set_online(node_cores)
        leaf.last_res = None
        self.dirty.add(leaf.cell_id)
        if leaf.parent is not None:
            parent = self.cells[leaf.parent]
            parent.tracker.set_online(node_cores)
            parent.last_res = None

    # -- job bindings --------------------------------------------------------
    def bind(self, jid: int, cores: np.ndarray, graph: AppGraph) -> None:
        """Record which cell a placement landed in and book its demand
        into the balancer's load. A placement crossing leaf cells binds
        to the smallest enclosing parent when one exists (pod-spanning);
        only placements crossing parents (or leaves of a flat fabric)
        bind GLOBAL and couple the whole fleet."""
        if self.n_cells == 1:
            return
        cids = self.cells_of_cores(cores)
        if cids.size > 1:
            owners = {self.cells[int(c)].parent for c in cids}
            pid = owners.pop() if len(owners) == 1 else None
            if pid is not None:
                cell = self.cells[pid]
                self.job_cell[jid] = cell.cell_id
                cell.live.add(jid)
                cell.load += float(graph.demand.sum())
                if self.metrics is not None:
                    self.metrics.counter("sched.spanning_jobs").inc()
            else:
                self.job_cell[jid] = GLOBAL_CELL
                self.n_spanning += 1
                if self.metrics is not None:
                    self.metrics.counter("sched.spanning_jobs").inc()
                self.dirty.add(GLOBAL_CELL)
        else:
            cell = self.cells[int(cids[0])]
            self.job_cell[jid] = cell.cell_id
            cell.live.add(jid)
            cell.load += float(graph.demand.sum())
        self.mark_dirty(cores)

    def unbind(self, jid: int, cores: np.ndarray, graph: AppGraph) -> None:
        if self.n_cells == 1:
            return
        cid = self.job_cell.pop(jid)
        if cid == GLOBAL_CELL:
            self.n_spanning -= 1
        else:
            cell = self.cells[cid]
            cell.live.discard(jid)
            cell.load -= float(graph.demand.sum())
        self.mark_dirty(cores)

    # -- routing -------------------------------------------------------------
    def route(self, graph: AppGraph,
              remaining: Optional[dict] = None) -> Optional[FleetCell]:
        """Balancer: the fitting cell with least projected level-load
        ``(resident demand + job demand) / uplink capacity``; leaves are
        preferred, a parent (pod) catches jobs no single leaf fits, and
        ``None`` means the job will span globally."""
        procs = graph.n_procs
        demand = float(graph.demand.sum())
        for group in (self.leaves, self.parents):
            best: Optional[FleetCell] = None
            best_score = 0.0
            for cell in group:
                free = remaining[cell.cell_id] if remaining is not None \
                    else cell.total_free()
                if free < procs:
                    continue
                score = (self.subtree_load(cell) + demand) / cell.uplink_bw
                if best is None or score < best_score:
                    best, best_score = cell, score
            if best is not None:
                return best
        return None

    def check_tiling(self, live, tracker, invariant) -> None:
        """Prove the fabric is consistent with the global fleet state:
        per-cell views tile ``tracker`` exactly and every live job's
        cell binding matches its actual core residency. ``invariant``
        is the facade's raising reporter; no-op for the single-cell
        alias (there is nothing to tile)."""
        if self.n_cells == 1:
            return
        n_cores = self.cluster.n_cores
        # cell views tile the global tracker (§13): in-cell used/offline
        # bits mirror it exactly, out-of-cell cores are pinned offline,
        # leaf core ranges partition the cluster, and parent (pod) views
        # cover exactly their children's union
        covered = np.zeros(n_cores, dtype=bool)
        for cell in self.cells:
            in_cell = np.zeros(n_cores, dtype=bool)
            in_cell[cell.cores] = True
            if not cell.children:
                if covered[in_cell].any():
                    invariant(
                        f"cell {cell.cell_id} overlaps another")
                covered |= in_cell
            else:
                child_cores = np.zeros(n_cores, dtype=bool)
                for cid in cell.children:
                    child_cores[self.cells[cid].cores] = True
                if not np.array_equal(in_cell, child_cores):
                    invariant(
                        f"parent cell {cell.cell_id} does not cover "
                        f"exactly its children")
            if not np.array_equal(cell.tracker.used[in_cell],
                                  tracker.used[in_cell]):
                invariant(
                    f"cell {cell.cell_id} used-mask drift")
            if not np.array_equal(cell.tracker.offline[in_cell],
                                  tracker.offline[in_cell]):
                invariant(
                    f"cell {cell.cell_id} offline-mask drift")
            if not cell.tracker.offline[~in_cell].all():
                invariant(
                    f"cell {cell.cell_id} sees out-of-cell cores")
        if not covered.all():
            invariant("cells do not cover the cluster")
        # job->cell binding consistent with actual core residency:
        # one leaf -> that leaf; several leaves under one parent ->
        # that parent; otherwise GLOBAL
        n_span = 0
        for jid, job in live.items():
            cids = self.cells_of_cores(job.cores)
            cid = self.job_cell.get(jid)
            if cids.size == 1:
                if cid != int(cids[0]):
                    invariant(
                        f"job {jid} in cell {int(cids[0])} bound to {cid}")
                continue
            owners = {self.cells[int(c)].parent for c in cids}
            pid = owners.pop() if len(owners) == 1 else None
            if pid is not None:
                if cid != pid:
                    invariant(
                        f"job {jid} spans cells of parent {pid} "
                        f"but bound to {cid}")
            else:
                n_span += 1
                if cid != GLOBAL_CELL:
                    invariant(
                        f"job {jid} spans cells but bound to {cid}")
        if n_span != self.n_spanning:
            invariant(
                f"spanning count drift: "
                f"{n_span} != {self.n_spanning}")

