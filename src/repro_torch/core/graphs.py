"""Application Graph (AG) and Cluster Topology Graph (CTG).

The paper's abstractions:

* AG — vertices are parallel processes of one job; edge (i, j) carries the
  communication demand ``L_ij * lambda_ij`` (message size x send rate).
* CTG — vertices are processing cores arranged in a node/socket/core
  hierarchy; edges carry the bandwidth of the channel connecting them
  (cache within a socket, memory within a node, NIC + switch across nodes).

The same structures describe an accelerator fleet (pod/host/chip): the
``ici_bw`` / ``pod_size`` fields below model its two-level fabric, with
model shards as processes.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Communication patterns (paper section 5.2)
# ---------------------------------------------------------------------------
PATTERNS = ("all_to_all", "bcast_scatter", "gather_reduce", "linear")


def pattern_traffic(pattern: str, n_procs: int, length: float, rate: float,
                    count: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build (L, lam, cnt) traffic matrices for a named pattern.

    ``L[i, j]``   — message size (bytes) sent from i to j (0 if none)
    ``lam[i, j]`` — messages/second from i to j
    ``cnt[i, j]`` — total number of messages i sends to j
    """
    P = n_procs
    L = np.zeros((P, P))
    lam = np.zeros((P, P))
    cnt = np.zeros((P, P), dtype=np.int64)
    if pattern == "all_to_all":
        mask = ~np.eye(P, dtype=bool)
        L[mask] = length
        lam[mask] = rate
        cnt[mask] = count
    elif pattern == "bcast_scatter":  # root 0 sends to everyone
        L[0, 1:] = length
        lam[0, 1:] = rate
        cnt[0, 1:] = count
    elif pattern == "gather_reduce":  # everyone sends to root 0
        L[1:, 0] = length
        lam[1:, 0] = rate
        cnt[1:, 0] = count
    elif pattern == "linear":  # i -> i+1 chain
        idx = np.arange(P - 1)
        L[idx, idx + 1] = length
        lam[idx, idx + 1] = rate
        cnt[idx, idx + 1] = count
    else:
        raise ValueError(f"unknown pattern {pattern!r}")
    return L, lam, cnt


def tie_phase(job_id, rank):
    """Deterministic per-(job, sender) emission phase offset (seconds).

    Senders that tick at the same rate would emit at identical instants;
    the phase breaks those ties deterministically. It is keyed on BOTH the
    job id and the sender's rank within the job — keying on the rank alone
    would give identical ranks of *different* jobs colliding phases, and
    their arrival order at a shared server would then depend on flattening
    order rather than on anything physical.

    Accepts scalars or arrays (int64 math, no overflow for realistic ids).
    """
    j = np.asarray(job_id, dtype=np.int64)
    r = np.asarray(rank, dtype=np.int64)
    return ((j * 2654435761 + r * 7919) % 104729) * 1e-9


@dataclasses.dataclass(frozen=True)
class FlatMessages:
    """Placement-independent flattened message stream of one job.

    Messages of one (i, j) pair share sender, receiver, and size, so those
    live at PAIR granularity (``pair_*``) with ``pair_of`` mapping each of
    the M messages back to its pair: routing is computed over the few
    thousand pairs and expanded with one gather, and repeated
    ``simulate()`` calls never re-run the Python pair-expansion loop.
    ``src``/``dst`` are process ranks *within the job*; a placement turns
    them into global core ids with a single gather (``cores[pair_src]``).
    """

    pair_src: np.ndarray   # (P,) sender rank per communicating pair
    pair_dst: np.ndarray   # (P,) receiver rank
    pair_size: np.ndarray  # (P,) bytes
    pair_of: np.ndarray    # (M,) pair index per message
    emit: np.ndarray       # (M,) emission time (s), tie-phase included

    @property
    def n_messages(self) -> int:
        return int(self.emit.size)

    @property
    def n_pairs(self) -> int:
        return int(self.pair_src.size)

    @property
    def time_order(self) -> np.ndarray:
        """Stable sorted-by-emit order of this block, computed once.

        The delta-aware live-set assembly (``sim_scan._WorkloadFlat``)
        merges per-job sorted blocks instead of re-sorting the whole
        workload, so the per-block order is worth caching alongside the
        messages themselves.
        """
        order = getattr(self, "_time_order", None)
        if order is None:
            order = np.argsort(self.emit, kind="stable").astype(np.int32)
            object.__setattr__(self, "_time_order", order)
        return order

    # per-message views (derived; prefer the pair arrays in hot paths)
    @property
    def src(self) -> np.ndarray:
        return self.pair_src[self.pair_of]

    @property
    def dst(self) -> np.ndarray:
        return self.pair_dst[self.pair_of]

    @property
    def size(self) -> np.ndarray:
        return self.pair_size[self.pair_of]


# ---------------------------------------------------------------------------
# Application graph
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class AppGraph:
    """One parallel job's communication structure.

    Traffic matrices are directed; adjacency/demand helpers treat the graph
    as undirected the way the paper does ("adjacent processes" = partners).
    """

    name: str
    L: np.ndarray      # (P, P) message sizes in bytes
    lam: np.ndarray    # (P, P) messages / second
    cnt: np.ndarray    # (P, P) total message count
    job_id: int = 0
    # flat_messages() cache, keyed by count_scale. Traffic matrices are
    # treated as immutable once messages have been flattened.
    _flat_cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                          compare=False)

    # -- construction -------------------------------------------------------
    @classmethod
    def from_pattern(cls, name: str, pattern: str, n_procs: int, length: float,
                     rate: float, count: int, job_id: int = 0) -> "AppGraph":
        L, lam, cnt = pattern_traffic(pattern, n_procs, length, rate, count)
        return cls(name=name, L=L, lam=lam, cnt=cnt, job_id=job_id)

    @classmethod
    def from_components(cls, name: str,
                        components: Iterable[tuple[str, float, float, int]],
                        n_procs: int, job_id: int = 0) -> "AppGraph":
        """Sum several (pattern, length, rate, count) components.

        Per the paper, when a pair exchanges messages of different lengths
        the *largest* length is kept (used for classification and demand);
        rates and counts add.
        """
        L = np.zeros((n_procs, n_procs))
        lam = np.zeros((n_procs, n_procs))
        cnt = np.zeros((n_procs, n_procs), dtype=np.int64)
        for pattern, length, rate, count in components:
            Lp, lamp, cntp = pattern_traffic(pattern, n_procs, length, rate, count)
            L = np.maximum(L, Lp)
            lam = lam + lamp
            cnt = cnt + cntp
        return cls(name=name, L=L, lam=lam, cnt=cnt, job_id=job_id)

    # -- message flattening --------------------------------------------------
    def flat_messages(self, count_scale: float = 1.0) -> FlatMessages:
        """Expanded per-message arrays, cached per ``count_scale``.

        Matches the simulator's historical expansion exactly: each (i, j)
        pair with ``cnt[i, j] > 0`` emits ``max(1, round(cnt * scale))``
        messages at ``tie_phase(job_id, i) + k / lam[i, j]``.
        """
        cached = self._flat_cache.get(count_scale)
        if cached is not None:
            return cached
        src_i, dst_j = np.nonzero(self.cnt)
        n_pair = np.maximum(
            1, np.rint(self.cnt[src_i, dst_j] * count_scale)).astype(np.int64)
        rate = self.lam[src_i, dst_j]
        period = np.divide(1.0, rate, out=np.zeros_like(rate),
                           where=rate > 0)
        starts = np.concatenate([[0], np.cumsum(n_pair)[:-1]])
        pair_of = np.repeat(np.arange(src_i.size), n_pair).astype(np.int32)
        k = np.arange(int(n_pair.sum()), dtype=np.int64) - starts[pair_of]
        flat = FlatMessages(
            pair_src=src_i.astype(np.int32),
            pair_dst=dst_j.astype(np.int32),
            pair_size=self.L[src_i, dst_j],
            pair_of=pair_of,
            emit=tie_phase(self.job_id, src_i)[pair_of] + k * period[pair_of],
        )
        self._flat_cache[count_scale] = flat
        return flat

    # -- paper quantities ----------------------------------------------------
    @property
    def n_procs(self) -> int:
        return self.L.shape[0]

    @property
    def demand(self) -> np.ndarray:
        """Directed demand matrix  L_ij * lambda_ij  (bytes/second)."""
        return self.L * self.lam

    @property
    def sym_demand(self) -> np.ndarray:
        """Undirected pairwise demand (i<->j combined)."""
        d = self.demand
        return d + d.T

    def adjacency_counts(self) -> np.ndarray:
        """Adj_pi — number of communication partners of each process."""
        partners = (self.sym_demand > 0)
        return partners.sum(axis=1)

    @property
    def adj_avg(self) -> float:
        """Adj_avg — average number of adjacent processes (paper step 2)."""
        return float(self.adjacency_counts().mean())

    @property
    def adj_max(self) -> int:
        """Adj_max — maximum adjacency within the job (used by eq. 2)."""
        return int(self.adjacency_counts().max())

    def comm_demand(self) -> np.ndarray:
        """CD_i = sum_j L_ij * lambda_ij  (paper eq. 1, outgoing demand)."""
        return self.demand.sum(axis=1)

    @property
    def max_length(self) -> float:
        """Largest message length the job sends — classifies the job."""
        return float(self.L.max())

    def size_class(self) -> str:
        """Paper's 3-way split: large >= 1MB, medium (2KB, 1MB), small <= 2KB."""
        m = self.max_length
        if m >= 1 << 20:
            return "large"
        if m > 2048:
            return "medium"
        return "small"


# ---------------------------------------------------------------------------
# Cluster topology
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ClusterTopology:
    """Hierarchical cluster: nodes x sockets x cores (or pods x hosts x chips).

    Core ids are global and laid out node-major then socket-major so that
    ``core // cores_per_node`` is the node and
    ``(core % cores_per_node) // cores_per_socket`` is the socket.
    """

    n_nodes: int = 16
    sockets_per_node: int = 4
    cores_per_socket: int = 4
    # bandwidths (bytes/s) & latencies (s) — paper Table 1 defaults
    mem_bw: float = 4e9                  # main memory bandwidth
    cache_bw: float = 8e9                # intra-socket cache (AMD Opteron 2352-class)
    cache_msg_cap: float = float(1 << 20)  # messages above this go via memory
    nic_bw: float = 1e9                  # InfiniHost MT23108 4x
    switch_latency: float = 100e-9       # independent of message size
    numa_remote_penalty: float = 0.10    # +10% when crossing sockets
    # --- TPU-fleet extension (None/1 -> paper semantics unchanged) ---------
    # pods group nodes; inter-node SAME-pod traffic rides ICI (fast, per-node
    # aggregate server) instead of the NIC; only POD-CROSSING traffic queues
    # at the per-node DCN NIC — the "many cores, one NIC" regime at TPU scale.
    pods: int = 1
    ici_bw: float | None = None          # None -> all inter-node via NIC
    # --- explicit network hierarchy (DESIGN.md §9) -------------------------
    # None -> a default hierarchy equivalent to the fields above is
    # synthesized (node NIC, or node ICI + express pod DCN). Set to a
    # NetworkHierarchy to model deeper trees (chip/rack levels,
    # oversubscribed uplinks); inter-node routing in every simulator
    # backend then follows its LCA path rule.
    hierarchy: "object | None" = None    # NetworkHierarchy | None

    @property
    def cores_per_node(self) -> int:
        return self.sockets_per_node * self.cores_per_socket

    @property
    def n_cores(self) -> int:
        return self.n_nodes * self.cores_per_node

    @property
    def nodes_per_pod(self) -> int:
        return self.n_nodes // self.pods

    def node_of(self, core: np.ndarray | int):
        return np.asarray(core) // self.cores_per_node

    def pod_of(self, core: np.ndarray | int):
        return self.node_of(core) // self.nodes_per_pod

    def socket_of(self, core: np.ndarray | int):
        return (np.asarray(core) % self.cores_per_node) // self.cores_per_socket

    def core_id(self, node: int, socket: int, slot: int) -> int:
        return node * self.cores_per_node + socket * self.cores_per_socket + slot

    def core_maps(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(node, socket, pod) per global core id — cached lookup tables.

        Hot paths (``sim_scan``) replace per-message div/mod chains with one
        gather per attribute. Topology fields are treated as immutable once
        this has been called.
        """
        maps = getattr(self, "_core_maps", None)
        if maps is None:
            cores = np.arange(self.n_cores)
            maps = (self.node_of(cores), self.socket_of(cores),
                    self.pod_of(cores))
            self._core_maps = maps
        return maps

    def net_hierarchy(self):
        """Resolved inter-node hierarchy (explicit field or the default).

        Cached — topology fields are treated as immutable once routing
        has started, matching :meth:`core_maps`.
        """
        hier = getattr(self, "_net_hier", None)
        if hier is None:
            from .hierarchy import default_hierarchy
            hier = self.hierarchy or default_hierarchy(self)
            self._net_hier = hier
        return hier


@dataclasses.dataclass
class Placement:
    """Result of mapping a workload: per-job process -> global core id."""

    cluster: ClusterTopology
    assignments: dict[int, np.ndarray] = dataclasses.field(default_factory=dict)

    def assign(self, job_id: int, proc_to_core: np.ndarray) -> None:
        self.assignments[job_id] = np.asarray(proc_to_core, dtype=np.int64)

    def remove(self, job_id: int) -> np.ndarray:
        """Drop one job's assignment (departure); returns its cores."""
        if job_id not in self.assignments:
            raise KeyError(f"job {job_id} not placed")
        return self.assignments.pop(job_id)

    def copy(self) -> "Placement":
        """Shallow clone — shares core arrays, independent assignment dict."""
        return Placement(self.cluster, dict(self.assignments))

    def occupied(self) -> np.ndarray:
        used = np.zeros(self.cluster.n_cores, dtype=bool)
        for cores in self.assignments.values():
            used[cores[cores >= 0]] = True
        return used

    def free_cores_per_node(self) -> np.ndarray:
        used = self.occupied().reshape(self.cluster.n_nodes, -1)
        return self.cluster.cores_per_node - used.sum(axis=1)

    def validate(self) -> None:
        used = np.concatenate([c for c in self.assignments.values()]) if self.assignments else np.array([], dtype=np.int64)
        if used.size and (used.min() < 0 or used.max() >= self.cluster.n_cores):
            raise ValueError("core id out of range")
        if used.size != np.unique(used).size:
            raise ValueError("two processes mapped to one core")


class ClusterFull(RuntimeError):
    """A placement does not fit the free cores that are left.

    A ``RuntimeError`` as in the reference; a type of its own so a caller
    that skips a candidate which does not fit (``search.joint``) lets every
    other error (a kernel that does not build or launch, no CUDA device)
    pass."""


class FreeCoreTracker:
    """Mutable free/used view of a ClusterTopology used while mapping.

    Two orthogonal masks: ``used`` (a job holds the core) and ``offline``
    (the core's node is dead or draining — unschedulable regardless of
    occupancy).  A core is *free* only when neither is set; all queries
    and selection helpers go through :meth:`free_mask`.  Snapshots carry
    only ``used``: offline state never changes inside a remap trial, so
    restore cannot corrupt it.
    """

    def __init__(self, cluster: ClusterTopology, occupied: np.ndarray | None = None):
        self.cluster = cluster
        self.used = np.zeros(cluster.n_cores, dtype=bool)
        self.offline = np.zeros(cluster.n_cores, dtype=bool)
        if occupied is not None:
            self.used |= occupied

    @classmethod
    def from_placement(cls, placement: Placement) -> "FreeCoreTracker":
        """Tracker whose used set mirrors an existing placement."""
        return cls(placement.cluster, occupied=placement.occupied())

    # -- snapshot / restore (scheduler remap trials) ---------------------------
    def snapshot(self) -> np.ndarray:
        """Copy of the used mask; pass back to :meth:`restore` to roll back."""
        return self.used.copy()

    def restore(self, snap: np.ndarray) -> None:
        if snap.shape != self.used.shape:
            raise ValueError("snapshot shape mismatch")
        self.used = snap.copy()

    # -- availability ----------------------------------------------------------
    def free_mask(self) -> np.ndarray:
        """Boolean mask of schedulable cores: neither used nor offline."""
        return ~(self.used | self.offline)

    def set_offline(self, cores: np.ndarray) -> None:
        """Mark cores unschedulable (node died or is draining).

        Occupancy is untouched: a live job's cores stay ``used`` until the
        scheduler evicts or migrates it, so accounting never double-frees.
        """
        cores = np.asarray(cores, dtype=np.int64)
        if cores.size and (cores.min() < 0 or cores.max() >= self.cluster.n_cores):
            raise ValueError("core id out of range")
        self.offline[cores] = True

    def set_online(self, cores: np.ndarray) -> None:
        """Return recovered cores to the schedulable pool."""
        cores = np.asarray(cores, dtype=np.int64)
        if cores.size and (cores.min() < 0 or cores.max() >= self.cluster.n_cores):
            raise ValueError("core id out of range")
        self.offline[cores] = False

    # -- queries -------------------------------------------------------------
    def free_in_node(self, node: int) -> int:
        c = self.cluster
        lo = node * c.cores_per_node
        return int(self.free_mask()[lo:lo + c.cores_per_node].sum())

    def free_in_socket(self, node: int, socket: int) -> int:
        c = self.cluster
        lo = node * c.cores_per_node + socket * c.cores_per_socket
        return int(self.free_mask()[lo:lo + c.cores_per_socket].sum())

    def free_per_node(self) -> np.ndarray:
        return self.free_mask().reshape(self.cluster.n_nodes, -1).sum(axis=1)

    def free_cores_avg(self) -> float:
        return float(self.free_per_node().mean())

    def total_free(self) -> int:
        return int(self.free_mask().sum())

    # -- selection (paper steps 3.5 / 3.6) ------------------------------------
    def node_with_most_free(self) -> int:
        return int(np.argmax(self.free_per_node()))

    def socket_with_most_free(self, node: int) -> int:
        frees = [self.free_in_socket(node, s) for s in range(self.cluster.sockets_per_node)]
        return int(np.argmax(frees))

    def nodes_by_free_desc(self) -> np.ndarray:
        f = self.free_per_node()
        # stable sort, ties broken by node id for determinism
        return np.argsort(-f, kind="stable")

    # -- mutation --------------------------------------------------------------
    def take_core(self, node: int, socket: int | None = None) -> int:
        """Claim one free core in (node[, socket]); returns global core id."""
        c = self.cluster
        if socket is None:
            socket = self.socket_with_most_free(node)
        lo = node * c.cores_per_node + socket * c.cores_per_socket
        for slot in range(c.cores_per_socket):
            if not self.used[lo + slot] and not self.offline[lo + slot]:
                self.used[lo + slot] = True
                return lo + slot
        # socket full — fall back to any socket in the node
        for s in range(c.sockets_per_node):
            lo = node * c.cores_per_node + s * c.cores_per_socket
            for slot in range(c.cores_per_socket):
                if not self.used[lo + slot] and not self.offline[lo + slot]:
                    self.used[lo + slot] = True
                    return lo + slot
        raise ClusterFull(f"node {node} has no free core")

    def take_cores(self, cores: np.ndarray) -> None:
        """Claim specific global core ids (restore a known placement)."""
        cores = np.asarray(cores, dtype=np.int64)
        if cores.size and (cores.min() < 0 or cores.max() >= self.cluster.n_cores):
            raise ValueError("core id out of range")
        if self.used[cores].any():
            raise ValueError("core already in use")
        if self.offline[cores].any():
            raise ValueError("core is offline")
        self.used[cores] = True

    def release_cores(self, cores: np.ndarray) -> None:
        """Return a departed job's cores to the free pool.

        Double-release is an accounting bug, so releasing an already-free
        core raises rather than silently passing.
        """
        cores = np.asarray(cores, dtype=np.int64)
        if cores.size and (cores.min() < 0 or cores.max() >= self.cluster.n_cores):
            raise ValueError("core id out of range")
        if not self.used[cores].all():
            raise ValueError("releasing a core that is not in use")
        self.used[cores] = False


def workload_total_procs(jobs: Sequence[AppGraph]) -> int:
    return int(sum(j.n_procs for j in jobs))
