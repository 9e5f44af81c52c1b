"""Scan-based simulator backends: segmented Lindley passes, no server loop.

The ``loop`` backend (``simulator._simulate_loop``) runs Lindley's recursion
once per server in a Python loop. This module replaces that with ONE
segmented scan over all servers of a routing round at once (DESIGN.md §8):

* Sort messages by ``(server, arrival)`` (stable — ties keep flattening
  order, matching the loop backend sequence-for-sequence).
* Lindley's recursion ``W_n = max(0, W_{n-1} + X_n)`` with
  ``X_n = S_{n-1} - (A_n - A_{n-1})`` is max-plus linear: each message is
  the map ``w -> max(w + X_n, 0)``, segment heads are the constant map
  ``w -> 0``. Maps ``(u, v): w -> max(w + u, v)`` compose associatively:
  ``(u1, v1) . (u2, v2) = (u1 + u2, max(v1 + u2, v2))`` — so the whole
  multi-server pass is one associative scan with heads encoded as
  ``(-inf, 0)``; no per-segment bookkeeping at scan time.

Three implementations of the scan:

* ``segmented`` — numpy: segmented prefix sums plus a segmented running
  minimum computed densely per server row (``np.minimum.accumulate`` on a
  (servers, max-queue) grid; doubling-sweep fallback when the grid would
  blow up). Exact — matches ``loop`` to ~1e-12 relative.
* ``torch``     — the ``(u, v)`` elements scanned in float64 by plain
  PyTorch (``kernels.lindley_scan.lindley_scan_plain``) on the caller's
  device, eagerly and unpadded. Batches over a leading axis for
  ``simulate_batch``.
* ``kernel``    — ``repro_torch.kernels.lindley_scan``: the same elements
  through the hand-written CUDA kernel (float64 unless float32 is asked
  for); ragged stage rows go through ``lindley_scan_rows``.

Host/device split: routing, the ``(server, arrival)`` sorts, tie repair
and ``(u, v)`` assembly are numpy on the host; the device backends move
the stacked ``u`` rows to the device, scan there, and bring ``W`` back for
the numpy metrics. ``v`` is zero for every real element, so it is made on
the device instead of being moved. With a recorder installed the three
legs are timed (device-synchronised) into the wall counters
``sim.h2d_s`` / ``sim.scan_s`` / ``sim.d2h_s``.

Routing gives every message a *stage-0* server (cache / memory / its first
hierarchy hop — disjoint id spaces form the scan's per-level server axis)
and inter-node messages further stages along the ``NetworkHierarchy`` LCA
path (DESIGN.md §9): hierarchy hops merge greedily into multi-server
passes wherever no message takes two of them, so the default flat/TPU
configs still run as exactly two scans, and an L-level tree needs at most
2L regardless of cluster size. Each stage's arrivals are the previous
stage's departures (+ the LCA level's latency at the apex).

Per-workload host arrays (flattened messages, the arrival-time sort order)
are placement-independent; they are cached keyed on the live job set so the
scheduler's repeated ``simulate()`` calls only pay for routing + scanning.
"""
from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from .. import obs
from ..kernels.lindley_scan import (lindley_scan, lindley_scan_plain,
                                    lindley_scan_rows, pad_rows)
from .graphs import AppGraph, ClusterTopology, Placement
from .simulator import SimResult, resolve_device

_SPAN_FLOOR = 1e-30       # utilisation denominator floor (matches loop)
_DENSE_CUMMIN_CAP = 1 << 22   # max cells of the per-server min grid (32 MB)


def _count(name: str, v: float = 1) -> None:
    """Flat-assembly provenance counter on the installed recorder —
    distinguishes warm reuse / delta patches / cache hits / full builds."""
    rec = obs.current()
    if rec.enabled:
        rec.metrics.counter(name).inc(v)


# ---------------------------------------------------------------------------
# Workload flattening (placement-independent, cached per live job set)
# ---------------------------------------------------------------------------
class _WorkloadFlat:
    """Concatenated flat messages of one job set + arrival-time sort order.

    Pair-granular fields (``pair_*``) drive routing — there are orders of
    magnitude fewer communicating pairs than messages; ``pair_of`` expands
    pair-level results to messages with one gather.

    Two construction paths: the full build below, and the delta paths
    :meth:`with_job_added` / :meth:`with_job_removed` used by the
    scheduler's warm-start handle (``simulator.SimHandle``) — on a live
    fleet the job set changes by one job per event, so the concatenated
    arrays and the sorted time order are patched in O(M) (a block splice
    plus a sorted merge) instead of rebuilt with a fresh O(M log M)
    argsort.
    """

    def __init__(self, jobs: Sequence[AppGraph], count_scale: float):
        self.jobs = list(jobs)            # strong refs keep id() keys valid
        self.count_scale = count_scale
        job_rows, pair_ofs, emits = [], [], []
        p_src, p_dst, p_size = [], [], []
        msgs, pairs, procs = [], [], []
        proc_off = 0
        pair_off = 0
        for k, job in enumerate(jobs):
            fm = job.flat_messages(count_scale)
            msgs.append(fm.n_messages)
            pairs.append(fm.n_pairs)
            procs.append(job.n_procs)
            if fm.n_messages:
                job_rows.append(np.full(fm.n_messages, k, dtype=np.int32))
                pair_ofs.append(fm.pair_of.astype(np.int64) + pair_off)
                emits.append(fm.emit)
                p_src.append(fm.pair_src.astype(np.int64) + proc_off)
                p_dst.append(fm.pair_dst.astype(np.int64) + proc_off)
                p_size.append(fm.pair_size)
            proc_off += job.n_procs
            pair_off += fm.n_pairs
        self._set_blocks(msgs, pairs, procs)
        if emits:
            self.job_row = np.concatenate(job_rows)
            self.pair_of = np.concatenate(pair_ofs).astype(np.int32)
            self.emit = np.concatenate(emits)
            self.pair_src = np.concatenate(p_src)
            self.pair_dst = np.concatenate(p_dst)
            self.pair_size = np.concatenate(p_size)
            # stable time order: the placement-independent half of the
            # stable (server, arrival) sort every round-1 pass needs —
            # cached pre-permuted views keep per-call gathers narrow
            self.time_order = np.argsort(self.emit,
                                         kind="stable").astype(np.int32)
        else:
            # same field shape as the populated case so the delta paths
            # (and their differential tests) work from an empty flat too
            self.job_row = np.empty(0, dtype=np.int32)
            self.pair_of = np.empty(0, dtype=np.int32)
            self.emit = np.empty(0)
            self.pair_src = np.empty(0, dtype=np.int64)
            self.pair_dst = np.empty(0, dtype=np.int64)
            self.pair_size = np.empty(0)
            self.time_order = np.empty(0, dtype=np.int32)
        self._set_time_views()

    # -- shared finalisation ------------------------------------------------
    def _set_blocks(self, msgs, pairs, procs) -> None:
        """Per-job block sizes (messages / pairs / procs) + derived offsets."""
        self.job_msgs = np.asarray(msgs, dtype=np.int64)
        self.job_pairs = np.asarray(pairs, dtype=np.int64)
        self.job_procs = np.asarray(procs, dtype=np.int64)
        self.job_starts = np.concatenate(
            [[0], np.cumsum(self.job_msgs)[:-1]]).astype(np.int64)
        self.job_nonempty = self.job_msgs > 0
        self.offsets = {}
        off = 0
        for job, p in zip(self.jobs, self.job_procs):
            self.offsets[job.job_id] = off
            off += int(p)
        self.n_procs = off

    def _set_time_views(self) -> None:
        self.emit_t = self.emit[self.time_order]
        self.pair_of_t = self.pair_of[self.time_order]

    @property
    def n_messages(self) -> int:
        return int(self.emit.size)

    # -- delta construction (the scheduler's churn pattern) ------------------
    def with_job_added(self, job: AppGraph) -> "_WorkloadFlat":
        """New flat with ``job`` appended, reusing this flat's arrays.

        The job's cached block (``AppGraph.flat_messages``) is spliced on
        and its cached sorted order merged into ``time_order`` with one
        ``searchsorted`` — equal emit times keep stable-argsort semantics
        (old messages first, block order within the new job).
        """
        fm = job.flat_messages(self.count_scale)
        new = object.__new__(_WorkloadFlat)
        new.jobs = self.jobs + [job]
        new.count_scale = self.count_scale
        k = len(self.jobs)
        pair_off = int(self.pair_size.size)
        proc_off = self.n_procs
        if fm.n_messages:
            new.job_row = np.concatenate(
                [self.job_row, np.full(fm.n_messages, k, dtype=np.int32)])
            new.pair_of = np.concatenate(
                [self.pair_of,
                 (fm.pair_of.astype(np.int64) + pair_off).astype(np.int32)])
            new.emit = np.concatenate([self.emit, fm.emit])
            new.pair_src = np.concatenate(
                [self.pair_src, fm.pair_src.astype(np.int64) + proc_off])
            new.pair_dst = np.concatenate(
                [self.pair_dst, fm.pair_dst.astype(np.int64) + proc_off])
            new.pair_size = np.concatenate([self.pair_size, fm.pair_size])
            blk = fm.time_order
            blk_emit = fm.emit[blk]
            # merge two sorted runs; 'right' keeps ties stable (old first)
            at = np.searchsorted(self.emit_t, blk_emit, side="right")
            pos = at + np.arange(blk.size)
            order = np.empty(self.n_messages + blk.size, dtype=np.int32)
            mask = np.ones(order.size, dtype=bool)
            mask[pos] = False
            order[mask] = self.time_order
            order[pos] = blk + np.int32(self.n_messages)
            new.time_order = order
        else:
            new.job_row = self.job_row
            new.pair_of = self.pair_of
            new.emit = self.emit
            new.pair_src = self.pair_src
            new.pair_dst = self.pair_dst
            new.pair_size = self.pair_size
            new.time_order = self.time_order
        new._set_blocks(np.append(self.job_msgs, fm.n_messages),
                        np.append(self.job_pairs, fm.n_pairs),
                        np.append(self.job_procs, job.n_procs))
        new._set_time_views()
        return new

    def with_job_removed(self, job_id: int) -> "_WorkloadFlat":
        """New flat with ``job_id``'s block spliced out, arrays reused.

        Message/pair/proc indices of later jobs shift down by the removed
        block's sizes; ``time_order`` drops the block's entries and
        renumbers the survivors — all O(M) vector ops, no re-sort.
        """
        k = next(i for i, j in enumerate(self.jobs) if j.job_id == job_id)
        m0 = int(self.job_starts[k])
        m1 = m0 + int(self.job_msgs[k])
        p0 = int(self.job_pairs[:k].sum())
        p1 = p0 + int(self.job_pairs[k])
        nm, npair, nproc = m1 - m0, p1 - p0, int(self.job_procs[k])
        new = object.__new__(_WorkloadFlat)
        new.jobs = self.jobs[:k] + self.jobs[k + 1:]
        new.count_scale = self.count_scale
        new.job_row = np.concatenate(
            [self.job_row[:m0], self.job_row[m1:] - np.int32(1)])
        new.pair_of = np.concatenate(
            [self.pair_of[:m0], self.pair_of[m1:] - np.int32(npair)])
        new.emit = np.concatenate([self.emit[:m0], self.emit[m1:]])
        new.pair_src = np.concatenate(
            [self.pair_src[:p0], self.pair_src[p1:] - nproc])
        new.pair_dst = np.concatenate(
            [self.pair_dst[:p0], self.pair_dst[p1:] - nproc])
        new.pair_size = np.concatenate(
            [self.pair_size[:p0], self.pair_size[p1:]])
        keep = self.time_order < m0
        keep |= self.time_order >= m1
        order = self.time_order[keep].copy()
        order[order >= m1] -= np.int32(nm)
        new.time_order = order
        new._set_blocks(np.delete(self.job_msgs, k),
                        np.delete(self.job_pairs, k),
                        np.delete(self.job_procs, k))
        new._set_time_views()
        return new

    def core_table(self, placement: Placement) -> np.ndarray:
        """Per-(job, rank) global core id, aligned with pair_src/pair_dst."""
        table = np.empty(self.n_procs, dtype=np.int64)
        for job in self.jobs:
            off = self.offsets[job.job_id]
            table[off:off + job.n_procs] = placement.assignments[job.job_id]
        return table


_FLAT_CACHE: OrderedDict[tuple, _WorkloadFlat] = OrderedDict()
_FLAT_CACHE_SIZE = 8


def set_flat_cache_size(n: int) -> None:
    """Resize the shared flattening cache (entries, LRU).

    The default of 8 covers one scheduler's churn; a cell-sharded fleet
    (DESIGN.md §13) keeps one warm ``_WorkloadFlat`` per cell alive
    concurrently, so ``FleetScheduler`` widens the cache to
    ``2 * n_cells + 4`` at construction. Shrinking evicts LRU entries.
    """
    global _FLAT_CACHE_SIZE
    _FLAT_CACHE_SIZE = max(1, int(n))
    while len(_FLAT_CACHE) > _FLAT_CACHE_SIZE:
        _FLAT_CACHE.popitem(last=False)


def _delta_steps(prev: _WorkloadFlat, jobs: Sequence[AppGraph]):
    """(removed job_ids, appended jobs) turning ``prev`` into ``jobs``.

    The scheduler's churn pattern only: survivors keep their relative
    order and new jobs are appended at the tail. Returns ``None`` when
    ``jobs`` is not reachable that way (or the rebuild would be as
    expensive as starting fresh).
    """
    cur_ids = [id(j) for j in jobs]
    cur_set = set(cur_ids)
    prev_set = {id(j) for j in prev.jobs}
    survivors = [id(j) for j in prev.jobs if id(j) in cur_set]
    added = [j for j in jobs if id(j) not in prev_set]
    if survivors + [id(j) for j in added] != cur_ids:
        return None
    removed = [j.job_id for j in prev.jobs if id(j) not in cur_set]
    if len(removed) + len(added) > max(2, len(jobs) // 2):
        return None
    return removed, added


def flatten_delta(jobs: Sequence[AppGraph], count_scale: float,
                  prev: _WorkloadFlat | None = None) -> _WorkloadFlat:
    """Warm-start flatten: patch ``prev`` instead of rebuilding when the
    job set changed by a few departures and/or appended arrivals — the
    online scheduler's per-event churn (DESIGN.md §3).
    """
    jobs = list(jobs)
    if prev is not None and count_scale == prev.count_scale:
        if [id(j) for j in jobs] == [id(j) for j in prev.jobs]:
            _count("sim.flatten.reuse")
            return prev
        steps = _delta_steps(prev, jobs)
        if steps is not None:
            removed, added = steps
            flat = prev
            for jid in removed:
                flat = flat.with_job_removed(jid)
            for job in added:
                flat = flat.with_job_added(job)
            _cache_put(flat)
            _count("sim.flatten.delta")
            return flat
    return _flatten(jobs, count_scale)


def _cache_put(flat: _WorkloadFlat) -> None:
    key = (tuple(id(j) for j in flat.jobs), flat.count_scale)
    _FLAT_CACHE[key] = flat
    _FLAT_CACHE.move_to_end(key)
    while len(_FLAT_CACHE) > _FLAT_CACHE_SIZE:
        _FLAT_CACHE.popitem(last=False)


def _flatten(jobs: Sequence[AppGraph], count_scale: float) -> _WorkloadFlat:
    key = (tuple(id(j) for j in jobs), count_scale)
    flat = _FLAT_CACHE.get(key)
    if flat is None:
        flat = _WorkloadFlat(jobs, count_scale)
        _cache_put(flat)
        _count("sim.flatten.build")
    else:
        _FLAT_CACHE.move_to_end(key)
        _count("sim.flatten.cache_hit")
    return flat


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------
class _Stage:
    """One post-stage-0 multi-server Lindley pass, at PAIR granularity.

    Merged hierarchy hops with disjoint pair masks (and disjoint server
    id blocks), flattened into dense per-pair arrays.
    """

    __slots__ = ("mask", "sid", "service", "latency")

    def __init__(self, hops):
        self.mask = hops[0].mask.copy()
        self.sid = np.where(hops[0].mask, hops[0].server, 0)
        self.service = np.where(hops[0].mask, hops[0].service, 0.0)
        self.latency = np.where(hops[0].mask, hops[0].latency, 0.0)
        for h in hops[1:]:
            self.mask |= h.mask
            self.sid[h.mask] = h.server[h.mask]
            self.service[h.mask] = h.service[h.mask]
            self.latency[h.mask] = h.latency[h.mask]


def _route(cluster: ClusterTopology, s_core: np.ndarray, r_core: np.ndarray,
           size: np.ndarray):
    """Stage-0 server/service per message + later hierarchy stages.

    Server id spaces are disjoint so one scan covers any mix of levels:
    ``[0, N*S)`` cache sockets, then memory nodes, then one
    (level, direction) block per hierarchy hop (DESIGN.md §9 — the scan's
    per-level server axis). Stage 0 holds every message's FIRST server
    (cache / memory / first hierarchy hop with arrival == emit); each
    later stage is fed by the previous stage's departures.

    Returns ``(sid0, service0, stages)`` where ``stages`` is the list of
    post-stage-0 :class:`_Stage` passes in topological order.
    """
    node_map, sock_map, _ = cluster.core_maps()
    s_node = node_map[s_core]
    r_node = node_map[r_core]
    s_sock = sock_map[s_core]
    r_sock = sock_map[r_core]

    same_node = s_node == r_node
    same_sock = same_node & (s_sock == r_sock)
    via_cache = same_sock & (size <= cluster.cache_msg_cap)
    via_mem = same_node & ~via_cache
    inter = ~same_node

    n_sock = cluster.n_nodes * cluster.sockets_per_node
    sid1 = np.empty(size.size, dtype=np.int64)
    service = np.zeros(size.size, dtype=np.float64)

    if via_cache.any():
        sid1[via_cache] = s_node[via_cache] * cluster.sockets_per_node \
            + s_sock[via_cache]
        service[via_cache] = size[via_cache] / cluster.cache_bw
    if via_mem.any():
        penalty = np.where(s_sock[via_mem] != r_sock[via_mem],
                           1.0 + cluster.numa_remote_penalty, 1.0)
        sid1[via_mem] = n_sock + s_node[via_mem]
        service[via_mem] = size[via_mem] / cluster.mem_bw * penalty

    hier = cluster.net_hierarchy()
    hops = hier.pair_hops(s_core, r_core, size, n_cores=cluster.n_cores,
                          active=inter, server_base=n_sock + cluster.n_nodes)
    merged = hier.merge_stages(hops)
    first = merged[0] if merged else []
    placed = via_cache | via_mem
    for hop in first:
        sid1[hop.mask] = hop.server[hop.mask]
        service[hop.mask] = hop.service[hop.mask]
        placed |= hop.mask
    # messages whose first hop comes later (deep express configs), or that
    # cross no modelled level: park them on one zero-service bypass server
    # in stage 0 — waits stay exactly 0 there, the fast sorted path is
    # preserved, and their deliver time seeds the later stage correctly.
    if not placed.all():
        sid1[~placed] = int(sid1[placed].max(initial=0)) + 1 if placed.any() \
            else 0
    return sid1, service, [_Stage(h) for h in merged[1:]]


def _route_pairs(cluster: ClusterTopology, flat: _WorkloadFlat,
                 placement: Placement):
    """Route at pair granularity — all fields stay pair-level.

    Callers expand through ``flat.pair_of`` (or its sorted views) with
    one narrow gather wherever message granularity is actually needed.
    """
    cores = flat.core_table(placement)
    return _route(cluster, cores[flat.pair_src], cores[flat.pair_dst],
                  flat.pair_size)


def _round1_order(flat: _WorkloadFlat, sid1_p: np.ndarray):
    """Stable (server, arrival) order for round 1, built from cached
    pre-permuted views: one radix pass over narrow per-pair server ids.

    Returns (order, po_s, starts): original-index order, pair index per
    sorted message, segment-head mask.
    """
    if sid1_p.max() < np.iinfo(np.int16).max:
        sid1_p = sid1_p.astype(np.int16)    # radix sort + 2-byte gathers
    key_t = sid1_p[flat.pair_of_t]
    r = np.argsort(key_t, kind="stable").astype(np.int32)
    order = flat.time_order[r]
    po_s = flat.pair_of_t[r]
    starts = _segment_starts(key_t[r])
    return order, po_s, starts, r


# ---------------------------------------------------------------------------
# Stable (server, arrival) ordering
# ---------------------------------------------------------------------------
def _stable_sid_sort(sid: np.ndarray, time_order: np.ndarray) -> np.ndarray:
    """Stable-by-arrival order refined by server id (== np.lexsort, faster).

    Server ids are tiny, so the refining sort is an O(n) radix pass when
    they fit int16.
    """
    key = sid[time_order]
    if key.size and key.max() < np.iinfo(np.int16).max:
        key = key.astype(np.int16)
    return time_order[np.argsort(key, kind="stable")]


def _repair_ties(order: np.ndarray, sid_s: np.ndarray, arr_s: np.ndarray,
                 rank: np.ndarray | None = None) -> bool:
    """Reorder exact (server, arrival) tie runs to loop-backend semantics.

    Unstable sorts may leave messages with EQUAL arrival at the SAME
    server in arbitrary relative order; the loop backend's stable lexsort
    keeps flattening order. Tied runs are re-sorted in place by ascending
    ``rank[order]`` (original index when ``rank`` is None). Returns True
    if anything changed (caller must re-derive sorted views).
    """
    tie = (sid_s[1:] == sid_s[:-1]) & (arr_s[1:] == arr_s[:-1])
    if not tie.any():
        return False
    in_run = np.empty(order.size, dtype=bool)
    in_run[0] = False
    in_run[1:] = tie
    run_id = np.cumsum(~in_run)
    member = in_run.copy()
    member[:-1] |= tie                            # heads of tie runs too
    at = np.flatnonzero(member)
    key = order[at] if rank is None else rank[order[at]]
    fix = np.lexsort((key, run_id[at]))
    order[at] = order[at][fix]
    return True


def _order_by_server_arrival(sid: np.ndarray,
                             arrival: np.ndarray) -> np.ndarray:
    """(server, arrival)-sorted order with loop-backend tie semantics.

    An unstable float sort is ~5x faster than a stable one; stability only
    matters for the rare exactly-tied runs, repaired afterwards.
    """
    t_order = np.argsort(arrival)                 # unstable, fast
    order = _stable_sid_sort(sid, t_order)
    _repair_ties(order, sid[order], arrival[order])
    return order


# ---------------------------------------------------------------------------
# Segmented Lindley scans (inputs pre-sorted by (server, arrival))
# ---------------------------------------------------------------------------
def _segment_starts(sid_s: np.ndarray) -> np.ndarray:
    starts = np.empty(sid_s.size, dtype=bool)
    starts[0] = True
    np.not_equal(sid_s[1:], sid_s[:-1], out=starts[1:])
    return starts


def _increments(arr_s, srv_s, s_idx):
    """X_n per sorted message; 0 at segment heads (fresh server)."""
    x = np.empty(arr_s.size)
    x[0] = 0.0
    np.subtract(arr_s[1:], arr_s[:-1], out=x[1:])       # dA_n
    np.subtract(srv_s[:-1], x[1:], out=x[1:])           # S_{n-1} - dA_n
    x[s_idx] = 0.0
    return x


def _segmented_waits_numpy(arr_s, srv_s, starts):
    """W = M - running-min(M) per segment, M the segmented prefix sum of X.

    The per-segment offset of the GLOBAL prefix sum ``cs`` cancels in
    ``M - min M``, so W = cs - segmin(cs) directly.

    Fast path for segmin: scatter each segment onto its own row of a
    (servers, longest-queue) grid and run one dense
    ``np.minimum.accumulate``. When a skewed segment-length distribution
    would blow the grid up, fall back to doubling sweeps with an
    in-segment guard (after the sweep with step d, position i holds the
    min over ``[max(head_i, i - 2d + 1), i]`` — min never rounds, so both
    paths are exact).
    """
    n = arr_s.size
    s_idx = np.flatnonzero(starts)
    lens = np.diff(np.append(s_idx, n))
    cs = np.cumsum(_increments(arr_s, srv_s, s_idx))
    n_seg = s_idx.size
    width = int(lens.max())
    if n_seg * width <= max(4 * n, _DENSE_CUMMIN_CAP):
        # lin[i] = row_i * width + (i - head_i), built per segment
        rowbase = np.arange(n_seg, dtype=np.int64) * width - s_idx
        lin = (np.repeat(rowbase, lens)
               + np.arange(n, dtype=np.int64)).astype(np.int32)
        dense = np.full(n_seg * width, np.inf)
        dense[lin] = cs
        grid = dense.reshape(n_seg, width)
        np.minimum.accumulate(grid, axis=1, out=grid)
        return np.subtract(cs, dense[lin], out=cs)
    head = np.repeat(s_idx, lens)
    pos = np.arange(n) - head
    m = cs.copy()
    d = 1
    while d < width:
        cand = np.minimum(m[d:], m[:-d])
        m[d:] = np.where(pos[d:] >= d, cand, m[d:])
        d <<= 1
    return np.subtract(cs, m, out=cs)


def _u_elements(arr_s, srv_s, starts) -> np.ndarray:
    """``u`` of the max-plus scan elements: interior ``(X_n, 0)``, segment
    head ``(-inf, 0)``. ``v`` is zero for every real element, so callers
    make it where the scan runs instead of carrying it."""
    s_idx = np.flatnonzero(starts)
    u = _increments(arr_s, srv_s, s_idx)
    u[s_idx] = -np.inf
    return u


@contextlib.contextmanager
def _timed(name: str, device: torch.device):
    """Add the block's wall seconds to the wall counter ``name`` when a
    recorder is installed; the device is synchronised at both ends so the
    block's own device work is what is timed. Free when tracing is off."""
    rec = obs.current()
    if not rec.enabled:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rec.metrics.counter(name, wall=True).inc(time.perf_counter() - t0)


def _scan_rows(u: np.ndarray, scan, device: torch.device,
               dtype: torch.dtype) -> np.ndarray:
    """Move ``u`` (1-D or (K, M); ``v = 0`` throughout) to ``device`` as
    ``dtype``, run ``scan(u, v)`` there, bring ``W`` back as float64."""
    squeeze = u.ndim == 1
    with _timed("sim.h2d_s", device):
        ut = torch.from_numpy(u[None] if squeeze else u)
        ut = ut.to(device=device, dtype=dtype).contiguous()
    with _timed("sim.scan_s", device):
        w = scan(ut, torch.zeros_like(ut))
    with _timed("sim.d2h_s", device):
        out = w.to(device="cpu", dtype=torch.float64).numpy()
    return out[0] if squeeze else out


def _waits_torch(u: np.ndarray, device: torch.device) -> np.ndarray:
    """The ``torch`` backend's scan: plain PyTorch, float64, on ``device``."""
    return _scan_rows(u, lindley_scan_plain, device, torch.float64)


def _waits_kernel(u: np.ndarray, device: torch.device,
                  dtype: torch.dtype = torch.float64) -> np.ndarray:
    """The ``kernel`` backend's scan: the hand-written CUDA kernel through
    its wrapper (which takes the plain version only on a CPU device)."""
    return _scan_rows(u, lindley_scan, device, dtype)


def _waits_device(u: np.ndarray, backend: str, device: torch.device,
                  dtype: torch.dtype) -> np.ndarray:
    if backend == "torch":
        return _waits_torch(u, device)
    return _waits_kernel(u, device, dtype)


def _waits_ragged(us: list, backend: str, device: torch.device,
                  dtype: torch.dtype) -> list:
    """Scan rows of different lengths as one batch, padded with the
    max-plus identity past each real tail (DESIGN.md §9). On the
    ``kernel`` backend this is ``lindley_scan_rows``."""
    if backend == "torch":
        dtype = torch.float64
    with _timed("sim.h2d_s", device):
        rows = [(torch.from_numpy(u).to(device=device, dtype=dtype), None)
                for u in us]
    with _timed("sim.scan_s", device):
        if backend == "kernel":
            ws = lindley_scan_rows(rows)
        else:
            ub, vb, lens = pad_rows(rows)
            w = lindley_scan_plain(ub, vb)
            ws = [w[i, :n] for i, n in enumerate(lens)]
    with _timed("sim.d2h_s", device):
        return [w.to(device="cpu", dtype=torch.float64).numpy() for w in ws]


def _util_max(arr_s, srv_s, w_s, starts) -> float:
    """max over servers of busy/span — same definition as the loop backend."""
    s_idx = np.flatnonzero(starts)
    ends = np.append(s_idx[1:], arr_s.size)
    busy = np.add.reduceat(srv_s, s_idx)
    span = arr_s[ends - 1] + w_s[ends - 1] + srv_s[ends - 1] - arr_s[s_idx]
    return float((busy / np.maximum(span, _SPAN_FLOOR)).max())


def _pass_waits(arr_s, srv_s, starts, backend: str, device, dtype) -> np.ndarray:
    """Sorted-domain waits for one multi-server round on any backend."""
    if backend == "segmented":
        return _segmented_waits_numpy(arr_s, srv_s, starts)
    return _waits_device(_u_elements(arr_s, srv_s, starts), backend, device,
                         dtype)


# ---------------------------------------------------------------------------
# Whole-workload simulation
# ---------------------------------------------------------------------------
def _empty_result(jobs) -> SimResult:
    """Message-free workload: still key every job (zero-traffic jobs must
    not vanish from per-job metrics — the scheduler indexes them)."""
    zeros = {job.job_id: 0.0 for job in jobs}
    return SimResult(0.0, dict(zeros), 0.0, dict(zeros), 0.0, 0, 0.0)


def _metrics(jobs, flat: _WorkloadFlat, wait, deliver, util) -> SimResult:
    nj = len(jobs)
    # job_row is non-decreasing (jobs flattened in order), so per-job sums
    # and maxes are reduceats over cached contiguous blocks
    nonempty = flat.job_nonempty
    block = flat.job_starts[nonempty]
    per = np.zeros(nj)
    per[nonempty] = np.add.reduceat(wait, block)
    finish = np.zeros(nj)
    finish[nonempty] = np.maximum.reduceat(deliver, block)
    per_job_wait = {job.job_id: float(per[k]) for k, job in enumerate(jobs)}
    job_finish = {job.job_id: float(finish[k]) for k, job in enumerate(jobs)}
    return SimResult(
        total_wait=float(wait.sum()),
        per_job_wait=per_job_wait,
        workload_finish=float(deliver.max()),
        job_finish=job_finish,
        total_job_finish=float(sum(job_finish.values())),
        n_messages=int(wait.size),
        max_server_utilisation=float(util),
    )


def simulate_scan(jobs: Sequence[AppGraph], placement: Placement,
                  cluster: ClusterTopology | None = None,
                  count_scale: float = 1.0,
                  backend: str = "segmented",
                  flat: _WorkloadFlat | None = None,
                  device: Optional[torch.device] = None,
                  dtype: torch.dtype = torch.float64) -> SimResult:
    """Scan-backend equivalent of ``simulator.simulate`` (same metrics).

    ``flat`` lets a warm-start handle (``simulator.SimHandle``) pass a
    delta-assembled workload instead of going through the global cache.
    ``device`` is where the ``torch`` / ``kernel`` scans run (the host
    ``segmented`` backend ignores it); ``dtype`` is the ``kernel``
    backend's element type.
    """
    if backend != "segmented":
        device = resolve_device(device)
    cluster = cluster or placement.cluster
    placement.validate()
    if flat is None:
        flat = _flatten(jobs, count_scale)
    if flat.n_messages == 0:
        return _empty_result(jobs)
    sid1_p, service_p, stages = _route_pairs(cluster, flat, placement)

    # ---- stage 0: every message at its first server ----------------------
    order, po_s, starts, r = _round1_order(flat, sid1_p)
    arr_s = flat.emit_t[r]
    srv_s = service_p[po_s]
    w_s = _pass_waits(arr_s, srv_s, starts, backend, device, dtype)
    util = _util_max(arr_s, srv_s, w_s, starts)
    deliver_s = arr_s + w_s + srv_s
    n = flat.n_messages
    wait = np.empty(n)
    wait[order] = w_s
    deliver = np.empty(n)
    deliver[order] = deliver_s

    # ---- later stages: hierarchy hops fed by previous departures ---------
    for stage in stages:
        rows = np.flatnonzero(stage.mask[flat.pair_of])
        po = flat.pair_of[rows]
        arrive = deliver[rows] + stage.latency[po]
        srv2 = stage.service[po]
        sid2 = stage.sid[po]
        # FIFO departures are monotone per previous server, so ``arrive``
        # is a concatenation of ascending runs — timsort merges cheaply
        t2 = np.argsort(arrive, kind="stable")
        o2 = _stable_sid_sort(sid2, t2)
        sid2_s = sid2[o2]
        arr2_s = arrive[o2]
        # the stable sort above keeps prior-stage order on ties; the loop
        # backend keeps ORIGINAL order — repair the (rare) tied runs
        if _repair_ties(o2, sid2_s, arr2_s, rank=rows):
            sid2_s = sid2[o2]
            arr2_s = arrive[o2]
        starts2 = _segment_starts(sid2_s)
        srv2_s = srv2[o2]
        w2_s = _pass_waits(arr2_s, srv2_s, starts2, backend, device, dtype)
        util = max(util, _util_max(arr2_s, srv2_s, w2_s, starts2))
        rows2 = rows[o2]
        wait[rows2] += w2_s
        deliver[rows2] = arr2_s + w2_s + srv2_s
    return _metrics(jobs, flat, wait, deliver, util)


# ---------------------------------------------------------------------------
# Batched candidate evaluation (device backends)
# ---------------------------------------------------------------------------
def simulate_scan_batch(jobs: Sequence[AppGraph],
                        placements: Sequence[Placement],
                        cluster: ClusterTopology | None = None,
                        count_scale: float = 1.0,
                        backend: str = "torch",
                        flat: _WorkloadFlat | None = None,
                        device: Optional[torch.device] = None,
                        dtype: torch.dtype = torch.float64
                        ) -> list[SimResult]:
    """Score K placements of one job set with one batched scan per stage.

    Placements share jobs and message count M, so stage-0 rows stack into
    a dense (K, M) batch; later-stage row lengths differ per placement
    (routing differs, and deeper hierarchies differ in stage count) and
    are padded with identity elements past the real tail — the kernel's
    level/batch row axis (DESIGN.md §9). ``device`` / ``dtype`` as in
    :func:`simulate_scan`.
    """
    if not placements:
        return []
    device = resolve_device(device)
    cluster = cluster or placements[0].cluster
    if flat is None:
        flat = _flatten(jobs, count_scale)
    if flat.n_messages == 0:
        return [_empty_result(jobs) for _ in placements]
    for p in placements:
        p.validate()

    K = len(placements)
    rows = []                 # per-k state carried between stages
    u1 = np.empty((K, flat.n_messages))
    for k, p in enumerate(placements):
        sid1_p, service_p, stages = _route_pairs(cluster, flat, p)
        order, po_s, starts, r = _round1_order(flat, sid1_p)
        service = service_p[flat.pair_of]
        u1[k] = _u_elements(flat.emit_t[r], service_p[po_s], starts)
        rows.append({"service": service, "stages": stages,
                     "order": order, "starts": starts})

    w1 = _waits_device(u1, backend, device, dtype)
    results_state = []
    for k, st in enumerate(rows):
        order, starts = st["order"], st["starts"]
        arr_s, srv_s = flat.emit[order], st["service"][order]
        w_s = np.asarray(w1[k], dtype=np.float64)
        util = _util_max(arr_s, srv_s, w_s, starts)
        wait = np.empty_like(w_s)
        wait[order] = w_s
        deliver = flat.emit + wait + st["service"]
        results_state.append({"wait": wait, "deliver": deliver, "util": util})

    n_stages = max(len(st["stages"]) for st in rows)
    for si in range(n_stages):
        passes: list[dict | None] = [None] * K
        ragged: list[np.ndarray] = []
        for k, st in enumerate(rows):
            if si >= len(st["stages"]):
                continue
            stage = st["stages"][si]
            rs = results_state[k]
            idx2 = np.flatnonzero(stage.mask[flat.pair_of])
            if idx2.size == 0:
                continue
            po = flat.pair_of[idx2]
            arrive = rs["deliver"][idx2] + stage.latency[po]
            srv = stage.service[po]
            sid2 = stage.sid[po]
            order = _order_by_server_arrival(sid2, arrive)
            starts = _segment_starts(sid2[order])
            u = _u_elements(arrive[order], srv[order], starts)
            passes[k] = {"idx2": idx2, "arrive": arrive, "srv": srv,
                         "order": order, "starts": starts,
                         "row": len(ragged)}
            ragged.append(u)
        if not ragged:
            continue
        # stage rows are ragged (routing differs per placement) — pad
        # with the max-plus identity onto one batched row axis
        ws = _waits_ragged(ragged, backend, device, dtype)
        for k, p2 in enumerate(passes):
            if p2 is None:
                continue
            rs = results_state[k]
            idx2, order, starts = p2["idx2"], p2["order"], p2["starts"]
            arr_s, srv_s = p2["arrive"][order], p2["srv"][order]
            w_s = np.asarray(ws[p2["row"]], dtype=np.float64)
            rs["util"] = max(rs["util"],
                             _util_max(arr_s, srv_s, w_s, starts))
            w_rx = np.empty_like(w_s)
            w_rx[order] = w_s
            rs["wait"][idx2] += w_rx
            rs["deliver"][idx2] = p2["arrive"] + w_rx + p2["srv"]

    return [_metrics(jobs, flat, rs["wait"], rs["deliver"],
                     rs["util"]) for rs in results_state]
