"""Queueing simulator for message waiting times (paper section 5.1).

Re-implements the paper's Omnet++ testbed as a vectorised open-queueing
model. Every shared channel is a FIFO server:

* ``cache``  — one per socket, ``cache_bw``; only messages <= 1MB between
  cores of the same socket (paper Table 1 footnotes).
* ``mem``    — one per node, ``mem_bw``; intra-node messages (large
  same-socket messages included); +10% NUMA penalty across sockets.
* inter-node traffic queues along the cluster's explicit
  ``NetworkHierarchy`` (DESIGN.md §9): full-duplex TX/RX server pairs at
  every level the message crosses (core→chip→node→rack→pod, LCA path
  rule, express levels for direct-attached NICs). The default hierarchy
  reproduces the historical flat model exactly: per-node NIC TX ->
  (switch latency) -> NIC RX, with the TPU-fleet ICI/DCN split as a
  2-level node+express-pod instance.

Waiting time of a message is the time it spends queued before service at
each server on its path (the paper's main metric, summed over messages).

Implementation note — instead of an event loop we exploit that arrivals are
open-loop (processes emit at fixed rate irrespective of queue state), so
each server's waits follow Lindley's recursion
``W_n = max(0, W_{n-1} + S_{n-1} - (A_n - A_{n-1}))`` which vectorises as a
prefix-sum/prefix-min per server. NIC RX arrivals are TX departures +
switch latency, so the two passes stay acyclic. (The paper's single-server
NIC is split into full-duplex TX/RX servers — matching real InfiniBand
HCAs; see DESIGN.md §2.)

Backends (DESIGN.md §8):

* ``loop``      — the original per-server Python loop over Lindley slices.
  Kept as the bit-faithful reference and the benchmark baseline.
* ``segmented`` — numpy segmented max-plus scan over ALL servers at once
  (``repro_torch.core.sim_scan``); no per-server Python loop, flat-message cache.
* ``torch``     — the same max-plus elements scanned in float64 by plain
  PyTorch on ``device``; batches K candidate placements in one device
  call (``simulate_batch``).
* ``kernel``    — the hand-written CUDA kernel
  ``repro_torch.kernels.lindley_scan`` (float64 by default, float32 on
  request); on a CPU device its wrapper takes the plain version.
* ``auto``      — ``kernel`` when ``device`` is a CUDA card, ``segmented``
  when the caller asked for the CPU. ``REPRO_TORCH_SIM_BACKEND`` overrides.

Every entry point takes ``device=``. ``None`` means ``torch.device("cuda")``
and raises where CUDA is absent — nothing carries on on the CPU unasked.
The ``loop`` and ``segmented`` backends always compute on the host.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Sequence

import numpy as np
import torch

from .. import obs
from .graphs import AppGraph, ClusterTopology, Placement, tie_phase

BACKENDS = ("loop", "segmented", "torch", "kernel")
_DEVICE_BACKENDS = ("torch", "kernel")


def _record_sim(name: str, backend: str, n_msgs: int, n_jobs: int,
                wall: float, warm: bool, k: int = 1) -> None:
    """Per-call provenance on the installed recorder (DESIGN.md §11):
    one instant (timestamped on the caller-set sim clock) + aggregate
    counters. Call sites guard on ``recorder.enabled`` so the disabled
    path never reads the wall clock."""
    rec = obs.current()
    m = rec.metrics
    m.counter(f"sim.calls.{backend}").inc()
    m.counter("sim.msgs").inc(n_msgs * k)
    m.counter("sim.wall_s", wall=True).inc(wall)
    rec.instant(name, cat=obs.CAT_SIM, track="sim", backend=backend,
                n_msgs=n_msgs, n_jobs=n_jobs, k=k, warm=warm, wall=wall)


@dataclasses.dataclass
class SimResult:
    total_wait: float                      # seconds, summed over messages
    per_job_wait: dict[int, float]
    workload_finish: float                 # max delivery time (s)
    job_finish: dict[int, float]
    total_job_finish: float                # sum of job finish times (s)
    n_messages: int
    max_server_utilisation: float

    @property
    def total_wait_ms(self) -> float:
        return self.total_wait * 1e3


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is the CUDA card.

    Raises where CUDA is asked for (by name or by ``None``) and absent.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device=None means the CUDA card, and torch.cuda.is_available() "
            "is False; pass device='cpu' to compute on the host"
            if device is None else
            f"device {device!r} was asked for and torch.cuda.is_available() "
            f"is False")
    return dev


def resolve_backend(backend: str | None = None, device=None) -> str:
    """Resolve a backend name (``auto``/None/env override -> concrete).

    ``auto`` follows the device the caller gave: ``kernel`` on a CUDA
    card, the numpy ``segmented`` scan when the caller asked for the CPU
    (no launch or copy overhead to win back there).
    """
    backend = backend or "auto"
    dev = resolve_device(device)
    if backend == "auto":
        env = os.environ.get("REPRO_TORCH_SIM_BACKEND", "").strip()
        if env and env != "auto":
            backend = env
        else:
            backend = "kernel" if dev.type == "cuda" else "segmented"
    if backend not in BACKENDS:
        raise KeyError(f"unknown sim backend {backend!r}; known: {BACKENDS}")
    return backend


def _lindley_waits(arrival: np.ndarray, service: np.ndarray) -> np.ndarray:
    """FIFO waits for one server given sorted arrival and service times."""
    n = arrival.shape[0]
    if n == 0:
        return arrival
    x = service[:-1] - np.diff(arrival)           # X_n for n >= 1
    m = np.concatenate([[0.0], np.cumsum(x)])     # M_0 = 0
    return m - np.minimum.accumulate(m)           # W_n = M_n - min_{k<=n} M_k


def _server_pass(server_id: np.ndarray, arrival: np.ndarray,
                 service: np.ndarray):
    """Per-server Lindley pass (Python loop over servers — loop backend).

    Returns (wait, busy_per_server dict) aligned with the input order.
    """
    wait = np.zeros_like(arrival)
    if arrival.size == 0:
        return wait, {}
    order = np.lexsort((arrival, server_id))
    sid_sorted = server_id[order]
    arr_sorted = arrival[order]
    srv_sorted = service[order]
    wait_sorted = np.empty_like(arr_sorted)
    bounds = np.flatnonzero(np.diff(sid_sorted)) + 1
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [sid_sorted.size]])
    busy: dict[int, tuple[float, float]] = {}
    for s, e in zip(starts, ends):
        w = _lindley_waits(arr_sorted[s:e], srv_sorted[s:e])
        wait_sorted[s:e] = w
        span = (arr_sorted[e - 1] + w[-1] + srv_sorted[e - 1]) - arr_sorted[s]
        busy[int(sid_sorted[s])] = (float(srv_sorted[s:e].sum()), float(max(span, 1e-30)))
    wait[order] = wait_sorted
    return wait, busy


def simulate(jobs: Sequence[AppGraph], placement: Placement,
             cluster: ClusterTopology | None = None,
             count_scale: float = 1.0, backend: str = "auto",
             device=None) -> SimResult:
    """Run the queueing model for a placed workload.

    ``count_scale`` scales every pair's message count (e.g. 0.1 -> 10x fewer
    messages) for faster experimentation; relative comparisons between
    mapping strategies are preserved. ``backend`` selects the Lindley-pass
    implementation (module docstring); all backends agree on the metrics to
    float tolerance. ``device`` is where the ``torch`` / ``kernel`` scans
    run (``None``: the CUDA card).
    """
    device = resolve_device(device)
    backend = resolve_backend(backend, device)
    traced = obs.current().enabled
    t0 = time.perf_counter() if traced else 0.0
    if backend == "loop":
        res = _simulate_loop(jobs, placement, cluster, count_scale)
    else:
        from . import sim_scan
        res = sim_scan.simulate_scan(jobs, placement, cluster, count_scale,
                                     backend=backend, device=device)
    if traced:
        _record_sim("simulate", backend, res.n_messages, len(jobs),
                    time.perf_counter() - t0, warm=False)
    return res


def simulate_batch(jobs: Sequence[AppGraph], placements: Sequence[Placement],
                   cluster: ClusterTopology | None = None,
                   count_scale: float = 1.0,
                   backend: str = "auto",
                   device=None) -> list[SimResult]:
    """Score K candidate placements of the SAME job set in one shot.

    The scheduler's remap pass uses this to evaluate many trial moves per
    pass. On the ``torch`` and ``kernel`` backends the K per-placement
    Lindley passes are stacked and run as ONE batched scan per stage
    (ragged later stages pad onto the kernel row axis); numpy backends
    fall back to a fast per-placement loop that still reuses the
    flat-message cache (flattening is the dominant host cost).
    """
    device = resolve_device(device)
    backend = resolve_backend(backend, device)
    if backend in _DEVICE_BACKENDS:
        from . import sim_scan
        traced = obs.current().enabled
        t0 = time.perf_counter() if traced else 0.0
        out = sim_scan.simulate_scan_batch(jobs, placements, cluster,
                                           count_scale, backend=backend,
                                           device=device)
        if traced:
            _record_sim("simulate_batch", backend,
                        out[0].n_messages if out else 0, len(jobs),
                        time.perf_counter() - t0, warm=False,
                        k=len(placements))
        return out
    # numpy fallback: each per-placement simulate records itself
    return [simulate(jobs, p, cluster, count_scale, backend=backend,
                     device=device)
            for p in placements]


class SimHandle:
    """Warm-start handle for repeated simulation over a churning live set.

    The online scheduler re-simulates the live workload after EVERY fleet
    mutation (admit / depart / remap commit — DESIGN.md §3); a cold
    ``simulate()`` call re-concatenates and re-sorts the whole flattened
    workload each time. The handle pins the previous ``_WorkloadFlat`` and
    asks ``sim_scan.flatten_delta`` for a patched assembly — departed
    jobs' message blocks spliced out, arrived jobs' cached blocks merged
    into the sorted time order in O(M) — so each re-clock only pays for
    routing and the scans themselves. Results are identical to cold calls
    on every backend (the delta arrays are bit-equal to a full rebuild).
    """

    def __init__(self, cluster: ClusterTopology | None = None,
                 count_scale: float = 1.0, backend: str = "auto",
                 device=None):
        self.cluster = cluster
        self.count_scale = count_scale
        self.device = resolve_device(device)
        self.backend = resolve_backend(backend, self.device)
        self._flat = None

    def _warm_flat(self, jobs: Sequence[AppGraph]):
        from . import sim_scan
        self._flat = sim_scan.flatten_delta(jobs, self.count_scale,
                                            prev=self._flat)
        return self._flat

    def simulate(self, jobs: Sequence[AppGraph],
                 placement: Placement) -> SimResult:
        traced = obs.current().enabled
        warm = self._flat is not None
        t0 = time.perf_counter() if traced else 0.0
        if self.backend == "loop":
            res = _simulate_loop(jobs, placement, self.cluster,
                                 self.count_scale)
        else:
            from . import sim_scan
            res = sim_scan.simulate_scan(
                jobs, placement, self.cluster, self.count_scale,
                backend=self.backend, device=self.device,
                flat=self._warm_flat(jobs))
        if traced:
            _record_sim("simulate", self.backend, res.n_messages,
                        len(jobs), time.perf_counter() - t0, warm=warm)
        return res

    def simulate_batch(self, jobs: Sequence[AppGraph],
                       placements: Sequence[Placement]) -> list[SimResult]:
        if self.backend in _DEVICE_BACKENDS:
            from . import sim_scan
            traced = obs.current().enabled
            warm = self._flat is not None
            t0 = time.perf_counter() if traced else 0.0
            out = sim_scan.simulate_scan_batch(
                jobs, placements, self.cluster, self.count_scale,
                backend=self.backend, device=self.device,
                flat=self._warm_flat(jobs))
            if traced:
                _record_sim("simulate_batch", self.backend,
                            out[0].n_messages if out else 0, len(jobs),
                            time.perf_counter() - t0, warm=warm,
                            k=len(placements))
            return out
        # numpy fallback: each per-placement simulate records itself
        return [self.simulate(jobs, p) for p in placements]


def _simulate_loop(jobs: Sequence[AppGraph], placement: Placement,
                   cluster: ClusterTopology | None = None,
                   count_scale: float = 1.0) -> SimResult:
    cluster = cluster or placement.cluster
    placement.validate()

    # ---- flatten all messages into arrays -------------------------------
    job_ids, senders, receivers, sizes, emits = [], [], [], [], []
    for job in jobs:
        cores = placement.assignments[job.job_id]
        src, dst = np.nonzero(job.cnt)
        for i, j in zip(src, dst):
            n = max(1, int(round(job.cnt[i, j] * count_scale)))
            rate = job.lam[i, j]
            period = 1.0 / rate if rate > 0 else 0.0
            # deterministic per-(job, sender) phase breaks simultaneous ticks
            phase = float(tie_phase(job.job_id, int(i)))
            t = phase + np.arange(n) * period
            emits.append(t)
            job_ids.append(np.full(n, job.job_id, dtype=np.int32))
            senders.append(np.full(n, cores[i], dtype=np.int32))
            receivers.append(np.full(n, cores[j], dtype=np.int32))
            sizes.append(np.full(n, job.L[i, j], dtype=np.float64))
    if not emits:
        from .sim_scan import _empty_result
        return _empty_result(jobs)
    emit = np.concatenate(emits)
    job_id = np.concatenate(job_ids)
    s_core = np.concatenate(senders)
    r_core = np.concatenate(receivers)
    size = np.concatenate(sizes)
    M = emit.size

    s_node = cluster.node_of(s_core)
    r_node = cluster.node_of(r_core)
    s_sock = cluster.socket_of(s_core)
    r_sock = cluster.socket_of(r_core)

    same_node = s_node == r_node
    same_sock = same_node & (s_sock == r_sock)
    via_cache = same_sock & (size <= cluster.cache_msg_cap)
    via_mem = same_node & ~via_cache
    inter = ~same_node

    wait = np.zeros(M)
    deliver = np.empty(M)
    util: list[float] = []

    # ---- cache servers (per socket) --------------------------------------
    if via_cache.any():
        idx = np.flatnonzero(via_cache)
        sid = s_node[idx] * cluster.sockets_per_node + s_sock[idx]
        service = size[idx] / cluster.cache_bw
        w, busy = _server_pass(sid, emit[idx], service)
        wait[idx] += w
        deliver[idx] = emit[idx] + w + service
        util += [b / s for b, s in busy.values()]

    # ---- memory servers (per node) ----------------------------------------
    if via_mem.any():
        idx = np.flatnonzero(via_mem)
        penalty = np.where(s_sock[idx] != r_sock[idx],
                           1.0 + cluster.numa_remote_penalty, 1.0)
        service = size[idx] / cluster.mem_bw * penalty
        w, busy = _server_pass(s_node[idx].astype(np.int64), emit[idx], service)
        wait[idx] += w
        deliver[idx] = emit[idx] + w + service
        util += [b / s for b, s in busy.values()]

    # ---- inter-node: hierarchy LCA path (DESIGN.md §9) ---------------------
    # One Lindley pass per hop in topological order (TX inner→outer, RX
    # outer→inner); each message's arrival at a hop is its departure from
    # the previous hop, plus the LCA level's latency once at the apex.
    if inter.any():
        idx = np.flatnonzero(inter)
        hops = cluster.net_hierarchy().pair_hops(
            s_core[idx], r_core[idx], size[idx], n_cores=cluster.n_cores)
        cur = emit[idx].copy()
        for hop in hops:
            m = hop.mask
            service = hop.service[m]
            arrive = cur[m] + hop.latency[m]
            w, busy = _server_pass(hop.server[m], arrive, service)
            wait[idx[m]] += w
            cur[m] = arrive + w + service
            util += [b / s for b, s in busy.values()]
        deliver[idx] = cur

    # ---- metrics -----------------------------------------------------------
    per_job_wait: dict[int, float] = {}
    job_finish: dict[int, float] = {}
    for job in jobs:
        mask = job_id == job.job_id
        per_job_wait[job.job_id] = float(wait[mask].sum())
        job_finish[job.job_id] = float(deliver[mask].max())
    return SimResult(
        total_wait=float(wait.sum()),
        per_job_wait=per_job_wait,
        workload_finish=float(deliver.max()),
        job_finish=job_finish,
        total_job_finish=float(sum(job_finish.values())),
        n_messages=int(M),
        max_server_utilisation=float(max(util)) if util else 0.0,
    )
