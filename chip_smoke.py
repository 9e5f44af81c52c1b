#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every hand-written kernel from the sources in this checkout (one
``nvcc`` per source, all at once), holds each against its plain PyTorch
version on the card (phase 3: K1 bit for bit; K3 through both of its
instances where both take the case, the bf16 ones timed in turns, wgmma /
general / general / wgmma), then drives the port's paths at full size:

* phase 4, the paper's path — the Table-4 workload at ``count_scale=1.0``
  (4.34 M messages) on the 16-node x 16-core cluster: mapping ->
  ``simulate`` -> ``simulate_batch`` (K = 16) -> ``search_placement``,
  checked against the port's host ``segmented`` backend;
* phase 5, serving — qwen3-0.6b at its published widths in bfloat16 with
  weights from a seeded generator: ``Model.prefill`` on 4 x 2048 and
  1 x 1000 tokens and a ``ServeEngine`` serving 16 greedy requests, the
  kernel launches counted over these runs alone; then the checks: the
  engine's tokens against a manual decode loop, the prefill logits against
  the plain-PyTorch twin in bfloat16, prefill/decode consistency against
  the twin's own, and the same weights in float32 against the twin;
* phase 6, SSM serving — mamba2-370m at its published widths in bfloat16
  (48 Mamba2 layers, the SSD scan through K3's wgmma instance, once a layer
  in each prefill, never in decode): the same prefills and engine, counted
  the same way, with K3's share of each prefill's device time; the float32
  model runs K3's general instance and the plain twins no kernel; then the
  kernel model against its plain twin, in bfloat16 and with the same
  weights in float32: every layer on the twin's
  input (output, SSM state, conv window), the float32 prefill logits and
  prefill/decode consistency (which hands K3's final state to the decode
  recurrence), the bfloat16 logits and consistency at the first layer
  (over all 48 random layers bfloat16 rounding grows to a third of the
  logits' scale, so there they are reported only), the engine's first
  step and its tokens. The engine is not held to a manual decode loop
  here: admitting a prompt advances every other slot's SSM state, in the
  reference's engine too;
* phase 7, the online fleet scheduler — ``FleetScheduler(device=None)``
  (every re-simulation through K1) with ``check_invariants()`` after every
  event: ``table4_poisson`` under each one-shot strategy (beside a host
  ``segmented`` run), ``rack_oversub`` with the remap search, the reference
  fault trace under each recovery policy (one with a joint-admission
  window), ``serve_slo`` with the autoscaler and ``fleet1k`` at 2,048
  arrivals on 1,024 nodes in nested pod/rack cells. Each run is repeated on
  the same card on the ``torch`` backend (plain PyTorch, no K1; fleet1k's
  pair on its first 512 arrivals) and must decide identically, with a
  byte-identical flight-recorder dump and equal ``FleetStats``: the plain
  scan composes in K1's order, so the two give the same bits. Each run
  reports its wall time, events, scans, K1 launches and the card's idle
  share (CUDA events around each scan's copies and launches); K1 is then
  timed at the scheduler's row sizes;
* phase 8, the fleet planner (``core.meshplan``) on the 512-chip 2-pod
  fleet — the quickstart's phi3.5-moe plan under the six default
  strategies (perms bijective, ``new_tpu`` no worse on NIC load and DCN
  bytes than ``blocked``), ``examples/multi_job_placement.py``'s three jobs
  placed under six strategies (``search:new_tpu`` scoring through K1) and
  simulated at ``count_scale=1.0`` on the card against the host
  ``segmented`` backend, and the ``serve_fleet`` trace (12 arrivals) in
  ``FleetScheduler(device=None)`` under four strategies, each run held to
  its ``torch`` twin as in phase 7.

Needs a CUDA card and ``nvcc``; exits non-zero when either is missing or
any phase fails. The last line of standard output is ``{"ok": true,
"device": {...}}``; the line before it lists the kernels with their
measured times, launch counts and roofline bounds.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch import obs  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.core import ClusterTopology, mapping, meshplan, sim_scan, workloads  # noqa: E402
from repro_torch.core.simulator import simulate, simulate_batch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import lindley_scan as ls  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.sched import (AdmissionConfig, AutoscaleConfig, CellConfig,  # noqa: E402
                               FleetScheduler, RecoveryConfig, RemapConfig,
                               SchedulerConfig, get_trace, reference_fault_trace)
from repro_torch.search import search_placement  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet): the roofline bounds
# below are stated against these whatever the card's power limit. bf16 is
# the tensor cores' dense rate; float32 / float64 are the CUDA cores'.
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12, torch.bfloat16: 989e12}
KERNELS = ("lindley_scan", "flash_attention", "rmsnorm", "ssd_scan")
#: combine = add, add, max per element, plus the final max(U, V)
FLOPS_PER_ELEMENT = 4

N_FULL = 4_340_000          # Table 4 at count_scale = 1.0
K_FULL = 16
TOL = {torch.float64: 1e-9, torch.float32: 2e-3}
SIM_TOL = 1e-9
# Per-job waits against the host ``segmented`` backend only: that backend
# takes W = cs - segmin(cs) from ONE prefix sum over all servers, so under
# sustained overload (Table 4 under ``blocked`` runs its NICs at utilisation
# 1.0, partial sums of ~1e3 s) a light job's small wait carries the rounding
# of the largest partial sums. The max-plus scan has no such cancellation.
# 1e-6 is what the reference's own differential tests hold saturated loads
# to; every other metric, and per-job waits against the host's plain
# max-plus scan, stay at 1e-9.
SEGMENTED_PER_JOB_TOL = 1e-6


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# phase 3 helpers: kernel vs plain version
# ---------------------------------------------------------------------------
def make_rows(gen: torch.Generator, b: int, n: int, dtype, device):
    """Scan elements like the simulator's: u = service - inter-arrival gap,
    heads (-inf, 0) at a per-row density (many short queues ... one long
    queue), v = 0, and an identity tail (0, -inf) on every other row."""
    u = torch.rand((b, n), generator=gen, device=device, dtype=torch.float64)
    u = u * 1.6 - 0.9
    dens = torch.tensor([5e-2, 1e-3, 1e-5], device=device,
                        dtype=torch.float64)[torch.arange(b, device=device) % 3]
    heads = torch.rand((b, n), generator=gen, device=device,
                       dtype=torch.float64) < dens[:, None]
    heads[:, 0] = True
    u[heads] = float("-inf")
    v = torch.zeros_like(u)
    for i in range(1, b, 2):
        pad = (n // 7) * (i % 3)
        if pad:
            u[i, n - pad:] = 0.0
            v[i, n - pad:] = float("-inf")
    return u.to(dtype).contiguous(), v.to(dtype).contiguous()


def rel_err(got: torch.Tensor, want: torch.Tensor, floor: float):
    """max |got - want| / max(|want|, floor) and max |got - want|.

    Every element's W is compared relatively; a wait smaller than one
    typical increment (``floor`` = mean |u| of the finite elements) is
    compared against that increment, since W = max(U, V) of sums of
    increments and a difference of association order is of the order of
    eps x the increments summed, not of eps x a wait that happens to be
    near zero."""
    if torch.isnan(got).any() or torch.isnan(want).any():
        fail("NaN in a scan result")
    same_inf = torch.isinf(want) & (got == want)
    diff = torch.where(same_inf, torch.zeros_like(got), (got - want).abs())
    rel = diff / want.abs().clamp_min(floor)
    return float(rel.max()), float(diff.max())


def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` warm launches."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20) -> float:
    """Device time of ``fn`` per call: CUDA events around ``reps`` calls
    queued behind a sleep kernel, so that the host has issued every call
    before the card reaches the first. Unlike :func:`time_ms` this leaves
    out the host's issue time (the gaps between back-to-back kernels stay
    in). The sleep is lengthened until it outlasts the issue. (A
    ``torch.profiler`` trace lost kernels of single calls on the card.)"""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 22
    for _ in range(6):
        begin, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        begin.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        issue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if issue_ms < 0.8 * begin.elapsed_time(start):
            return start.elapsed_time(end) / reps
        cycles *= 4
    fail("device_ms: the host could not issue the calls ahead of the card")


def bound_ms(b: int, n: int, dtype) -> tuple[float, str, int]:
    """Least time the card could take: each input read once, the output
    written once, against the operations at the type's peak rate."""
    nbytes = 3 * b * n * torch.empty((), dtype=dtype).element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = FLOPS_PER_ELEMENT * b * n / FLOPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def check_kernels(device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    timed: dict = {}
    worst = {torch.float64: 0.0, torch.float32: 0.0}
    shapes = [(K_FULL, N_FULL), (1, N_FULL), (64, 100_003), (3, 7)]
    for dtype in (torch.float64, torch.float32):
        for b, n in shapes:
            u, v = make_rows(gen, b, n, dtype, device)
            floor = float(u[torch.isfinite(u)].abs().mean()) if n > 1 else 1.0
            got = ls.lindley_scan(u, v)
            torch.cuda.synchronize()
            want = ls.lindley_scan_plain(u, v)
            torch.cuda.synchronize()
            rel, abs_err = rel_err(got, want, floor)
            bits = torch.int64 if dtype == torch.float64 else torch.int32
            row = {"shape": [b, n], "dtype": str(dtype).split(".")[-1],
                   "max_rel_err": rel, "max_abs_err": abs_err, "tol": TOL[dtype],
                   # the plain version composes in the kernel's order
                   "bit_identical": bool(torch.equal(got.view(bits), want.view(bits)))}
            # the small shapes are timed too: at (3, 7) the kernel's time is
            # the fixed cost of its launches, which the one-row time is read against
            row["ms"] = time_ms(lambda: ls.lindley_scan(u, v), reps=9)
            if n == N_FULL:
                row["device_ms"] = device_ms(lambda: ls.lindley_scan(u, v))
                row["plain_ms"] = time_ms(lambda: ls.lindley_scan_plain(u, v),
                                          reps=3)
                row["bound_ms"], row["bound_by"], row["bytes"] = bound_ms(b, n, dtype)
                timed[(b, dtype)] = row
            say("kernels", kernel="lindley_scan", **row)
            if not (rel <= TOL[dtype] and row["bit_identical"]):
                fail(f"lindley_scan disagrees with its plain version: {row}")
            worst[dtype] = max(worst[dtype], rel)
            del u, v, got, want
        # ragged rows through lindley_scan_rows, v left implicit on some rows
        lens = [100_003, 1, 77_777, 2_049, 1_792, 50_000]
        rows = []
        for i, n in enumerate(lens):
            u, v = make_rows(gen, 1, n, dtype, device)
            rows.append((u[0], None if i % 2 else torch.zeros_like(u[0])))
        got_rows = ls.lindley_scan_rows(rows)
        torch.cuda.synchronize()
        for (u, _), got in zip(rows, got_rows):
            want = ls.lindley_scan_plain(u[None], torch.zeros_like(u[None]))[0]
            rel, _ = rel_err(got, want, 0.5)
            if got.shape != u.shape or not rel <= TOL[dtype]:
                fail(f"lindley_scan_rows disagrees on a row of {u.shape[0]}: {rel}")
        # every element a head: W = 0 throughout, and no NaN
        u = torch.full((2, 100_003), float("-inf"), dtype=dtype, device=device)
        w = ls.lindley_scan(u, torch.zeros_like(u))
        torch.cuda.synchronize()
        if not torch.equal(w, torch.zeros_like(w)):
            fail("all-heads rows do not scan to W = 0")
        say("kernels", kernel="lindley_scan", dtype=str(dtype).split(".")[-1],
            ragged_rows=lens, all_heads="ok", worst_rel_err=worst[dtype])
    return timed


# ---------------------------------------------------------------------------
# phase 4 helpers: the main path at full size
# ---------------------------------------------------------------------------
def results_agree(a, b, what: str, per_job_tol: float = SIM_TOL) -> None:
    def close(x, y, tol=SIM_TOL):
        return abs(x - y) <= tol * max(abs(y), 1.0)
    ok = (a.n_messages == b.n_messages
          and close(a.total_wait, b.total_wait)
          and close(a.workload_finish, b.workload_finish)
          and close(a.total_job_finish, b.total_job_finish)
          and abs(a.max_server_utilisation - b.max_server_utilisation) <= 1e-6
          and all(close(a.job_finish[j], b.job_finish[j])
                  and close(a.per_job_wait[j], b.per_job_wait[j], per_job_tol)
                  for j in b.job_finish))
    if not ok:
        fail(f"{what}: results disagree beyond {SIM_TOL}: {a} vs {b}")


def trial_placements(placement, k: int, seed: int = 0):
    """K deterministic trial moves: one job's cores permuted per trial."""
    rng = np.random.default_rng(seed)
    ids = sorted(placement.assignments)
    trials = []
    for i in range(k):
        p = placement.copy()
        cores = p.assignments[ids[i % len(ids)]].copy()
        rng.shuffle(cores)
        p.assign(ids[i % len(ids)], cores)
        trials.append(p)
    return trials


def main_path(device) -> dict:
    """Drive mapping -> simulate -> simulate_batch -> search_placement at
    full size (Table 4 at ``count_scale=1.0``)."""
    jobs = workloads.synt_workload_3()
    cluster = ClusterTopology()
    sim = dict(count_scale=1.0)
    launches = {}

    # -- one-shot strategies: place, simulate on the card, check on the host
    waits, placements = {}, {}
    before = ls.launch_count
    for name in mapping.ONE_SHOT_STRATEGIES:
        placements[name] = mapping.STRATEGIES[name](jobs, cluster)
        t0 = time.perf_counter()
        res = simulate(jobs, placements[name], cluster, backend="auto",
                       device=device, **sim)
        wall = time.perf_counter() - t0
        host = simulate(jobs, placements[name], cluster, backend="segmented",
                        device="cpu", **sim)
        results_agree(res, host, f"simulate[{name}] kernel vs host segmented",
                      per_job_tol=SEGMENTED_PER_JOB_TOL)
        plain = simulate(jobs, placements[name], cluster, backend="torch",
                         device="cpu", **sim)
        results_agree(res, plain, f"simulate[{name}] kernel vs host plain scan")
        if not (np.isfinite(res.total_wait) and res.n_messages == N_FULL):
            fail(f"simulate[{name}] gave {res}")
        waits[name] = res.total_wait
        say("main_path", step="simulate", strategy=name, backend="kernel",
            n_messages=res.n_messages, total_wait_s=res.total_wait,
            workload_finish_s=res.workload_finish,
            max_server_utilisation=res.max_server_utilisation, wall_s=wall,
            per_job_wait_max_rel_diff_vs_segmented=max(
                abs(res.per_job_wait[j] - host.per_job_wait[j])
                / max(abs(host.per_job_wait[j]), 1.0) for j in host.per_job_wait))
    launches["simulate_each"] = (ls.launch_count - before) / len(waits)
    say("main_path", step="strategies", total_wait_s=waits,
        new_beats_blocked=waits["new"] < waits["blocked"])
    if not waits["new"] < waits["blocked"]:
        fail("the paper's mapping does not beat blocked on Table 4")

    # -- simulate_batch, K = 16, with the host / copy / scan split
    trials = trial_placements(placements["new"], K_FULL)
    simulate_batch(jobs, trials[:1], cluster, backend="auto", device=device,
                   **sim)
    before = ls.launch_count
    with obs.recording() as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = simulate_batch(jobs, trials, cluster, backend="auto",
                               device=device, **sim)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    launches["simulate_batch"] = ls.launch_count - before
    legs = rec.metrics.to_dict(include_wall=True)
    h2d, scan, d2h = (legs[k]["total"] for k in
                      ("sim.h2d_s", "sim.scan_s", "sim.d2h_s"))
    split = {"total_s": total, "host_assembly_s": total - h2d - scan - d2h,
             "h2d_s": h2d, "scan_s": scan, "d2h_s": d2h,
             "scan_calls": legs["sim.scan_s"]["n"]}
    say("main_path", step="simulate_batch", k=K_FULL, n_messages=N_FULL,
        backend="kernel", launches=launches["simulate_batch"], **split)
    for i, (res, p) in enumerate(zip(batch, trials)):
        single = simulate(jobs, p, cluster, backend="auto", device=device,
                          **sim)
        results_agree(res, single, f"simulate_batch[{i}] vs single call")
    t0 = time.perf_counter()
    host_batch = simulate_batch(jobs, trials, cluster, backend="segmented",
                                device="cpu", **sim)
    host_total = time.perf_counter() - t0
    for i, (res, host) in enumerate(zip(batch, host_batch)):
        results_agree(res, host, f"simulate_batch[{i}] vs host segmented",
                      per_job_tol=SEGMENTED_PER_JOB_TOL)
    say("main_path", step="simulate_batch_host_segmented", k=K_FULL,
        total_s=host_total)

    # -- search at its default resolution, against the host trajectory
    before = ls.launch_count
    t0 = time.perf_counter()
    found = search_placement(jobs, cluster, seed="new", budget=240, rng_seed=0,
                             device=device)
    wall = time.perf_counter() - t0
    launches["search_placement"] = ls.launch_count - before
    t0 = time.perf_counter()
    host_found = search_placement(jobs, cluster, seed="new", budget=240,
                                  rng_seed=0, backend="segmented", device="cpu")
    host_wall = time.perf_counter() - t0
    if (found.trajectory != host_found.trajectory
            or found.objective != host_found.objective
            or found.objective > found.seed_objective):
        fail(f"search trajectories differ: {found.trajectory} vs "
             f"{host_found.trajectory}")
    say("main_path", step="search_placement", budget=240,
        evaluations=found.evaluations, accepted=found.accepted,
        objective=found.objective, seed_objective=found.seed_objective,
        objective_scale=found.objective_scale, wall_s=wall,
        host_segmented_wall_s=host_wall,
        launches=launches["search_placement"])
    return {"launches": launches, "split": split}


# ---------------------------------------------------------------------------
# phase 3 helpers: flash attention and RMSNorm vs their plain versions
# ---------------------------------------------------------------------------
DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16",
              torch.float64: "float64"}
#: the tolerances of tests/test_kernels.py:40-49 (and of the RMSNorm sweep)
MODEL_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: (name, B, Sq, Skv, H, KVH, D, causal, q_offset); "path" is qwen3-0.6b's
#: per-layer call in the 4 x 2048 prefill, "ragged" its call in the 1 x 1000
#: prefill (both timed). bf16 runs on the TMA / wgmma kernel, float32 on the
#: CUDA-core one
ATTN_CASES = [
    ("path", 4, 2048, 2048, 16, 8, 128, True, 0),
    ("ragged", 1, 1000, 1000, 16, 8, 128, True, 0),
    ("continuation", 1, 64, 256, 16, 8, 128, True, 192),
    ("full", 2, 512, 512, 16, 8, 128, False, 0),
    ("mqa", 2, 512, 512, 16, 1, 128, True, 0),
    ("d64", 2, 512, 512, 16, 8, 64, True, 0),
    ("d112", 1, 512, 512, 32, 32, 112, True, 0),
]
TIMED_ATTN = ("path", "ragged")
#: (rows, d): ln1 / ln2 / final-norm rows and qk-norm rows of the 4 x 2048
#: prefill, mamba2's gated-norm rows (d_inner 2048) of the same prefill, then
#: the widths of other configs that are not powers of two
NORM_CASES = [(8192, 1024), (131072, 128), (8192, 2048), (7, 3584), (5, 6144)]


def excess(got: torch.Tensor, want: torch.Tensor, tol: float):
    """(max |got - want|, max of |got - want| - (tol + tol |want|)): the
    second is <= 0 where ``torch.testing.assert_close(rtol=atol=tol)`` holds."""
    if not torch.isfinite(got).all():
        fail("a kernel returned a non-finite value")
    g, w = got.double(), want.double()
    diff = (g - w).abs()
    return float(diff.max()), float((diff - tol - tol * w.abs()).max())


def attn_bound(b, sq, skv, h, kvh, d, causal, q_offset, dtype):
    """Least time: 4 * D FLOPs per visible (query, key) pair and head
    (q.k and p.v), counted for this call's mask, against the type's peak;
    or q, k, v read once and o written once against the memory rate."""
    if causal:
        i = np.arange(sq, dtype=np.int64)
        pairs = int(np.minimum(skv, q_offset + i + 1).sum())
    else:
        pairs = sq * skv
    flops = 4 * b * h * d * pairs
    nbytes = (2 * b * sq * h * d + 2 * b * skv * kvh * d) * torch.empty(
        (), dtype=dtype).element_size()
    t_ops = flops / FLOPS_PER_S[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def check_attention(device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    timed = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, b, sq, skv, h, kvh, d, causal, q_offset in ATTN_CASES:
            q = torch.randn((b, sq, h, d), generator=gen, device=device).to(dtype)
            k = torch.randn((b, skv, kvh, d), generator=gen, device=device).to(dtype)
            v = torch.randn((b, skv, kvh, d), generator=gen, device=device).to(dtype)
            got = fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
            torch.cuda.synchronize()
            want = fa.flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
            torch.cuda.synchronize()
            abs_err, over = excess(got, want, MODEL_TOL[dtype])
            row = {"case": name, "shape": [b, sq, skv, h, kvh, d],
                   "causal": causal, "q_offset": q_offset,
                   "dtype": DTYPE_NAME[dtype], "max_abs_err": abs_err,
                   "tol": MODEL_TOL[dtype]}
            if name in TIMED_ATTN:
                row["ms"] = time_ms(lambda: fa.flash_attention(
                    q, k, v, causal=causal, q_offset=q_offset), reps=9)
                row["plain_ms"] = time_ms(lambda: fa.flash_attention_plain(
                    q, k, v, causal=causal, q_offset=q_offset), reps=3)
                qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
                sdpa = torch.nn.functional.scaled_dot_product_attention
                lib = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
                row["library_max_abs_err"], _ = excess(lib.transpose(1, 2), want,
                                                       MODEL_TOL[dtype])
                row["library_ms"] = time_ms(lambda: sdpa(
                    qt, kt, vt, is_causal=causal, enable_gqa=True), reps=9)
                row["device_ms"] = device_ms(lambda: fa.flash_attention(
                    q, k, v, causal=causal, q_offset=q_offset))
                row["library_device_ms"] = device_ms(lambda: sdpa(
                    qt, kt, vt, is_causal=causal, enable_gqa=True))
                (row["bound_ms"], row["bound_by"], row["flops"],
                 row["bytes"]) = attn_bound(b, sq, skv, h, kvh, d, causal,
                                            q_offset, dtype)
                timed[(name, dtype)] = row
                del qt, kt, vt, lib
            say("kernels", kernel="flash_attention", **row)
            if not over <= 0:
                fail(f"flash_attention disagrees with its plain version: {row}")
            del q, k, v, got, want
    return timed


def check_rmsnorm(device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    timed = {}
    for dtype in (torch.bfloat16, torch.float32):
        for rows, d in NORM_CASES:
            x = torch.randn((rows, d), generator=gen, device=device).to(dtype)
            scale = torch.randn((d,), generator=gen, device=device).to(dtype)
            got = rn.rmsnorm(x, scale)
            torch.cuda.synchronize()
            want = rn.rmsnorm_plain(x, scale)
            abs_err, over = excess(got, want, MODEL_TOL[dtype])
            item = x.element_size()
            nbytes = (2 * rows * d + d) * item
            row = {"shape": [rows, d], "dtype": DTYPE_NAME[dtype],
                   "max_abs_err": abs_err, "tol": MODEL_TOL[dtype],
                   "ms": time_ms(lambda: rn.rmsnorm(x, scale), reps=9),
                   "plain_ms": time_ms(lambda: rn.rmsnorm_plain(x, scale), reps=3),
                   "library_ms": time_ms(lambda: torch.nn.functional.rms_norm(
                       x, (d,), weight=scale, eps=1e-5), reps=9),
                   "device_ms": device_ms(lambda: rn.rmsnorm(x, scale)),
                   "library_device_ms": device_ms(lambda: torch.nn.functional.rms_norm(
                       x, (d,), weight=scale, eps=1e-5)),
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                   "bytes": nbytes}
            timed[(rows, d, dtype)] = row
            say("kernels", kernel="rmsnorm", **row)
            if not over <= 0:
                fail(f"rmsnorm disagrees with its plain version: {row}")
            del x, scale, got, want
    return timed


#: (name, b, s, h, p, g, n, chunk, valid, initial_state): "path" is
#: mamba2-370m's per-layer call in the 4 x 2048 prefill; "ragged" a
#: 1,000-token prompt padded to 1,024 (the last 24 steps dt = 0 and x, B,
#: C = 0, as MambaBlock pads them); "n64" zamba2-7b's heads (112 of 64,
#: state 64) with an initial state; "smoke" mamba2's smoke block
SSD_CASES = [
    ("path", 4, 2048, 32, 64, 1, 128, 256, 2048, False),
    ("ragged", 1, 1024, 32, 64, 1, 128, 256, 1000, False),
    ("n64", 1, 2048, 112, 64, 1, 64, 256, 2048, True),
    ("smoke", 2, 64, 8, 16, 1, 16, 32, 64, True),
]


def ssd_inputs(gen, b, s, h, p, g, n, valid, init, dtype, device):
    """x, B, C ~ N(0, 1); dt = softplus(N(0, 1)); A = -linspace(1, 16, h),
    mamba2's init (A dt reaches about -11 a step at the last head); D ~
    N(0, 1); steps from ``valid`` on padded as the model pads them."""
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=device)
    x, B, C = rnd(b, s, h, p), rnd(b, s, g, n), rnd(b, s, g, n)
    dt = torch.nn.functional.softplus(rnd(b, s, h))
    for t in (x, B, C, dt):
        t[:, valid:] = 0
    A = -torch.linspace(1.0, 16.0, h, device=device)
    st = rnd(b, h, p, n) if init else None
    return x.to(dtype), dt, A, B.to(dtype), C.to(dtype), rnd(h), st


def ssd_work(b, s, h, p, g, n, chunk, dtype, init):
    """What K3's function must do on these inputs: x, dt, A, B, C, D (and an
    initial state) read once, y and the final state written once; and the
    operations, each MAC counted as 2. Per (batch, group, chunk of L) the
    lower triangle of C B^T (n MACs a pair), shared by the group's heads;
    per (batch, head, chunk) the products with a float32 operand: the lower
    triangle of M x (p MACs a pair), C . state and the state update (L n p
    MACs each); and three elementwise operations a pair for the decay and
    dt weights of M. Returns (C B^T FLOPs, float32-operand product FLOPs,
    elementwise FLOPs, bytes)."""
    item = torch.empty((), dtype=dtype).element_size()
    states = b * h * p * n * 4 * (2 if init else 1)
    nbytes = 2 * b * s * h * p * item + 2 * b * s * g * n * item + b * s * h * 4 \
        + 2 * h * 4 + states
    pairs = chunk * (chunk + 1) // 2
    heads = b * h * (s // chunk)
    cb_flops = b * g * (s // chunk) * 2 * n * pairs
    f32_flops = heads * (2 * p * pairs + 4 * chunk * n * p)
    elem_flops = heads * 3 * pairs
    return cb_flops, f32_flops, elem_flops, nbytes


def ssd_bound(b, s, h, p, g, n, chunk, dtype, init):
    """Least time on the CUDA cores' terms (the general instance's): C B^T
    at the peak of the inputs' type (a bf16 product accumulated in float32
    may run on the tensor cores), the rest in float32 at 67 TFLOP/s (M and
    the state are float32), against the bytes. Returns (ms, bound by,
    FLOPs, bytes)."""
    cb_flops, f32_flops, elem_flops, nbytes = ssd_work(b, s, h, p, g, n, chunk, dtype, init)
    t_ops = (cb_flops / FLOPS_PER_S[dtype]
             + (f32_flops + elem_flops) / FLOPS_PER_S[torch.float32]) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"),
            cb_flops + f32_flops + elem_flops, nbytes)


def ssd_bound_tc(b, s, h, p, g, n, chunk, dtype, init):
    """Least time on the wgmma instance's terms: every product on the bf16
    tensor cores (989 TFLOP/s), each product with a float32 operand counted
    twice (its bf16 hi and lo halves), the elementwise weights of M in
    float32, against the bytes. Returns (ms, bound by)."""
    cb_flops, f32_flops, elem_flops, nbytes = ssd_work(b, s, h, p, g, n, chunk, dtype, init)
    t_ops = ((cb_flops + 2 * f32_flops) / FLOPS_PER_S[torch.bfloat16]
             + elem_flops / FLOPS_PER_S[torch.float32]) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


#: the K3 cases timed, each instance that takes them in turns on one card
TIMED_SSD = ("path", "ragged", "n64")


def check_ssd(device) -> dict:
    """Every case through every instance that takes it (bf16 at the
    configs' heads: wgmma and general; the rest: general) against the
    plain version; the timed cases timed with the instances in turns
    (wgmma, general, general, wgmma)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    timed = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, b, s, h, p, g, n, chunk, valid, init in SSD_CASES:
            x, dt, A, B, C, D, st = ssd_inputs(gen, b, s, h, p, g, n, valid, init,
                                               dtype, device)
            want_y, want_final = ssd.ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk,
                                                    initial_state=st)
            torch.cuda.synchronize()
            picked = ssd.instance_for(dtype, p, n, chunk)
            instances = ssd.INSTANCES if picked == "wgmma" else ("general",)
            rows = {}
            for inst in instances:
                y, final = ssd._ssd_scan(x, dt, A, B, C, D, chunk=chunk, initial_state=st,
                                         instance=inst)
                torch.cuda.synchronize()
                abs_err, over = excess(y, want_y, MODEL_TOL[dtype])
                st_err, st_over = excess(final, want_final, MODEL_TOL[dtype])
                rows[inst] = {"case": name, "instance": inst, "picked": inst == picked,
                              "shape": [b, s, h, p, g, n], "chunk": chunk,
                              "valid_steps": valid, "initial_state": init,
                              "dtype": DTYPE_NAME[dtype], "max_abs_err": abs_err,
                              "state_max_abs_err": st_err, "tol": MODEL_TOL[dtype],
                              "max_abs_y": float(want_y.abs().max())}
                if not (over <= 0 and st_over <= 0):
                    fail(f"ssd_scan disagrees with its plain version: {rows[inst]}")
                del y, final
            if name in TIMED_SSD and (dtype == torch.bfloat16 or name == "path"):
                calls = {inst: (lambda inst=inst: ssd._ssd_scan(x, dt, A, B, C, D, chunk=chunk,
                                                                instance=inst))
                         for inst in instances}
                order = list(instances) + list(reversed(instances))
                runs = {inst: [] for inst in instances}
                for inst in order:
                    runs[inst].append(device_ms(calls[inst]))
                bound, by, flops, nbytes = ssd_bound(b, s, h, p, g, n, chunk, dtype, False)
                bound_tc, by_tc = ssd_bound_tc(b, s, h, p, g, n, chunk, dtype, False)
                plain_ms = time_ms(lambda: ssd.ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk),
                                   reps=3)
                if "wgmma" in calls:           # where its three launches' time goes
                    split = trace_split(calls["wgmma"], 5, top=3)
                    rows["wgmma"]["launches_device_ms"] = {
                        re.search(r"ssd_\w+", name).group(0): ms
                        for name, ms in split["top_kernels_ms"]}
                own = {"wgmma": (bound_tc, by_tc), "general": (bound, by)}
                for inst in instances:
                    dev_ms = statistics.mean(runs[inst])
                    rows[inst].update({
                        "ms": time_ms(calls[inst], reps=9), "device_ms": dev_ms,
                        "device_ms_runs": runs[inst], "plain_ms": plain_ms,
                        "bound_ms": own[inst][0], "bound_by": own[inst][1],
                        "bound_share": own[inst][0] / dev_ms,
                        "bound_cuda_core_ms": bound, "bound_cuda_core_by": by,
                        "bound_cuda_core_share": bound / dev_ms,
                        "bound_tc_ms": bound_tc, "bound_tc_by": by_tc,
                        "bound_tc_share": bound_tc / dev_ms, "flops": flops,
                        "bytes": nbytes, "library_ms": None})
                    timed[(name, dtype, inst)] = rows[inst]
            for row in rows.values():
                say("kernels", kernel="ssd_scan", **row)
            del x, dt, B, C, want_y, want_final
    return timed


# ---------------------------------------------------------------------------
# phase 5 helpers: qwen3-0.6b serving at full width
# ---------------------------------------------------------------------------
ARCH = "qwen3-0.6b"
PREFILL_SHAPES = [(4, 2048), (1, 1000)]
PREFILL_REPEATS = 4
ENGINE = dict(batch=8, cache_len=2048)
N_REQUESTS, MAX_NEW = 16, 32
#: prefill/decode consistency in bf16 (tests/test_models.py:97 uses 5e-2 for
#: bf16 smoke configs). At full width the logits reach |250|, where one bf16
#: unit is 1 or 2, so the element-wise 5e-2 + 5e-2 |x| is reported, not
#: gated. The gate is set from the plain twin's own gap, measured in the same
#: run on the same weights and tokens: the kernel model's gap may be at most
#: CONSISTENCY_VS_PLAIN times it (or one bf16 unit at the largest |logit|,
#: where the twin's gap is 0), and at most 5e-2 of the largest |logit|
CONSISTENCY_TOL = 5e-2
CONSISTENCY_VS_PLAIN = 2.0
#: bf16 prefill logits, kernel model vs plain twin: rtol 2e-2, atol 2e-2 of
#: the largest |logit| (the bf16 limit of tests/test_torch_models.py)
BF16_TOL = 2e-2
#: float32 kernel model vs its plain twin (tests/test_models.py:97)
F32_TOL = 1e-3


def counts() -> dict:
    return {"flash_attention": fa.launch_count, "rmsnorm": rn.launch_count,
            "ssd_scan": ssd.launch_count,
            **{f"ssd_scan.{k}": v for k, v in ssd.instance_counts.items()}}


def zero_counts() -> None:
    fa.launch_count = rn.launch_count = ssd.launch_count = 0
    for k in ssd.instance_counts:
        ssd.instance_counts[k] = 0


def counted(fn):
    """``fn()`` and the kernel launches it made (counts read before and
    after, not zeroed)."""
    before = counts()
    out = fn()
    return out, {k: v - before[k] for k, v in counts().items()}


def timed_wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def manual_greedy(model, prompt, max_new: int, slot: int) -> list:
    """The engine's greedy tokens for one request by hand: decode_step +
    argmax on a cache of the engine's shape, the request in its slot."""
    cache = model.init_cache(ENGINE["batch"], ENGINE["cache_len"])
    toks = np.zeros((ENGINE["batch"], 1), np.int32)
    pos = np.zeros(ENGINE["batch"], np.int32)
    tok, out = int(prompt[0]), []
    for t in range(1, len(prompt) + max_new):
        toks[slot, 0], pos[slot] = tok, t - 1
        logits, cache = model.decode_step(cache, toks, pos)
        row = logits[slot].float().cpu().numpy()
        tok = int(prompt[t]) if t < len(prompt) else int(np.argmax(row))
        if t >= len(prompt):
            out.append(tok)
    return out


#: the port's kernels by a fragment of their device function names (K3: its
#: three wgmma-instance launches and the general instance)
KERNEL_NAMES = {"flash_attention": "flash_fwd", "rmsnorm": "rmsnorm_", "ssd_scan": "ssd_"}


def trace_split(fn, calls: int, top: int) -> dict:
    """Where the device time of ``fn`` goes: from a torch.profiler trace of
    ``calls`` warm calls, the device time per call, the kernels per call,
    the ``top`` largest kernels by device time per call, and each of the
    port's kernels' device time per call (KERNEL_NAMES)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n_kernels += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    largest = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    ours = {k: sum(ms for name, ms in by_name.items() if frag in name) / calls
            for k, frag in KERNEL_NAMES.items()}
    return {"device_ms": sum(by_name.values()) / calls if n_kernels else None,
            "kernels": n_kernels / calls,
            "top_kernels_ms": [[name[:80], ms / calls] for name, ms in largest],
            "port_kernels_ms": ours}


def decode_profile(model, steps: int = 5) -> dict:
    """Where one decode step's time goes (batch 8, cache 2048): wall per
    step, and from a torch.profiler trace the device time per step, the
    kernels launched per step and the five largest device-time kernels."""
    cache = model.init_cache(ENGINE["batch"], ENGINE["cache_len"])
    toks = np.arange(ENGINE["batch"], dtype=np.int32)[:, None]
    pos = np.full(ENGINE["batch"], 100, np.int32)
    for _ in range(3):
        model.decode_step(cache, toks, pos)
    walls = []
    for _ in range(9):
        _, wall = timed_wall(lambda: model.decode_step(cache, toks, pos))
        walls.append(wall * 1e3)
    split = trace_split(lambda: model.decode_step(cache, toks, pos), steps, top=5)
    dev_ms = split["device_ms"]
    wall_ms = statistics.median(walls)
    return {"wall_ms_per_step": wall_ms,
            "device_ms_per_step": dev_ms if dev_ms else "not measured",
            "device_idle_share": (1 - dev_ms / wall_ms) if dev_ms else "not measured",
            "device_kernels_per_step": split["kernels"],
            "top_kernels_ms_per_step": split["top_kernels_ms"]}


def consistency_gap(model, toks, full_logits) -> dict:
    """Prefix prefill + teacher-forced decode_step over the last 32 tokens:
    how far the last logits land from the full prefill's. A KV cache is
    copied into one of the full length; an SSM cache (conv window + state)
    is the prefix prefill's own, handed to the decode recurrence as it is."""
    b, s = toks.shape
    n = s - 32
    _, prefix = model.prefill(toks[:, :n])
    if "k" in prefix:
        cache = model.init_cache(b, s)
        cache["k"][:, :, :n] = prefix["k"]
        cache["v"][:, :, :n] = prefix["v"]
        del prefix
    else:
        cache = prefix
    for t in range(n, s):
        logits, cache = model.decode_step(cache, toks[:, t:t + 1],
                                          torch.full((b,), t, dtype=torch.int32))
    got, want = logits.float(), full_logits.float()
    diff = (got - want).abs()
    return {"max_abs_err": float(diff.max()), "max_abs_logit": float(want.abs().max()),
            "elementwise_5e-2_holds": bool((diff <= CONSISTENCY_TOL
                                            + CONSISTENCY_TOL * want.abs()).all()),
            "argmax_equal": int((got.argmax(-1) == want.argmax(-1)).sum())}


def serve_requests(vocab: int) -> list:
    """16 greedy requests as launch/serve.py makes them."""
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(0, vocab, int(rng.integers(2, 12))),
                    max_new_tokens=MAX_NEW) for i in range(N_REQUESTS)]


def check_consistency(phase, model, twin, toks, full_logits, twin_logits,
                      cap=CONSISTENCY_TOL) -> dict:
    """Prefill/decode consistency of the kernel model, gated by the plain
    twin's own gap on the same weights and tokens: at most
    CONSISTENCY_VS_PLAIN times it (for bf16, or one bf16 unit at the largest
    |logit| where the twin's gap is smaller), and at most ``cap`` of the
    largest |logit| unless ``cap`` is None."""
    kernel_gap = consistency_gap(model, toks, full_logits)
    plain_gap = consistency_gap(twin, toks, twin_logits)
    top = kernel_gap["max_abs_logit"]
    bf16 = model.dtype == torch.bfloat16
    bf16_unit = float(2.0 ** (np.floor(np.log2(top)) - 7)) if bf16 and top > 0 else 0.0
    limit = max(CONSISTENCY_VS_PLAIN * plain_gap["max_abs_err"], bf16_unit)
    rule = f"{CONSISTENCY_VS_PLAIN} x plain gap"
    if bf16:
        rule = f"max({rule}, one bf16 unit at max |logit|)"
    if cap is not None:
        limit, rule = min(limit, cap * top), f"min({rule}, {cap} x max |logit|)"
    consistency = {"dtype": DTYPE_NAME[model.dtype], "kernels": kernel_gap,
                   "plain": plain_gap, "limit": limit, "limit_rule": rule}
    say(phase, step="prefill_decode_consistency", **consistency)
    if not kernel_gap["max_abs_err"] <= limit:
        fail(f"{phase}: prefill/decode consistency: {consistency}")
    return consistency


def logits_vs_plain(phase, step, got, want, shape) -> dict:
    """bf16 logits of the kernel model against its plain twin's: rtol 2e-2
    and atol 2e-2 of the largest |logit|."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    diff = (got - want).abs()
    row = {"shape": list(shape), "max_abs_err": float(diff.max()),
           "max_abs_logit": scale, "rtol": BF16_TOL, "atol": BF16_TOL * scale,
           "argmax_equal": int((got.argmax(-1) == want.argmax(-1)).sum())}
    say(phase, step=step, **row)
    if not bool((diff <= BF16_TOL * scale + BF16_TOL * want.abs()).all()):
        fail(f"{phase} {step}: kernel model vs plain twin: {row}")
    return row


def seeded_model(cfg, device):
    """``cfg``'s model with weights from a generator seeded 0, and its
    prompts of PREFILL_SHAPES from a generator seeded 1."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    model = build_model(cfg, device=device).init(gen)
    tok_gen = torch.Generator(device=device)
    tok_gen.manual_seed(1)
    prompts = {shape: torch.randint(0, cfg.vocab_size, shape, generator=tok_gen,
                                    device=device) for shape in PREFILL_SHAPES}
    return model, prompts


def run_path(phase, model, prompts, cache_shapes_ok):
    """The serving path's own runs (prefill 4 x 2048 and 1 x 1000, then the
    engine on 16 greedy requests as launch/serve.py makes them), each with
    the kernel counts set to 0 just before it and read just after.
    ``cache_shapes_ok(cache, b, s)`` checks a prefill's cache. Returns the
    metrics (with the launches by run), the main prefill's logits and the
    served requests."""
    vocab = model.cfg.vocab_size
    main_shape = PREFILL_SHAPES[0]
    launches = {}
    out = {"n_params": sum(p.numel() for p in model.parameters())}

    model.prefill(prompts[main_shape][:, :64])           # warm-up (cuBLAS handles)
    for shape in PREFILL_SHAPES:
        zero_counts()
        (logits, cache), wall = timed_wall(lambda: model.prefill(prompts[shape]))
        b, s = shape
        launches[f"prefill_{b}x{s}"] = counts()
        if (logits.shape != (b, vocab) or not torch.isfinite(logits).all()
                or not cache_shapes_ok(cache, b, s)):
            fail(f"{phase} prefill {shape}: logits {tuple(logits.shape)}, cache "
                 f"{ {k: (tuple(v.shape), str(v.dtype)) for k, v in cache.items()} }")
        out[f"prefill_{b}x{s}"] = {"wall_s": wall, "tokens_per_s": b * s / wall}
        say(phase, step="prefill", batch=b, seq=s, wall_s=wall,
            tokens_per_s=b * s / wall, launches=launches[f"prefill_{b}x{s}"])
        if shape == main_shape:
            full_logits = logits
        del logits, cache
        # host-side wall times vary between calls: the same prefill again,
        # uncounted, for the median; and where its device time goes
        walls = [wall] + [timed_wall(lambda: model.prefill(prompts[shape]))[1]
                          for _ in range(PREFILL_REPEATS)]
        out[f"prefill_{b}x{s}"]["median_wall_s"] = statistics.median(walls)
        split = trace_split(lambda: model.prefill(prompts[shape]), 2, top=8)
        dev = split["device_ms"]
        out[f"prefill_{b}x{s}"].update(
            device_ms=dev, port_kernels_ms=split["port_kernels_ms"],
            port_kernels_share={k: v / dev for k, v in split["port_kernels_ms"].items()}
            if dev else "not measured")
        say(phase, step="prefill_repeats", batch=b, seq=s, wall_s=walls,
            median_wall_s=statistics.median(walls),
            median_tokens_per_s=b * s / statistics.median(walls),
            device_ms=dev, device_kernels=split["kernels"],
            top_kernels_ms=split["top_kernels_ms"],
            port_kernels_ms=split["port_kernels_ms"],
            port_kernels_share=out[f"prefill_{b}x{s}"]["port_kernels_share"])

    reqs = serve_requests(vocab)
    eng = ServeEngine(model, **ENGINE)
    for r in reqs:
        eng.submit(r)
    zero_counts()
    _, wall = timed_wall(eng.run)
    launches["engine"] = counts()
    steps = eng.ticks + sum(len(r.prompt) for r in reqs)
    n_tok = sum(len(r.output) for r in reqs)
    if not all(r.done and len(r.output) == MAX_NEW for r in reqs):
        fail(f"{phase}: the engine left a request unfinished")
    engine = {"requests": N_REQUESTS, "tokens": n_tok, "wall_s": wall,
              "tokens_per_s": n_tok / wall, "ticks": eng.ticks,
              "decode_steps": steps, "ms_per_decode_step": wall / steps * 1e3}
    say(phase, step="engine", **engine, launches=launches["engine"])
    out["engine"] = engine
    out["launches"] = launches
    return out, full_logits, reqs


def serving_path(device) -> dict:
    """qwen3-0.6b at full width in bf16, weights from a seeded generator:
    the path's own runs (``run_path``); then the checks (kernel model vs its
    bf16 plain twin, prefill/decode consistency, the engine's greedy tokens
    vs a manual decode loop), whose launches count nowhere."""
    cfg = get_config(ARCH)
    model, prompts = seeded_model(cfg, device)
    main_shape = PREFILL_SHAPES[0]
    kv_shape = lambda b, s: (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.resolved_head_dim)
    out, full_logits, reqs = run_path(
        "serving", model, prompts, lambda cache, b, s: cache["k"].shape == kv_shape(b, s))

    # -- 5.3 checks. The engine's greedy tokens: the first wave fills slots
    #    0..7 in order, so check three of them by hand
    for uid in range(3):
        manual = manual_greedy(model, reqs[uid].prompt, MAX_NEW, slot=uid)
        if manual != reqs[uid].output:
            fail(f"request {uid}: engine {reqs[uid].output} vs manual {manual}")
    say("serving", step="engine_greedy_equals_manual", requests=[0, 1, 2])

    # the kernel model's bf16 prefill against its plain twin (the serving
    # path's tensor-core K2 and bf16 K4 at model level)
    toks = prompts[main_shape]
    twin = build_model(cfg, device=device, impl="plain")
    twin.load_state_dict(model.state_dict())
    twin_logits, _ = twin.prefill(toks)
    out["bfloat16_vs_plain"] = logits_vs_plain("serving", "bfloat16_kernels_vs_plain",
                                               full_logits, twin_logits, main_shape)

    # prefill/decode consistency, the kernel model's gap held against the
    # plain twin's on the same weights and tokens
    out["consistency"] = check_consistency("serving", model, twin, toks, full_logits,
                                           twin_logits)
    del twin, twin_logits, full_logits
    return out, model


# ---------------------------------------------------------------------------
# phase 6: mamba2-370m serving at full width (SSD scan through K3)
# ---------------------------------------------------------------------------
SSM_ARCH = "mamba2-370m"
#: depth of phase 6's bf16 logits and prefill/decode gates (full width):
#: at 4 layers the bf16 twin already lands 1.4 % of the largest |logit| from
#: float32, too close to the 2e-2 limit to tell a wrong kernel from rounding
SHALLOW_LAYERS = 1


def ssm_path(device) -> tuple[dict, object]:
    """mamba2-370m at full width in bf16, weights from a seeded generator:
    the path's own runs (``run_path``); then the checks against the plain
    twin, whose launches count nowhere."""
    cfg = get_config(SSM_ARCH)
    model, prompts = seeded_model(cfg, device)
    s_cfg = cfg.ssm
    conv_c = cfg.d_inner + 2 * s_cfg.n_groups * s_cfg.state_dim

    def caches_ok(cache, b, s):
        want_ssm = (cfg.n_layers, b, cfg.n_ssm_heads, s_cfg.head_dim, s_cfg.state_dim)
        return (cache["conv"].shape == (cfg.n_layers, b, s_cfg.conv_dim - 1, conv_c)
                and cache["ssm"].shape == want_ssm and cache["ssm"].dtype == torch.float32
                and bool(torch.isfinite(cache["ssm"]).all()))
    out, full_logits, reqs = run_path("ssm_serving", model, prompts, caches_ok)

    # -- 6.3 checks. Random weights over 48 layers amplify rounding: a one-
    #    unit difference in a layer's output grows about sixty-fold by the
    #    logits in bf16, and the bf16 plain twin's logits land about 30 % of
    #    the largest |logit| from the same weights computed in float32. So the
    #    gates are: each layer held to its plain twin on the twin's own input
    #    (teacher-forced, where nothing accumulates) in bf16 and float32; the
    #    48-layer float32 logits and prefill/decode gap; the bf16 logits and
    #    prefill/decode gap at SHALLOW_LAYERS (``shallow_bf16``); the engine's
    #    first step. The 48-layer bf16 logits and gap are reported only
    toks = prompts[PREFILL_SHAPES[0]]
    twin, model32, twin32 = plain_and_float32(model, cfg, device)
    out["layerwise_bfloat16"] = layerwise(model, twin, toks, BF16_TOL)
    out["layerwise_float32"] = layerwise(model32, twin32, toks, F32_TOL)

    (kernels_f32, _), f32_launches = counted(lambda: model32.prefill(toks))
    (plain, plain_f32), twin_launches = counted(
        lambda: (twin.prefill(toks)[0], twin32.prefill(toks)[0]))
    out["launches_float32_and_twins"] = {"kernels_f32": f32_launches, "twins": twin_launches}
    say("ssm_serving", step="float32_and_twin_launches", **out["launches_float32_and_twins"])
    if (f32_launches["ssd_scan.general"] != cfg.n_layers or f32_launches["ssd_scan.wgmma"]
            or any(twin_launches.values())):
        fail(f"ssm_serving: the float32 prefill must run K3's general instance once a "
             f"layer and the plain twins no kernel: {out['launches_float32_and_twins']}")
    logits = {"kernels": full_logits, "plain": plain, "kernels_f32": kernels_f32,
              "plain_f32": plain_f32}
    out["logits"] = end_to_end_logits(logits, PREFILL_SHAPES[0])
    out["consistency_float32"] = check_consistency(
        "ssm_serving", model32, twin32, toks, logits["kernels_f32"], logits["plain_f32"],
        cap=F32_TOL)
    out["consistency_bfloat16_reported"] = {
        "kernels": consistency_gap(model, toks, logits["kernels"]),
        "plain": consistency_gap(twin, toks, logits["plain"]), "gated": False}
    say("ssm_serving", step="prefill_decode_consistency_bfloat16_48_layers",
        **out["consistency_bfloat16_reported"])
    del logits, full_logits

    # the engine on the twin and on the float32 twin: the same requests. The
    # first decode step of every engine (slot 0 admits its first prompt
    # token, the other slots decode token 0 at 0) is gated; where the tokens
    # part is reported, with the float32 twin's as the yardstick of bf16 noise
    first_toks = np.zeros((ENGINE["batch"], 1), np.int32)
    first_toks[0, 0] = reqs[0].prompt[0]
    first_pos = np.zeros(ENGINE["batch"], np.int32)
    first = [m.decode_step(m.init_cache(ENGINE["batch"], ENGINE["cache_len"]),
                           first_toks, first_pos)[0] for m in (model, twin)]
    first_step = logits_vs_plain("ssm_serving", "engine_first_step_vs_plain",
                                 first[0], first[1], (ENGINE["batch"], 1))
    outputs = {}
    for name, m in (("plain", twin), ("plain_f32", twin32)):
        other = serve_requests(cfg.vocab_size)
        other_eng = ServeEngine(m, **ENGINE)
        for r in other:
            other_eng.submit(r)
        other_eng.run()
        outputs[name] = [r.output for r in other]
    out["engine_tokens"] = {
        "kernels_vs_plain": token_agreement([r.output for r in reqs], outputs["plain"]),
        "plain_vs_plain_f32": token_agreement(outputs["plain"], outputs["plain_f32"]),
        "first_step": first_step}
    say("ssm_serving", step="engine_tokens", **out["engine_tokens"])
    del twin, model32, twin32
    out["shallow_bfloat16"] = shallow_bf16(model, cfg, toks, device)
    return out, model


def plain_and_float32(model, cfg, device):
    """The plain twin of ``model`` on its weights, and both models on the
    same weights in float32."""
    twin = build_model(cfg, device=device, impl="plain")
    twin.load_state_dict(model.state_dict())
    f32_cfg = dataclasses.replace(cfg, dtype="float32")
    f32_state = {k: v.float() for k, v in model.state_dict().items()}
    model32 = build_model(f32_cfg, device=device)
    model32.load_state_dict(f32_state)
    twin32 = build_model(f32_cfg, device=device, impl="plain")
    twin32.load_state_dict(f32_state)
    return twin, model32, twin32


def shallow_bf16(model, cfg, toks, device) -> dict:
    """The bf16 gates of phase 5 at the first SHALLOW_LAYERS layers of the
    48 (full width, the same weights and tokens), where rounding has not
    been amplified: prefill logits vs the plain twin within BF16_TOL of the
    largest |logit|, and the prefill/decode gap within twice the twin's and
    CONSISTENCY_TOL of the largest |logit|. The bf16 twin's own distance
    from float32 must stay under half the logits limit, or the gate could
    not tell a wrong kernel from rounding."""
    cut = dataclasses.replace(cfg, n_layers=SHALLOW_LAYERS)
    state = {k: v for k, v in model.state_dict().items()
             if not k.startswith("layers.") or int(k.split(".")[1]) < SHALLOW_LAYERS}
    short = build_model(cut, device=device)
    short.load_state_dict(state)
    twin, _, twin32 = plain_and_float32(short, cut, device)
    got, want = short.prefill(toks)[0], twin.prefill(toks)[0]
    row = logits_vs_plain("ssm_serving", f"bfloat16_kernels_vs_plain_{SHALLOW_LAYERS}_layers",
                          got, want, tuple(toks.shape))
    f32 = twin32.prefill(toks)[0].float()
    row["plain_vs_f32"] = float((want.float() - f32).abs().max())
    say("ssm_serving", step=f"bfloat16_noise_{SHALLOW_LAYERS}_layers",
        plain_vs_f32=row["plain_vs_f32"], limit=0.5 * row["atol"])
    if not row["plain_vs_f32"] <= 0.5 * row["atol"]:
        fail(f"ssm_serving: bf16 rounding at {SHALLOW_LAYERS} layers too large to gate: {row}")
    return {"layers": SHALLOW_LAYERS, "logits": row,
            "consistency": check_consistency("ssm_serving", short, twin, toks, got, want)}


def layerwise(model, twin, toks, tol: float) -> dict:
    """Every layer of the kernel model against the twin's on the twin's own
    input (teacher-forced): the layer's output, its SSM state (K3's final
    state) and conv window, each within ``tol`` of the tensor's largest
    magnitude."""
    worst = {"output": 0.0, "ssm_state": 0.0, "conv": 0.0}
    x = twin.embed[twin._tokens(toks)]
    for got_layer, want_layer in zip(model.layers, twin.layers):
        got, (g_conv, g_ssm) = got_layer(x, return_state=True)
        want, (w_conv, w_ssm) = want_layer(x, return_state=True)
        for name, g, w in (("output", got, want), ("ssm_state", g_ssm, w_ssm),
                           ("conv", g_conv, w_conv)):
            g, w = g.float(), w.float()
            if not torch.isfinite(g).all():
                fail(f"layerwise: non-finite {name}")
            worst[name] = max(worst[name], float((g - w).abs().max() / w.abs().max()))
        x = want
    row = {"dtype": DTYPE_NAME[model.dtype], "layers": len(model.layers),
           "worst_rel_to_max": worst, "tol": tol}
    say("ssm_serving", step="layerwise_kernels_vs_plain", **row)
    if not max(worst.values()) <= tol:
        fail(f"ssm_serving layerwise: kernel layers vs plain: {row}")
    return row


def end_to_end_logits(logits: dict, shape) -> dict:
    """The 48-layer prefill's last logits: bf16 kernel model vs bf16 twin
    and each against the float32 twin (reported: rounding, amplified over 48
    random layers, puts all three near a third of the largest |logit|), and
    float32 kernel model vs float32 twin within F32_TOL of the largest
    |logit| (gated)."""
    f32 = logits["plain_f32"].float()
    top = float(f32.abs().max())

    def dist(a, b):
        return float((a.float() - b.float()).abs().max())
    row = {"shape": list(shape), "max_abs_logit_f32": top,
           "bf16_kernels_vs_plain": dist(logits["kernels"], logits["plain"]),
           "bf16_kernels_vs_f32": dist(logits["kernels"], f32),
           "bf16_plain_vs_f32": dist(logits["plain"], f32),
           "f32_kernels_vs_plain": dist(logits["kernels_f32"], f32),
           "argmax_equal": {name: int((t.float().argmax(-1) == f32.argmax(-1)).sum())
                            for name, t in logits.items() if name != "plain_f32"}}
    row["f32_elementwise_1e-3_holds"] = bool(
        ((logits["kernels_f32"] - f32).abs() <= F32_TOL + F32_TOL * f32.abs()).all())
    row["gated"] = "f32_kernels_vs_plain"
    say("ssm_serving", step="prefill_logits", **row)
    if not row["f32_kernels_vs_plain"] <= F32_TOL * top:
        fail(f"ssm_serving prefill logits: {row}")
    return row


def token_agreement(a: list, b: list) -> dict:
    """How many requests got the same tokens, and where the others first
    part (request, index of the output token)."""
    differ = [(i, next(j for j, (x, y) in enumerate(zip(oa, ob)) if x != y))
              for i, (oa, ob) in enumerate(zip(a, b)) if oa != ob]
    return {"requests_equal": len(a) - len(differ), "first_differences": differ}


def float32_twin(device) -> dict:
    """The same weights in float32: kernel model vs its plain twin."""
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    model = build_model(cfg, device=device).init(gen)
    twin = build_model(cfg, device=device, impl="plain")
    twin.load_state_dict(model.state_dict())
    tok_gen = torch.Generator(device=device)
    tok_gen.manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, PREFILL_SHAPES[0], generator=tok_gen,
                         device=device)
    got, cache = model.prefill(toks)
    want, want_cache = twin.prefill(toks)
    abs_err, over = excess(got, want, F32_TOL)
    k_err, k_over = excess(cache["k"], want_cache["k"], F32_TOL)
    row = {"shape": list(PREFILL_SHAPES[0]), "max_abs_err": abs_err, "cache_k_max_abs_err": k_err,
           "tol": F32_TOL, "max_abs_logit": float(want.abs().max())}
    say("serving", step="float32_kernels_vs_plain", **row)
    if not (over <= 0 and k_over <= 0):
        fail(f"float32 prefill: kernel model vs plain twin: {row}")
    return row


# ---------------------------------------------------------------------------
# phase 7: the online fleet scheduler, every re-simulation through K1
# ---------------------------------------------------------------------------
#: fleet1k's gated pair (kernel and torch twin) takes the trace's first
#: arrivals only; the kernel alone runs all 2,048 (the twin at full size
#: would add about as long again as the kernel run to the script)
FLEET1K_TWIN_ARRIVALS = 512
#: ``benchmarks/fault_bench.py``'s recovery policies, plus one run with a
#: joint-admission window so that offline cores reach ``search.joint``
FAULT_RUNS = (("requeue", "kill", 0.0), ("elastic", "kill", 0.0),
              ("requeue", "proactive", 0.0), ("elastic", "proactive", 0.5))


class ScanProbe:
    """Counts a run's simulate / simulate_batch scans and brackets every
    device scan (copies in, launches, copies out) with CUDA events."""

    def __init__(self):
        self.calls = {"simulate": 0, "simulate_batch": 0}
        self.spans = []        # (start, end) CUDA events of each device scan
        self.rows = []         # (rows, elements) of each device scan

    def _counted(self, name, fn):
        def wrapper(*args, **kw):
            self.calls[name] += 1
            return fn(*args, **kw)
        return wrapper

    def _bracketed(self, fn, shape_of):
        def wrapper(arg, *args, **kw):
            self.rows.append(shape_of(arg))
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(arg, *args, **kw)
            end.record()
            self.spans.append((start, end))
            return out
        return wrapper

    def __enter__(self):
        self._saved = {name: getattr(sim_scan, name) for name in (
            "simulate_scan", "simulate_scan_batch", "_scan_rows", "_waits_ragged")}
        sim_scan.simulate_scan = self._counted("simulate", sim_scan.simulate_scan)
        sim_scan.simulate_scan_batch = self._counted("simulate_batch",
                                                     sim_scan.simulate_scan_batch)
        sim_scan._scan_rows = self._bracketed(
            sim_scan._scan_rows, lambda u: (1, u.size) if u.ndim == 1 else u.shape)
        sim_scan._waits_ragged = self._bracketed(
            sim_scan._waits_ragged, lambda us: (len(us), max(u.size for u in us)))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(sim_scan, name, fn)

    def busy_ms(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.spans)


def sched_run(spec, strategy: str, config, device, *, faults=None, stream=None,
              arrivals=None) -> dict:
    """One scheduler run, event by event with ``check_invariants()`` after
    each, recording what it decided and what it cost."""
    rec = obs.Recorder()
    sched = FleetScheduler(spec.cluster, strategy, config=config, recorder=rec,
                           device=device)
    placements = []
    assign, remove = sched.placement.assign, sched.placement.remove

    def logged_assign(job_id, cores):
        placements.append((sched.now, "assign", int(job_id), cores.tolist()))
        return assign(job_id, cores)

    def logged_remove(job_id):
        placements.append((sched.now, "remove", int(job_id), []))
        return remove(job_id)

    sched.placement.assign, sched.placement.remove = logged_assign, logged_remove
    for g in getattr(spec, "replicas", ()):
        sched.submit(g, at=0.0, resident=True)
    sched.submit_trace(spec.arrivals if arrivals is None else spec.arrivals[:arrivals])
    if faults is not None:
        sched.submit_faults(faults)
    if stream is not None:
        sched.submit_traffic(stream)
    until = sched.autoscale.horizon if sched.autoscale.enabled else None
    events, check_s = [], 0.0
    torch.cuda.synchronize()
    ls.launch_count = 0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with ScanProbe() as probe:
        start.record()
        t0 = time.perf_counter()
        while until is None or (sched.events.peek() is not None
                                and sched.events.peek().time <= until):
            ev = sched.step()
            if ev is None:
                break
            events.append((ev.time, ev.kind, ev.job_id, ev.epoch, ev.node, ev.deadline))
            t1 = time.perf_counter()
            sched.check_invariants()
            check_s += time.perf_counter() - t1
        stats = sched.run()                 # nothing left to step: settles the clock
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = ls.launch_count
    span_ms = start.elapsed_time(end)
    busy_ms = probe.busy_ms()
    return {
        "sched": sched, "stats": stats, "dump": json.dumps(rec.dump(), sort_keys=True),
        "decisions": {"events": events, "placements": placements,
                      "remap": [dataclasses.astuple(d) for d in sched.decisions],
                      "autoscale": [dataclasses.astuple(d) for d in sched.autoscale.decisions],
                      "draining": sorted(sched.draining.items()),
                      "pending": list(sched.pending)},
        "row": {"backend": sched.sim_backend, "device": str(sched.device),
                "wall_s": wall, "check_invariants_s": check_s, "events": len(events),
                "ms_per_event": wall / max(len(events), 1) * 1e3,
                "ms_per_event_without_checks": (wall - check_s) / max(len(events), 1) * 1e3,
                "simulate_calls": probe.calls["simulate"],
                "simulate_batch_calls": probe.calls["simulate_batch"],
                "k1_launches": launches, "device_span_ms": span_ms,
                "device_busy_ms": busy_ms,
                "idle_share": (1.0 - busy_ms / span_ms) if span_ms > 0 else None,
                "n_jobs": stats.n_jobs, "makespan": stats.makespan,
                "total_msg_wait": stats.total_msg_wait},
        "shapes": probe.rows,
    }


def _numbers(tree, path=""):
    """(path, value) of every leaf of a stats dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _numbers(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _numbers(v, f"{path}[{i}]")
    else:
        yield path, tree


def stats_margin(a, b) -> tuple[float, list]:
    """Largest relative difference of the float fields of two FleetStats
    and the fields that differ otherwise (ints, names, keys)."""
    la = dict(_numbers(dataclasses.asdict(a)))
    lb = dict(_numbers(dataclasses.asdict(b)))
    if la.keys() != lb.keys():
        return float("inf"), sorted(set(la) ^ set(lb))[:5]
    worst, other = 0.0, []
    for k, x in la.items():
        y = lb[k]
        if isinstance(x, float) and isinstance(y, float) and not isinstance(x, bool):
            if x != y:
                worst = max(worst, abs(x - y) / max(abs(x), abs(y), 1e-300))
        elif x != y:
            other.append(k)
    return worst, other[:5]


def first_divergence(a: dict, b: dict) -> dict:
    """The first entry at which two decision logs part, with both values."""
    for key in a:
        for i, (x, y) in enumerate(zip(a[key], b[key])):
            if x != y:
                return {"log": key, "index": i, "kernel": str(x)[:400], "twin": str(y)[:400]}
        if len(a[key]) != len(b[key]):
            return {"log": key, "index": min(len(a[key]), len(b[key])),
                    "kernel_len": len(a[key]), "twin_len": len(b[key])}
    return {}


def dump_divergence(a: str, b: str) -> dict:
    """The first record at which two recorder dumps part, and the largest
    relative difference of the numbers in it (the margin that moved)."""
    ea, eb = json.loads(a).get("events", []), json.loads(b).get("events", [])
    for i, (x, y) in enumerate(zip(ea, eb)):
        if x != y:
            na, nb = dict(_numbers(x)), dict(_numbers(y))
            rel = max((abs(na[k] - nb[k]) / max(abs(na[k]), abs(nb[k]), 1e-300)
                       for k in na.keys() & nb.keys()
                       if isinstance(na[k], float) and isinstance(nb[k], float)
                       and na[k] != nb[k]), default=None)
            return {"record": i, "kernel": str(x)[:400], "twin": str(y)[:400],
                    "max_rel_diff": rel}
    return {"records": [len(ea), len(eb)]}


def gate(name: str, kernel: dict, twin: dict) -> dict:
    """The kernel run against its torch twin: the same decisions, a
    byte-identical recorder dump, FleetStats floats within SIM_TOL."""
    same = kernel["decisions"] == twin["decisions"]
    dump_same = kernel["dump"] == twin["dump"]
    margin, other = stats_margin(kernel["stats"], twin["stats"])
    verdict = {"decisions_identical": same, "dump_identical": dump_same,
               "stats_max_rel_diff": margin, "stats_other_diffs": other,
               "dump_bytes": len(kernel["dump"])}
    if not (same and dump_same and margin <= SIM_TOL and not other):
        verdict["first_divergence"] = first_divergence(kernel["decisions"], twin["decisions"])
        verdict["dump_divergence"] = dump_divergence(kernel["dump"], twin["dump"])
        say("scheduler", run=name, gate=verdict)
        fail(f"scheduler run {name}: the kernel run and its torch twin disagree: "
             f"{json.dumps(verdict)[:2000]}")
    return verdict


def expect_complete(name: str, run: dict, n_jobs: int, resident: int = 0) -> None:
    """Every job arrived, every batch job departed, the stats are finite."""
    sched, stats = run["sched"], run["stats"]
    floats = [v for _, v in _numbers(dataclasses.asdict(stats)) if isinstance(v, float)]
    if (stats.n_jobs != n_jobs or sched.pending or len(sched.live) != resident
            or not all(np.isfinite(floats))):
        fail(f"scheduler run {name}: incomplete or non-finite: n_jobs {stats.n_jobs} "
             f"of {n_jobs}, pending {len(sched.pending)}, live {len(sched.live)}")


def sched_config(spec, **kw):
    return SchedulerConfig(count_scale=spec.count_scale,
                           state_bytes_per_proc=spec.state_bytes_per_proc, **kw)


class Pairs:
    """Scheduler runs on the kernel backend, each beside its torch twin on
    the same card; collects their rows and the kernel runs' scan shapes."""

    def __init__(self, device, phase: str = "scheduler"):
        self.device, self.phase = device, phase
        self.rows, self.shapes = {}, []

    def __call__(self, name, spec, strategy, config, *, twin_arrivals=None, **kw):
        device, rows = self.device, self.rows
        twin_config = dataclasses.replace(config, sim_backend="torch")
        kernel = sched_run(spec, strategy, config, device, arrivals=twin_arrivals, **kw)
        # what the scheduler leaves on ``auto`` (a search strategy's scoring)
        # runs on the plain scan in the twin too
        saved = os.environ.get("REPRO_TORCH_SIM_BACKEND")
        os.environ["REPRO_TORCH_SIM_BACKEND"] = "torch"
        try:
            twin = sched_run(spec, strategy, twin_config, device, arrivals=twin_arrivals, **kw)
        finally:
            if saved is None:
                del os.environ["REPRO_TORCH_SIM_BACKEND"]
            else:
                os.environ["REPRO_TORCH_SIM_BACKEND"] = saved
        if kernel["row"]["backend"] != "kernel" or kernel["row"]["k1_launches"] <= 0:
            fail(f"scheduler run {name} did not re-simulate through K1: {kernel['row']}")
        if twin["row"]["k1_launches"] != 0:
            fail(f"scheduler run {name}: the torch twin launched K1")
        verdict = gate(name, kernel, twin)
        rows[name] = {"kernel": kernel["row"], "torch": twin["row"], "gate": verdict}
        self.shapes.extend(kernel["shapes"])
        for backend in ("kernel", "torch"):
            say(self.phase, run=name, **rows[name][backend])
        say(self.phase, run=name, gate=verdict)
        return kernel


def scheduler_runs(device) -> tuple[dict, list]:
    """Phase 7's five runs, each on the kernel backend and on its torch
    twin on the same card; returns the rows and the kernel runs' scan
    shapes."""
    pair = Pairs(device)
    rows, shapes = pair.rows, pair.shapes

    # 1. the paper's trace under every one-shot strategy, and on the host
    spec = get_trace("table4_poisson")
    for strategy in mapping.ONE_SHOT_STRATEGIES:
        name = f"table4_poisson.{strategy}"
        config = sched_config(spec, remap=RemapConfig(interval=5.0))
        kernel = pair(name, spec, strategy, config)
        expect_complete(name, kernel, 16)
        host = sched_run(spec, strategy, config, "cpu")
        rows[name]["segmented"] = host["row"]
        rows[name]["segmented_decisions_identical"] = host["decisions"] == kernel["decisions"]
        rows[name]["segmented_stats_max_rel_diff"] = stats_margin(kernel["stats"],
                                                                  host["stats"])[0]
        say("scheduler", run=name, **host["row"])

    # 2. rack oversubscription, remaps scored by the population search
    spec = get_trace("rack_oversub")
    name = "rack_oversub.remap_search"
    kernel = pair(name, spec, "new", sched_config(
        spec, remap=RemapConfig(interval=5.0, budget=64)))
    expect_complete(name, kernel, 16)
    if kernel["row"]["simulate_batch_calls"] <= 0:
        fail(f"{name}: the remap search never scored through simulate_batch")

    # 3. the reference fault trace under each recovery policy
    spec = get_trace("table4_poisson")
    faults = reference_fault_trace(spec.cluster)
    for failure, drain, window in FAULT_RUNS:
        name = f"table4_faults.{failure}_{drain}" + (f".window{window}" if window else "")
        kernel = pair(name, spec, "new", sched_config(
            spec, recovery=RecoveryConfig(failure_policy=failure, drain_policy=drain),
            admission=AdmissionConfig(window=window)), faults=faults)
        expect_complete(name, kernel, 16)
        if kernel["stats"].n_node_failures <= 0 or (window and not kernel["stats"].n_joint_batches):
            fail(f"{name}: the faults or the joint batches did not happen")

    # 4. serving under SLOs, the autoscaler on, at the trace's defaults
    spec = get_trace("serve_slo")
    name = "serve_slo.autoscale"
    kernel = pair(name, spec, "new", sched_config(spec, autoscale=AutoscaleConfig(
        enabled=True, actions=True, routing="capacity", slos=spec.slos,
        max_replicas=5, lookahead_s=30.0)), stream=spec.stream)
    if not kernel["sched"].autoscale.decisions or kernel["stats"].slo_violation_s <= 0:
        fail(f"{name}: the closed loop took no decision")

    # 5. the 1,024-node fleet at full size, nested pod/rack cells
    spec = get_trace("fleet1k")
    config = sched_config(spec, cells=CellConfig(cells="pod/rack"), reclock=True)
    name = f"fleet1k.first{FLEET1K_TWIN_ARRIVALS}"
    kernel = pair(name, spec, "new", config, twin_arrivals=FLEET1K_TWIN_ARRIVALS)
    expect_complete(name, kernel, FLEET1K_TWIN_ARRIVALS)
    full = sched_run(spec, "new", config, device)
    expect_complete("fleet1k", full, len(spec.arrivals))
    if full["row"]["k1_launches"] <= 0:
        fail("fleet1k did not re-simulate through K1")
    rows["fleet1k"] = {"kernel": full["row"]}
    shapes.extend(full["shapes"])
    say("scheduler", run="fleet1k", arrivals=len(spec.arrivals), **full["row"])
    return rows, shapes


# ---------------------------------------------------------------------------
# phase 8: the fleet planner (core.meshplan), its simulations through K1
# ---------------------------------------------------------------------------
#: the job set of ``examples/multi_job_placement.py`` (the 2-pod fleet)
MULTI_JOB = (
    ("yi-6b-train (spans pods)", "yi-6b", "train_4k", {"pod": 2, "data": 12, "model": 16}),
    ("qwen2-moe-train", "qwen2-moe-a2.7b", "train_4k", {"data": 4, "model": 16}),
    ("granite-decode", "granite-3-2b", "decode_32k", {"data": 4, "model": 16}),
)
PLACE_STRATEGIES = ("blocked", "cyclic", "drb", "new", "new_tpu", "search:new_tpu")
SERVE_FLEET_STRATEGIES = ("new", "new_tpu", "cyclic", "search:new_tpu")
#: the reference's own slack on "new_tpu is no worse than blocked"
#: (``tests/test_commgraph_meshplan.py``)
NIC_SLACK = 1.001


def multi_job_specs() -> list:
    """Fresh job specs (``place_jobs`` numbers them in place)."""
    return [meshplan.JobSpec(name, get_config(arch), SHAPES[shape], dict(axes))
            for name, arch, shape, axes in MULTI_JOB]


def fleet_planner(device) -> tuple[dict, list]:
    """Phase 8: the quickstart's single-job plan under every strategy, the
    multi-job example placed and simulated on the card, and the
    ``serve_fleet`` trace in the scheduler beside its torch twins. Returns
    K1's launches by run and the kernel runs' scan shapes."""
    topo = meshplan.tpu_topology(n_pods=2)
    launches = {}

    # (a) the quickstart's fleet part: one 512-chip job, every strategy
    t0 = time.perf_counter()
    plans = meshplan.compare_strategies(get_config("phi3.5-moe-42b-a6.6b"),
                                        SHAPES["train_4k"],
                                        {"pod": 2, "data": 16, "model": 16}, topo)
    say("fleet_planner", step="compare_strategies", wall_s=time.perf_counter() - t0)
    for name, plan in plans.items():
        perm = np.asarray(plan.perm)
        if not (perm.size == topo.n_cores and np.array_equal(np.sort(perm),
                                                              np.arange(topo.n_cores))):
            fail(f"fleet planner: {name}'s perm is not a bijection onto the fleet")
        metrics = {k: v for k, v in plan.metrics.items() if k != "level_loads"}
        say("fleet_planner", step="compare_strategies", strategy=name, **metrics)
    for key in ("max_nic_load", "dcn_bytes"):
        if plans["new_tpu"].metrics[key] > plans["blocked"].metrics[key] * NIC_SLACK:
            fail(f"fleet planner: new_tpu's {key} is above blocked's: "
                 f"{plans['new_tpu'].metrics[key]} vs {plans['blocked'].metrics[key]}")

    # (b) the multi-job example: place, NIC loads, simulate on the card
    #     (K1), each result held to the host segmented backend
    for strategy in PLACE_STRATEGIES:
        torch.cuda.synchronize()
        ls.launch_count = 0
        t0 = time.perf_counter()
        placement, graphs = meshplan.place_jobs(multi_job_specs(), topo,
                                                strategy=strategy, device=device)
        place_s = time.perf_counter() - t0
        nic = meshplan.fleet_nic_load(placement, graphs, topo)
        t0 = time.perf_counter()
        res = simulate(graphs, placement, topo, count_scale=1.0, backend="auto",
                       device=device)
        torch.cuda.synchronize()
        sim_s = time.perf_counter() - t0
        name = f"multi_job.{strategy}"
        launches[name] = ls.launch_count
        placement.validate()
        if launches[name] <= 0:
            fail(f"fleet planner {name} did not simulate through K1")
        host = simulate(graphs, placement, topo, count_scale=1.0,
                        backend="segmented", device="cpu")
        results_agree(res, host, f"fleet planner {name} kernel vs host segmented",
                      per_job_tol=SEGMENTED_PER_JOB_TOL)
        row = {"place_s": place_s, "simulate_s": sim_s, "k1_launches": launches[name],
               "n_messages": res.n_messages, "total_wait_ms": res.total_wait_ms,
               "max_server_utilisation": res.max_server_utilisation,
               "max_nic_load": nic["max_nic_load"],
               "nic_utilisation": nic["nic_utilisation"]}
        if strategy.startswith("search:"):
            # the search scored on the card must walk the host's trajectory
            t0 = time.perf_counter()
            host_placement, _ = meshplan.place_jobs(multi_job_specs(), topo,
                                                    strategy=strategy, device="cpu")
            row["host_segmented_place_s"] = time.perf_counter() - t0
            if any(not np.array_equal(host_placement.assignments[j], c)
                   for j, c in placement.assignments.items()):
                fail(f"fleet planner {name}: the search on the card placed other "
                     f"chips than the search on the host")
        say("fleet_planner", step="multi_job", strategy=strategy, **row)

    # (c) the serve_fleet trace in the scheduler, each run beside its twin
    pair = Pairs(device, phase="fleet_planner")
    spec = get_trace("serve_fleet")
    for strategy in SERVE_FLEET_STRATEGIES:
        name = f"serve_fleet.{strategy}"
        kernel = pair(name, spec, strategy, sched_config(spec))
        expect_complete(name, kernel, len(spec.arrivals))
        launches[name] = kernel["row"]["k1_launches"]
    return launches, pair.shapes


def sched_row_timing(device, shapes: list) -> dict:
    """K1 at the scheduler's row sizes: the median and the largest
    single-row scan and the largest batch the kernel runs made, each
    against its plain version (bit for bit) and its byte bound."""
    singles = sorted(n for b, n in shapes if b == 1)
    batches = sorted(((b, n) for b, n in shapes if b > 1), key=lambda s: s[0] * s[1])
    picks = {"median_row": (1, singles[len(singles) // 2]), "largest_row": (1, singles[-1])}
    if batches:
        picks["largest_batch"] = batches[-1]
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    out = {"scans": len(shapes), "single_row_scans": len(singles),
           "batch_scans": len(shapes) - len(singles)}
    for label, (b, n) in picks.items():
        u, v = make_rows(gen, int(b), int(n), torch.float64, device)
        got = ls.lindley_scan(u, v)
        want = ls.lindley_scan_plain(u, v)
        torch.cuda.synchronize()
        bound, bound_by, nbytes = bound_ms(int(b), int(n), torch.float64)
        out[label] = {"shape": [int(b), int(n)],
                      "bit_identical": bool(torch.equal(got.view(torch.int64),
                                                        want.view(torch.int64))),
                      "ms": time_ms(lambda: ls.lindley_scan(u, v), reps=21),
                      "device_ms": device_ms(lambda: ls.lindley_scan(u, v), reps=50),
                      "plain_ms": time_ms(lambda: ls.lindley_scan_plain(u, v), reps=9),
                      "bound_ms": bound, "bound_by": bound_by}
        if not out[label]["bit_identical"]:
            fail(f"lindley_scan at the scheduler's {label} {b} x {n} differs from "
                 f"its plain version")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)

    # -- phase 1: environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-2]
    say("env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=nvcc, numpy=np.__version__)
    print(smi.splitlines()[0], flush=True)

    # -- phase 2: build every kernel from the sources in this checkout, one
    #    nvcc per source, all started together
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build(KERNELS)
    seconds = time.perf_counter() - t0
    for name in KERNELS:
        lib = _build.load(name)
        say("build", source=f"src/repro_torch/kernels/csrc/{name}.cu",
            library=str(_build.library_path(name)), seconds=seconds,
            loaded=lib is not None)

    # -- phase 3: each kernel against its plain version
    timed = check_kernels(device)
    attn_timed = check_attention(device)
    norm_timed = check_rmsnorm(device)
    ssd_timed = check_ssd(device)

    # -- phase 4: the paper's path at full size, launch counts from 0
    ls.launch_count = 0
    path = main_path(device)
    path_launches = ls.launch_count
    if path_launches <= 0 or min(path["launches"].values()) <= 0:
        fail(f"the main path did not launch the kernel: {path['launches']}")

    # -- phase 5: serving at full width, launch counts from 0 before each of
    #    the path's runs (two prefills, the engine) and read after it
    serving, model = serving_path(device)
    by_step = serving["launches"]
    serve_launches = {name: sum(c[name] for c in by_step.values())
                      for name in ("flash_attention", "rmsnorm")}
    # every step norms through K4; attention goes through K2 in prefill only
    # (decode attention has no kernel in the reference either)
    if (min(serve_launches.values()) <= 0
            or min(c["rmsnorm"] for c in by_step.values()) <= 0
            or min(c["flash_attention"] for step, c in by_step.items()
                   if step.startswith("prefill")) <= 0):
        fail(f"the serving path did not launch its kernels: {by_step}")
    say("serving", step="decode_profile", **decode_profile(model))
    del model
    float32_twin(device)

    # -- phase 6: mamba2 serving at full width, counted the same way. K3
    #    runs once a layer in every prefill and never in decode (the O(1)
    #    recurrence); K4 norms every step
    ssm, ssm_model = ssm_path(device)
    ssm_steps = ssm["launches"]
    # a bf16 prefill runs K3's wgmma instance once a layer and the general
    # instance never
    n_layers = ssm_model.cfg.n_layers
    if (min(c["rmsnorm"] for c in ssm_steps.values()) <= 0
            or any((c["ssd_scan"], c["ssd_scan.wgmma"], c["ssd_scan.general"])
                   != ((n_layers, n_layers, 0) if step.startswith("prefill") else (0, 0, 0))
                   for step, c in ssm_steps.items())):
        fail(f"the ssm serving path did not launch its kernels as it should: {ssm_steps}")
    say("ssm_serving", step="decode_profile", **decode_profile(ssm_model))
    del ssm_model

    # -- phase 7: the online fleet scheduler on device=None (the kernel
    #    backend), each run against its torch twin on the same card; K1's
    #    launches counted from 0 over each kernel run
    t0 = time.perf_counter()
    sched_rows, sched_shapes = scheduler_runs(device)
    sched_launches = {f"sched.{name}": r["kernel"]["k1_launches"]
                      for name, r in sched_rows.items()}
    sched_rows_k1 = sched_row_timing(device, sched_shapes)
    say("scheduler", step="summary", seconds=time.perf_counter() - t0,
        k1_launches=sum(sched_launches.values()), k1_at_scheduler_rows=sched_rows_k1)

    # -- phase 8: the fleet planner; K1's launches counted from 0 over each
    #    placement + simulation and each scheduler run on the kernel backend
    t0 = time.perf_counter()
    fleet_k1, fleet_shapes = fleet_planner(device)
    fleet_launches = {f"fleet.{name}": n for name, n in fleet_k1.items()}
    say("fleet_planner", step="summary", seconds=time.perf_counter() - t0,
        k1_launches=sum(fleet_launches.values()), scans=len(fleet_shapes),
        largest_scan=max((int(b) * int(n) for b, n in fleet_shapes), default=0))

    at = timed[(K_FULL, torch.float64)]     # the shape simulate_batch scans
    attn = attn_timed[("path", torch.bfloat16)]   # the serving path's per-layer call
    norm = norm_timed[(8192, 1024, torch.bfloat16)]   # ln1 / ln2 rows of the prefill
    scan = ssd_timed[("path", torch.bfloat16, "wgmma")]   # mamba2's per-layer call
    def launches_of(name):
        """A kernel's launches in each run of the two serving paths."""
        steps = {f"{ARCH}.{step}": c[name] for step, c in by_step.items()}
        steps.update({f"{SSM_ARCH}.{step}": c[name] for step, c in ssm_steps.items()})
        return steps

    kernels = {"kernels": [{
        "name": "lindley_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lindley_scan.cu",
        "replaces": "src/repro/kernels/lindley_scan.py:100",
        "launches": (path_launches + sum(sched_launches.values())
                     + sum(fleet_launches.values())),
        "max_abs_err": at["max_abs_err"],
        "ms": at["ms"], "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
        "bound_by": at["bound_by"], "library_ms": None, "device_ms": at["device_ms"],
        "shape": at["shape"], "dtype": at["dtype"],
        "launches_by_step": {**path["launches"], **sched_launches, **fleet_launches},
        "scheduler_rows": sched_rows_k1,
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:92",
        "launches": sum(launches_of("flash_attention").values()),
        "max_abs_err": attn["max_abs_err"], "ms": attn["ms"],
        "plain_ms": attn["plain_ms"], "bound_ms": attn["bound_ms"],
        "bound_by": attn["bound_by"], "library_ms": attn["library_ms"],
        "device_ms": attn["device_ms"], "library_device_ms": attn["library_device_ms"],
        "shape": attn["shape"], "dtype": attn["dtype"],
        "float32": {k: attn_timed[("path", torch.float32)][k] for k in
                    ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                     "library_device_ms", "max_abs_err")},
        "ragged": {k: attn_timed[("ragged", torch.bfloat16)][k] for k in
                   ("shape", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_device_ms", "max_abs_err")},
        "launches_by_step": launches_of("flash_attention"),
    }, {
        "name": "rmsnorm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:40",
        "launches": sum(launches_of("rmsnorm").values()),
        "max_abs_err": norm["max_abs_err"], "ms": norm["ms"],
        "plain_ms": norm["plain_ms"], "bound_ms": norm["bound_ms"],
        "bound_by": norm["bound_by"], "library_ms": norm["library_ms"],
        "device_ms": norm["device_ms"], "library_device_ms": norm["library_device_ms"],
        "shape": norm["shape"], "dtype": norm["dtype"],
        "other_shapes": [{k: r[k] for k in ("shape", "dtype", "ms", "plain_ms",
                                              "bound_ms", "library_ms", "device_ms",
                                              "library_device_ms", "max_abs_err")}
                         for key, r in norm_timed.items() if r is not norm],
        "launches_by_step": launches_of("rmsnorm"),
    }, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:92",
        "launches": sum(launches_of("ssd_scan").values()),
        "max_abs_err": scan["max_abs_err"], "ms": scan["ms"],
        "plain_ms": scan["plain_ms"], "bound_ms": scan["bound_ms"],
        "bound_by": scan["bound_by"], "library_ms": None,
        "device_ms": scan["device_ms"], "bound_share": scan["bound_share"],
        "bound_cuda_core_ms": scan["bound_cuda_core_ms"],
        "bound_cuda_core_share": scan["bound_cuda_core_share"],
        "shape": scan["shape"], "chunk": scan["chunk"],
        "dtype": scan["dtype"], "instance": scan["instance"],
        "instances": {inst: {
            "launches": sum(launches_of(f"ssd_scan.{inst}").values()),
            "launches_by_step": launches_of(f"ssd_scan.{inst}"),
            **{f"{case}_{DTYPE_NAME[dtype]}": {k: row[k] for k in (
                "shape", "chunk", "ms", "device_ms", "device_ms_runs", "plain_ms", "bound_ms",
                "bound_by", "bound_share", "bound_cuda_core_ms", "bound_cuda_core_share",
                "bound_tc_ms", "bound_tc_share",
                "max_abs_err", "launches_device_ms") if k in row}
               for (case, dtype, i), row in ssd_timed.items() if i == inst}}
            for inst in ssd.INSTANCES},
        "launches_by_step": launches_of("ssd_scan"),
    }]}
    say("serving", step="summary", **{k: v for k, v in serving.items()
                                      if k != "launches"})
    say("ssm_serving", step="summary", **{k: v for k, v in ssm.items()
                                          if k != "launches"})
    print(smi.splitlines()[0], flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
