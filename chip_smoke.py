#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every hand-written kernel from the sources in this checkout (one
``nvcc`` per source, all at once), holds each against its plain PyTorch
version on the card, then drives the port's two paths at full size:

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
  the twin's own, and the same weights in float32 against the twin.

Needs a CUDA card and ``nvcc``; exits non-zero when either is missing or
any phase fails. The last line of standard output is ``{"ok": true,
"device": {...}}``; the line before it lists the kernels with their
measured times, launch counts and roofline bounds.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import ClusterTopology, mapping, workloads  # noqa: E402
from repro_torch.core.simulator import simulate, simulate_batch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import lindley_scan as ls  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.search import search_placement  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet): the roofline bounds
# below are stated against these whatever the card's power limit. bf16 is
# the tensor cores' dense rate; float32 / float64 are the CUDA cores'.
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12, torch.bfloat16: 989e12}
KERNELS = ("lindley_scan", "flash_attention", "rmsnorm")
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


def device_ms(fn, reps: int = 5) -> float:
    """Device time of ``fn`` per call: the summed duration of every kernel
    it launched, from a ``torch.profiler`` trace of ``reps`` warm calls.
    Unlike :func:`time_ms` this leaves out the host's issue time, which the
    event pair of a single call on an idle stream includes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / reps if us else None


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
            row = {"shape": [b, n], "dtype": str(dtype).split(".")[-1],
                   "max_rel_err": rel, "max_abs_err": abs_err, "tol": TOL[dtype]}
            # the small shapes are timed too: at (3, 7) the kernel's time is
            # the fixed cost of its launches, which the one-row time is read against
            row["ms"] = time_ms(lambda: ls.lindley_scan(u, v), reps=9)
            if n == N_FULL:
                row["plain_ms"] = time_ms(lambda: ls.lindley_scan_plain(u, v),
                                          reps=3)
                row["bound_ms"], row["bound_by"], row["bytes"] = bound_ms(b, n, dtype)
                timed[(b, dtype)] = row
            say("kernels", kernel="lindley_scan", **row)
            if not rel <= TOL[dtype]:
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
#: per-layer call in the 4 x 2048 prefill. bf16 runs on the tensor-core
#: kernel, float32 on the CUDA-core one
ATTN_CASES = [
    ("path", 4, 2048, 2048, 16, 8, 128, True, 0),
    ("ragged", 1, 1000, 1000, 16, 8, 128, True, 0),
    ("continuation", 1, 64, 256, 16, 8, 128, True, 192),
    ("full", 2, 512, 512, 16, 8, 128, False, 0),
    ("mqa", 2, 512, 512, 16, 1, 128, True, 0),
    ("d64", 2, 512, 512, 16, 8, 64, True, 0),
    ("d112", 1, 512, 512, 32, 32, 112, True, 0),
]
#: (rows, d): ln1 / ln2 / final-norm rows and qk-norm rows of the 4 x 2048
#: prefill, then the widths of other configs that are not powers of two
NORM_CASES = [(8192, 1024), (131072, 128), (7, 3584), (5, 6144)]


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
            if name == "path":
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
                timed[dtype] = row
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


# ---------------------------------------------------------------------------
# phase 5 helpers: qwen3-0.6b serving at full width
# ---------------------------------------------------------------------------
ARCH = "qwen3-0.6b"
PREFILL_SHAPES = [(4, 2048), (1, 1000)]
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
    return {"flash_attention": fa.launch_count, "rmsnorm": rn.launch_count}


def zero_counts() -> None:
    fa.launch_count = rn.launch_count = 0


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


def decode_profile(model, steps: int = 5) -> dict:
    """Where one decode step's time goes (batch 8, cache 2048): wall per
    step, and from a torch.profiler trace the device time per step, the
    kernels launched per step and the five largest device-time kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cache = model.init_cache(ENGINE["batch"], ENGINE["cache_len"])
    toks = np.arange(ENGINE["batch"], dtype=np.int32)[:, None]
    pos = np.full(ENGINE["batch"], 100, np.int32)
    for _ in range(3):
        model.decode_step(cache, toks, pos)
    walls = []
    for _ in range(9):
        _, wall = timed_wall(lambda: model.decode_step(cache, toks, pos))
        walls.append(wall * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            model.decode_step(cache, toks, pos)
        torch.cuda.synchronize()
    by_name: dict = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n_kernels += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    dev_ms = sum(by_name.values()) / steps
    wall_ms = statistics.median(walls)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms_per_step": wall_ms,
            "device_ms_per_step": dev_ms if n_kernels else "not measured",
            "device_idle_share": (1 - dev_ms / wall_ms) if n_kernels else "not measured",
            "device_kernels_per_step": n_kernels / steps,
            "top_kernels_ms_per_step": [[name[:80], ms / steps] for name, ms in top]}


def consistency_gap(model, toks, full_logits) -> dict:
    """Prefix prefill + teacher-forced decode_step over the last 32 tokens:
    how far the last logits land from the full prefill's."""
    b, s = toks.shape
    n = s - 32
    _, prefix = model.prefill(toks[:, :n])
    cache = model.init_cache(b, s)
    cache["k"][:, :, :n] = prefix["k"]
    cache["v"][:, :, :n] = prefix["v"]
    del prefix
    for t in range(n, s):
        logits, cache = model.decode_step(cache, toks[:, t:t + 1],
                                          torch.full((b,), t, dtype=torch.int32))
    got, want = logits.float(), full_logits.float()
    diff = (got - want).abs()
    return {"max_abs_err": float(diff.max()), "max_abs_logit": float(want.abs().max()),
            "elementwise_5e-2_holds": bool((diff <= CONSISTENCY_TOL
                                            + CONSISTENCY_TOL * want.abs()).all()),
            "argmax_equal": int((got.argmax(-1) == want.argmax(-1)).sum())}


def serving_path(device) -> dict:
    """qwen3-0.6b at full width in bf16, weights from a seeded generator:
    the path's own runs (prefill 4 x 2048 and 1 x 1000, the serving engine),
    each with the kernel counts set to 0 just before it and read just after;
    then the checks (kernel model vs its bf16 plain twin, prefill/decode
    consistency, the engine's greedy tokens vs a manual decode loop), whose
    launches count nowhere."""
    cfg = get_config(ARCH)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    model = build_model(cfg, device=device).init(gen)
    n_params = sum(p.numel() for p in model.parameters())
    tok_gen = torch.Generator(device=device)
    tok_gen.manual_seed(1)
    prompts = {shape: torch.randint(0, cfg.vocab_size, shape, generator=tok_gen,
                                    device=device) for shape in PREFILL_SHAPES}
    main_shape = PREFILL_SHAPES[0]
    launches, out = {}, {"n_params": n_params}

    # -- 5.1 prefill
    model.prefill(prompts[main_shape][:, :64])           # warm-up (cuBLAS handles)
    for shape in PREFILL_SHAPES:
        zero_counts()
        (logits, cache), wall = timed_wall(lambda: model.prefill(prompts[shape]))
        launches[f"prefill_{shape[0]}x{shape[1]}"] = counts()
        b, s = shape
        if (logits.shape != (b, cfg.vocab_size) or not torch.isfinite(logits).all()
                or cache["k"].shape != (cfg.n_layers, b, s, cfg.n_kv_heads,
                                        cfg.resolved_head_dim)):
            fail(f"prefill {shape}: logits {tuple(logits.shape)}, cache "
                 f"{tuple(cache['k'].shape)}")
        out[f"prefill_{b}x{s}"] = {"wall_s": wall, "tokens_per_s": b * s / wall}
        say("serving", step="prefill", batch=b, seq=s, wall_s=wall,
            tokens_per_s=b * s / wall, launches=launches[f"prefill_{b}x{s}"])
        if shape == main_shape:
            full_logits = logits
        del logits, cache

    # -- 5.2 the engine: 16 greedy requests as launch/serve.py makes them
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(N_REQUESTS):
        plen = int(rng.integers(2, 12))
        reqs.append(Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, plen),
                            max_new_tokens=MAX_NEW))
    eng = ServeEngine(model, **ENGINE)
    for r in reqs:
        eng.submit(r)
    zero_counts()
    _, wall = timed_wall(eng.run)
    launches["engine"] = counts()
    steps = eng.ticks + sum(len(r.prompt) for r in reqs)
    n_tok = sum(len(r.output) for r in reqs)
    if not all(r.done and len(r.output) == MAX_NEW for r in reqs):
        fail("the engine left a request unfinished")
    engine = {"requests": N_REQUESTS, "tokens": n_tok, "wall_s": wall,
              "tokens_per_s": n_tok / wall, "ticks": eng.ticks,
              "decode_steps": steps, "ms_per_decode_step": wall / steps * 1e3}
    say("serving", step="engine", **engine, launches=launches["engine"])
    out["engine"] = engine
    out["launches"] = launches

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
    got, want = full_logits.float(), twin_logits.float()
    scale = float(want.abs().max())
    diff = (got - want).abs()
    vs_plain = {"shape": list(main_shape), "max_abs_err": float(diff.max()),
                "max_abs_logit": scale, "rtol": BF16_TOL, "atol": BF16_TOL * scale,
                "argmax_equal": int((got.argmax(-1) == want.argmax(-1)).sum())}
    say("serving", step="bfloat16_kernels_vs_plain", **vs_plain)
    if not bool((diff <= BF16_TOL * scale + BF16_TOL * want.abs()).all()):
        fail(f"bfloat16 prefill: kernel model vs plain twin: {vs_plain}")
    out["bfloat16_vs_plain"] = vs_plain

    # prefill/decode consistency, the kernel model's gap held against the
    # plain twin's on the same weights and tokens
    kernel_gap = consistency_gap(model, toks, full_logits)
    plain_gap = consistency_gap(twin, toks, twin_logits)
    top = kernel_gap["max_abs_logit"]
    bf16_unit = float(2.0 ** (np.floor(np.log2(top)) - 7)) if top > 0 else 0.0
    limit = min(max(CONSISTENCY_VS_PLAIN * plain_gap["max_abs_err"], bf16_unit),
                CONSISTENCY_TOL * top)
    consistency = {"kernels": kernel_gap, "plain": plain_gap, "limit": limit,
                   "limit_rule": f"min(max({CONSISTENCY_VS_PLAIN} x plain gap, "
                                 f"one bf16 unit at max |logit|), "
                                 f"{CONSISTENCY_TOL} x max |logit|)"}
    say("serving", step="prefill_decode_consistency", **consistency)
    if not kernel_gap["max_abs_err"] <= limit:
        fail(f"prefill/decode consistency: {consistency}")
    out["consistency"] = consistency
    del twin, twin_logits, full_logits
    return out, model


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

    at = timed[(K_FULL, torch.float64)]     # the shape simulate_batch scans
    attn = attn_timed[torch.bfloat16]       # the serving path's per-layer call
    norm = norm_timed[(8192, 1024, torch.bfloat16)]   # ln1 / ln2 rows of the prefill

    def launches_of(name):
        return {step: c[name] for step, c in by_step.items()}

    kernels = {"kernels": [{
        "name": "lindley_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lindley_scan.cu",
        "replaces": "src/repro/kernels/lindley_scan.py:100",
        "launches": path_launches, "max_abs_err": at["max_abs_err"],
        "ms": at["ms"], "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
        "bound_by": at["bound_by"], "library_ms": None,
        "shape": at["shape"], "dtype": at["dtype"],
        "launches_by_step": path["launches"],
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:92",
        "launches": serve_launches["flash_attention"],
        "max_abs_err": attn["max_abs_err"], "ms": attn["ms"],
        "plain_ms": attn["plain_ms"], "bound_ms": attn["bound_ms"],
        "bound_by": attn["bound_by"], "library_ms": attn["library_ms"],
        "device_ms": attn["device_ms"], "library_device_ms": attn["library_device_ms"],
        "shape": attn["shape"], "dtype": attn["dtype"],
        "float32": {k: attn_timed[torch.float32][k] for k in
                    ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                     "max_abs_err")},
        "launches_by_step": launches_of("flash_attention"),
    }, {
        "name": "rmsnorm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:40",
        "launches": serve_launches["rmsnorm"],
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
    }]}
    say("serving", step="summary", **{k: v for k, v in serving.items()
                                      if k != "launches"})
    print(smi.splitlines()[0], flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
