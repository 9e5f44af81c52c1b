#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every hand-written kernel from the sources in this checkout, holds
each against its plain PyTorch version on the card, then drives the port's
main path at full size — the paper's Table-4 workload at
``count_scale=1.0`` (4.34 M messages) on the 16-node x 16-core cluster:
mapping -> ``simulate`` -> ``simulate_batch`` (K = 16) ->
``search_placement`` — and checks the results against the port's host
``segmented`` backend. Needs a CUDA card and ``nvcc``; exits non-zero when
either is missing or any phase fails. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it lists the kernels
with their measured times, launch counts and roofline bounds.
"""
from __future__ import annotations

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
from repro_torch.core import ClusterTopology, mapping, workloads  # noqa: E402
from repro_torch.core.simulator import simulate, simulate_batch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import lindley_scan as ls  # noqa: E402
from repro_torch.search import search_placement  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet): the roofline bounds
# below are stated against these whatever the card's power limit.
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}
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

    # -- phase 2: build every kernel from the sources in this checkout
    t0 = time.perf_counter()
    lib = _build.load("lindley_scan")
    say("build", source="src/repro_torch/kernels/csrc/lindley_scan.cu",
        library=str(_build.library_path("lindley_scan")),
        seconds=time.perf_counter() - t0, loaded=lib is not None)

    # -- phase 3: each kernel against its plain version
    timed = check_kernels(device)

    # -- phase 4: the main path at full size, launch counts from 0
    ls.launch_count = 0
    path = main_path(device)
    path_launches = ls.launch_count
    if path_launches <= 0 or min(path["launches"].values()) <= 0:
        fail(f"the main path did not launch the kernel: {path['launches']}")

    at = timed[(K_FULL, torch.float64)]     # the shape simulate_batch scans
    kernels = {"kernels": [{
        "name": "lindley_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lindley_scan.cu",
        "replaces": "src/repro/kernels/lindley_scan.py:100",
        "launches": path_launches, "max_abs_err": at["max_abs_err"],
        "ms": at["ms"], "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
        "bound_by": at["bound_by"], "library_ms": None,
        "shape": at["shape"], "dtype": at["dtype"],
        "launches_by_step": path["launches"],
    }]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
