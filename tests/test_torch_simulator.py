"""The port's simulator against the reference's, on the CPU.

Random workloads on flat, ICI/pod and random 2-4 level hierarchies: the
reference's ``loop`` backend is the base; the port's ``loop``,
``segmented``, ``torch`` and ``kernel`` backends (``device="cpu"``, so the
kernel's wrapper takes its plain version) must agree at 1e-9 (float64
scans re-associate the same sums) with utilisation at ``abs 1e-6``.
"""
import numpy as np
import pytest
import torch

from repro.core import ClusterTopology, Placement
from repro.core import simulate as ref_simulate
from repro.core import simulate_batch as ref_simulate_batch
from repro.core.graphs import PATTERNS, AppGraph, tie_phase
from repro_torch.core import convert
from repro_torch.core import simulator as port_sim
from repro_torch.core.sim_scan import simulate_scan, simulate_scan_batch
from torch_port_util import (KB, MB, assert_results_close, close,
                             permuted_trials, reference_x64, scenario, to_port)

torch.set_num_threads(1)

TOL = 1e-9
PORT_BACKENDS = ("loop", "segmented", "torch", "kernel")
SCENARIOS = [("flat", 0, 1), ("flat", 1, 3), ("flat", 2, 6),
             ("ici_pod", 3, 4), ("ici_pod", 4, 4),
             ("hierarchy", 5, 2), ("hierarchy", 6, 4), ("hierarchy", 7, 6),
             ("hierarchy", 8, 5)]


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("kind,seed,n_jobs", SCENARIOS)
def test_backends_match_reference_loop(kind, seed, n_jobs, backend):
    jobs, placement, cluster = scenario(kind, seed, n_jobs)
    base = ref_simulate(jobs, placement, cluster, backend="loop")
    assert base.n_messages > 0
    t_jobs, t_placement, t_cluster = to_port(jobs, placement, cluster)
    res = port_sim.simulate(t_jobs, t_placement, t_cluster, backend=backend,
                            device="cpu")
    assert_results_close(res, base, TOL, f"{kind}/{seed} {backend}")


@pytest.mark.parametrize("kind,seed,n_jobs", SCENARIOS[1::3])
def test_kernel_backend_float32_on_request(kind, seed, n_jobs):
    """float32 elements through the kernel's wrapper: the reference's
    float32 tolerance (2e-3), against the reference's float32 kernel too."""
    jobs, placement, cluster = scenario(kind, seed, n_jobs)
    base = ref_simulate(jobs, placement, cluster, backend="loop")
    ref32 = ref_simulate(jobs, placement, cluster, backend="pallas")
    t_jobs, t_placement, t_cluster = to_port(jobs, placement, cluster)
    res = simulate_scan(t_jobs, t_placement, t_cluster, backend="kernel",
                        device="cpu", dtype=torch.float32)
    close(res.total_wait, base.total_wait, 2e-3, "f32 total_wait")
    close(res.workload_finish, base.workload_finish, 2e-3, "f32 finish")
    close(res.total_wait, ref32.total_wait, 2e-3, "f32 vs reference kernel")
    batch = simulate_scan_batch(t_jobs, [t_placement], t_cluster,
                                backend="kernel", device="cpu",
                                dtype=torch.float32)
    close(batch[0].total_wait, base.total_wait, 2e-3, "f32 batch total_wait")


@pytest.mark.parametrize("backend", ("segmented", "torch", "kernel"))
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("kind,seed", [("flat", 11), ("hierarchy", 12)])
def test_simulate_batch_matches_singles_and_reference(kind, seed, k, backend):
    jobs, placement, cluster = scenario(kind, seed, 4)
    trials = permuted_trials(np.random.default_rng(seed), jobs, placement, k)
    with reference_x64():
        ref_batch = ref_simulate_batch(jobs, trials, cluster, backend="jax")
    t_jobs, _, t_cluster = to_port(jobs, placement, cluster)
    t_trials = [convert.from_reference(p, t_cluster) for p in trials]
    batch = port_sim.simulate_batch(t_jobs, t_trials, t_cluster,
                                    backend=backend, device="cpu")
    assert len(batch) == k
    for i, (res, p) in enumerate(zip(batch, t_trials)):
        single = port_sim.simulate(t_jobs, p, t_cluster, backend=backend,
                                   device="cpu")
        assert_results_close(res, single, TOL, f"batch[{i}] vs single")
        assert_results_close(res, ref_batch[i], TOL, f"batch[{i}] vs jax")
        assert_results_close(
            res, ref_simulate(jobs, trials[i], cluster, backend="loop"), TOL,
            f"batch[{i}] vs loop")


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_sim_handle_under_churn_matches_cold_calls(seed, backend):
    rng = np.random.default_rng(seed)
    cluster = ClusterTopology(n_nodes=4)
    t_cluster = convert.from_reference(cluster)
    handle = port_sim.SimHandle(t_cluster, count_scale=1.0, backend=backend,
                                device="cpu")
    live, t_live, next_id = [], [], 0
    steps = 0
    for _ in range(10):
        if live and rng.random() < 0.4:
            i = int(rng.integers(0, len(live)))
            live.pop(i)
            t_live.pop(i)
        else:
            pattern = PATTERNS[int(rng.integers(0, len(PATTERNS)))]
            job = AppGraph.from_pattern(
                f"h{next_id}", pattern, int(rng.integers(2, 7)), 64 * KB,
                50.0, int(rng.integers(1, 25)), job_id=next_id)
            live.append(job)
            t_live.append(convert.from_reference(job))
            next_id += 1
        if not live:
            continue
        if sum(j.n_procs for j in live) > cluster.n_cores:
            live.pop()
            t_live.pop()
            continue
        placement = Placement(cluster)
        off = 0
        for job in live:
            placement.assign(job.job_id, np.arange(off, off + job.n_procs))
            off += job.n_procs
        t_placement = convert.from_reference(placement, t_cluster)
        warm = handle.simulate(t_live, t_placement)
        cold = port_sim.simulate(t_live, t_placement, t_cluster,
                                 backend=backend, device="cpu")
        ref = ref_simulate(live, placement, cluster, 1.0, backend="loop")
        assert_results_close(warm, cold, TOL, "warm vs cold")
        assert_results_close(warm, ref, TOL, "warm vs reference loop")
        if backend in ("torch", "kernel"):
            both = handle.simulate_batch(t_live, [t_placement, t_placement])
            assert_results_close(both[1], ref, TOL, "warm batch")
        steps += 1
    assert steps >= 5


def _tie_single_job():
    """One job whose rank 0 emits to two receivers at identical instants
    through the same NIC (the in-scan tie repair)."""
    L = np.zeros((6, 6))
    lam = np.zeros((6, 6))
    cnt = np.zeros((6, 6), dtype=np.int64)
    for i, j in ((0, 3), (1, 4), (2, 5)):
        L[i, j], lam[i, j], cnt[i, j] = 1 * MB, 50.0, 20
    L[0, 4], lam[0, 4], cnt[0, 4] = 2 * MB, 50.0, 20
    cluster = ClusterTopology(n_nodes=4)
    placement = Placement(cluster)
    placement.assign(0, np.array([0, 1, 2, 16, 32, 48]))
    return [AppGraph("tie", L, lam, cnt, job_id=0)], placement, cluster


def _tie_cross_job():
    """Two jobs whose phases collide exactly (job_id 104729 wraps the
    phase modulus): their RX arrivals tie and the later-stage repair must
    restore flattening order."""
    assert float(tie_phase(0, 0)) == float(tie_phase(104729, 0))
    cluster = ClusterTopology(n_nodes=4)
    jobs, placement = [], Placement(cluster)
    for jid, (s_core, r_core) in ((0, (16, 32)), (104729, (0, 33))):
        jobs.append(AppGraph.from_pattern(f"j{jid}", "linear", 2, 64 * KB,
                                          10.0, 15, job_id=jid))
        placement.assign(jid, np.array([s_core, r_core]))
    return jobs, placement, cluster


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("make", [_tie_single_job, _tie_cross_job],
                         ids=["colliding_phases", "cross_job_collision"])
def test_deliberate_ties_match_reference_loop(make, backend):
    jobs, placement, cluster = make()
    base = ref_simulate(jobs, placement, cluster, backend="loop")
    assert base.total_wait > 0.0
    t_jobs, t_placement, t_cluster = to_port(jobs, placement, cluster)
    res = port_sim.simulate(t_jobs, t_placement, t_cluster, backend=backend,
                            device="cpu")
    assert_results_close(res, base, TOL, f"{backend} ties")
    if backend in ("torch", "kernel"):
        batch = port_sim.simulate_batch(t_jobs, [t_placement], t_cluster,
                                        backend=backend, device="cpu")
        assert_results_close(batch[0], base, TOL, f"{backend} batch ties")


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_empty_workload(backend):
    cluster = convert.cluster_from_fields(n_nodes=2)
    placement = convert.placement_from_assignments(cluster, {})
    res = port_sim.simulate([], placement, cluster, backend=backend,
                            device="cpu")
    assert res.total_wait == 0.0 and res.n_messages == 0
    assert port_sim.simulate_batch([], [placement], cluster, backend=backend,
                                   device="cpu")[0].n_messages == 0
    assert port_sim.simulate_batch([], [], cluster, backend=backend,
                                   device="cpu") == []


def test_resolve_backend_follows_the_device(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_SIM_BACKEND", raising=False)
    assert port_sim.BACKENDS == ("loop", "segmented", "torch", "kernel")
    assert port_sim.resolve_backend("auto", "cpu") == "segmented"
    assert port_sim.resolve_backend(None, torch.device("cpu")) == "segmented"
    for name in port_sim.BACKENDS:
        assert port_sim.resolve_backend(name, "cpu") == name
    with pytest.raises(KeyError):
        port_sim.resolve_backend("jax", "cpu")
    with pytest.raises(KeyError):
        port_sim.resolve_backend("omnetpp", "cpu")
    monkeypatch.setenv("REPRO_TORCH_SIM_BACKEND", "torch")
    assert port_sim.resolve_backend("auto", "cpu") == "torch"
    assert port_sim.resolve_backend("loop", "cpu") == "loop"
    # the reference's variable is not shared
    monkeypatch.delenv("REPRO_TORCH_SIM_BACKEND")
    monkeypatch.setenv("REPRO_SIM_BACKEND", "loop")
    assert port_sim.resolve_backend("auto", "cpu") == "segmented"


def test_device_none_raises_without_cuda(monkeypatch):
    """``device=None`` is the CUDA card; where there is none every entry
    point raises instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jobs, placement, cluster = to_port(*scenario("flat", 0, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_sim.resolve_device(None)
    with pytest.raises(RuntimeError):
        port_sim.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        port_sim.resolve_backend("auto")
    with pytest.raises(RuntimeError):
        port_sim.simulate(jobs, placement, cluster)
    with pytest.raises(RuntimeError):
        port_sim.simulate_batch(jobs, [placement], cluster, backend="segmented")
    with pytest.raises(RuntimeError):
        port_sim.SimHandle(cluster)
    assert port_sim.resolve_device("cpu") == torch.device("cpu")
