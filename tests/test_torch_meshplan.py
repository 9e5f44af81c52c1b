"""The port's fleet mesh planner (``core.meshplan``) against the
reference's, on the CPU.

Both packages plan the same jobs on the same 512-chip fleet: the
topologies are equal field for field, ``new_tpu`` places every job on the
same chips, core for core, the static metrics agree to 1e-12 relative,
the searches seeded from ``new_tpu`` take the same trajectory on the host
``segmented`` backend, and the ``serve_fleet`` trace decides identically
in both schedulers. Also the reference's own meshplan assertions
(``tests/test_commgraph_meshplan.py``, ``tests/test_sched.py``,
``tests/test_hierarchy.py``), held on the port.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.core.meshplan as R
from repro.core.graphs import FreeCoreTracker as RefFreeCoreTracker
from repro.core.simulator import simulate as ref_simulate
from repro.sched import get_trace as ref_get_trace
from repro.sched import resolve_strategy as ref_resolve_strategy
from repro.sched import traces as ref_traces
from repro.search import search_placement as ref_search_placement
from repro_torch import configs
from repro_torch.core import ClusterFull, convert
from repro_torch.core import meshplan as P
from repro_torch.core.mapping import recursive_bisect
from repro_torch.core.simulator import simulate
from repro_torch.sched import resolve_strategy
from repro_torch.search import search_placement
from torch_port_util import (assert_results_close, assert_same_run,
                             reference_x64, run_pair)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEGMENTED = {"sim_backend": "segmented"}
STRATEGIES = ("blocked", "cyclic", "drb", "new", "new_tpu", "recursive_bisect")
ONE_POD = {"data": 16, "model": 16}
TWO_PODS = {"pod": 2, "data": 16, "model": 16}

#: the job set of ``examples/multi_job_placement.py``
MULTI_JOB = (
    ("yi-6b-train (spans pods)", "yi-6b", "train_4k",
     {"pod": 2, "data": 12, "model": 16}),
    ("qwen2-moe-train", "qwen2-moe-a2.7b", "train_4k", {"data": 4, "model": 16}),
    ("granite-decode", "granite-3-2b", "decode_32k", {"data": 4, "model": 16}),
)
#: the fleet part of ``examples/quickstart.py``
QUICKSTART = (("phi3.5-moe", "phi3.5-moe-42b-a6.6b", "train_4k", TWO_PODS),)
#: one pod-spanning job whose crossing endpoints the balance pass moves
SPANNING = (("yi-big", "yi-6b", "train_4k", TWO_PODS),)


def _specs(rows):
    """Fresh reference JobSpecs and the port's copies of them."""
    ref = [R.JobSpec(name, ref_configs.get_config(arch),
                     ref_configs.SHAPES[shape], dict(axes))
           for name, arch, shape, axes in rows]
    return ref, convert.from_reference(ref)


def _topos(n_pods=2):
    return R.tpu_topology(n_pods=n_pods), P.tpu_topology(n_pods=n_pods)


def _same_assignments(got, want):
    assert sorted(got.assignments) == sorted(want.assignments)
    for jid, cores in want.assignments.items():
        np.testing.assert_array_equal(got.assignments[jid], cores)


def _close_tree(got, want, tol, what=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            _close_tree(got[k], want[k], tol, f"{what}[{k!r}]")
    else:
        assert got == pytest.approx(want, rel=tol, abs=0.0), what


def _fragmented(seed, topo, t_topo):
    """A reference tracker with random cores taken and offline, and the
    port's copy of it."""
    rng = np.random.default_rng(seed)
    tracker = RefFreeCoreTracker(topo)
    tracker.take_cores(rng.choice(topo.n_cores, size=96, replace=False))
    tracker.set_offline(np.flatnonzero(rng.random(topo.n_cores) < 0.05))
    return tracker, convert.from_reference(tracker, t_topo)


# ---------------------------------------------------------------------------
# The fleet's parameters and topology
# ---------------------------------------------------------------------------
def test_fleet_config_matches_reference():
    """``FleetConfig`` keeps every field of the reference's, with its
    values (the roofline-only fields included)."""
    names = [f.name for f in dataclasses.fields(configs.FleetConfig)]
    assert names == [f.name for f in dataclasses.fields(ref_configs.FleetConfig)]
    assert dataclasses.asdict(configs.FLEET) == \
        dataclasses.asdict(ref_configs.FLEET)
    assert configs.FLEET.hosts_per_pod == ref_configs.FLEET.hosts_per_pod == 32
    assert convert.from_reference(ref_configs.FLEET) == configs.FLEET
    other = ref_configs.FleetConfig(chips_per_pod=64, dcn_bw_per_host=1e9)
    assert dataclasses.asdict(convert.from_reference(other)) == \
        dataclasses.asdict(other)


@pytest.mark.parametrize("n_pods", [1, 2, 4])
def test_tpu_topology_matches_reference(n_pods):
    topo, t_topo = _topos(n_pods)
    assert convert._cluster_fields_of(t_topo) == convert._cluster_fields_of(topo)
    assert (t_topo.n_cores, t_topo.nodes_per_pod) == (topo.n_cores,
                                                      topo.nodes_per_pod)
    assert t_topo.net_hierarchy().describe() == topo.net_hierarchy().describe()
    fleet = ref_configs.FleetConfig(chips_per_pod=128, ici_links_per_chip=6)
    assert convert._cluster_fields_of(
        P.tpu_topology(n_pods, convert.from_reference(fleet))) == \
        convert._cluster_fields_of(R.tpu_topology(n_pods, fleet))


def test_jobspec_and_configs_convert_field_for_field():
    ref, port = _specs(MULTI_JOB)
    for a, b in zip(port, ref, strict=True):
        assert a.cfg == configs.get_config(b.cfg.arch_id)
        assert a.shape == configs.SHAPES[b.shape.name]
        assert (a.name, a.mesh_axes, a.job_id) == (b.name, b.mesh_axes, b.job_id)
        assert a.mesh_axes is not b.mesh_axes


def test_importing_core_leaves_configs_out():
    """``core`` itself stays free of ``configs``; the planner pulls it in."""
    code = ("import sys\n"
            "import repro_torch.core\n"
            "assert 'repro_torch.configs' not in sys.modules\n"
            "import repro_torch.sched\n"
            "assert 'repro_torch.core.meshplan' not in sys.modules\n"
            "from repro_torch.sched import resolve_strategy\n"
            "resolve_strategy('new_tpu')\n"
            "assert 'repro_torch.core.meshplan' in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# new_tpu: the same chips, core for core
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rows", [QUICKSTART, MULTI_JOB, SPANNING],
                         ids=["quickstart", "multi_job", "spanning"])
def test_new_tpu_places_like_the_reference(rows):
    topo, t_topo = _topos()
    ref, port = _specs(rows)
    want, want_graphs = R.place_jobs(ref, topo, strategy="new_tpu")
    got, graphs = P.place_jobs(port, t_topo, strategy="new_tpu")
    _same_assignments(got, want)
    got.validate()
    assert [j.job_id for j in port] == [j.job_id for j in ref] == \
        list(range(len(rows)))
    for a, b in zip(graphs, want_graphs, strict=True):
        np.testing.assert_array_equal(a.demand, b.demand)


def test_new_tpu_balance_pass_swaps_like_the_reference():
    """The pod-spanning job's crossing endpoints leave their blocked hosts:
    the balance pass moved chips, and moved the same ones."""
    topo, t_topo = _topos()
    ref, port = _specs(SPANNING)
    ag, t_ag = ref[0].appgraph(), port[0].appgraph()
    blocked = np.arange(512, dtype=np.int64)
    want = R._nic_balance_pass(blocked, ag, topo)
    got = P._nic_balance_pass(blocked, t_ag, t_topo)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, blocked)
    np.testing.assert_array_equal(np.sort(got), blocked)


def test_new_tpu_places_the_serve_mix_like_the_reference():
    topo, t_topo = _topos()
    want = R.new_mapping_tpu(ref_traces.serve_fleet_mix(), topo)
    got = P.new_mapping_tpu(convert.from_reference(ref_traces.serve_fleet_mix()),
                            t_topo)
    _same_assignments(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_new_tpu_on_a_fragmented_fleet(seed):
    """Random chips taken and offline: the same placement, and the
    trackers take the same chips."""
    topo, t_topo = _topos()
    tracker, t_tracker = _fragmented(seed, topo, t_topo)
    graphs = ref_traces.serve_fleet_mix()
    want = R.new_mapping_tpu(graphs, topo, tracker)
    got = P.new_mapping_tpu(convert.from_reference(graphs), t_topo, t_tracker)
    _same_assignments(got, want)
    np.testing.assert_array_equal(t_tracker.used, tracker.used)
    np.testing.assert_array_equal(t_tracker.offline, tracker.offline)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_new_tpu_random_jobs_across_pods(seed):
    """Random banded traffic with a few long edges, random weights (every
    process a different demand, so the balance pass's orderings decide)
    on a fragmented fleet, the largest job spanning both pods: its
    crossing endpoints bunch on the hosts at the pod boundary."""
    from repro.core.graphs import AppGraph as RefAppGraph

    topo, t_topo = _topos()
    tracker, t_tracker = _fragmented(10 + seed, topo, t_topo)
    rng = np.random.default_rng(seed)
    graphs = []
    for jid, n in enumerate((int(rng.integers(260, 320)), 24, 9)):
        gap = np.abs(np.subtract.outer(np.arange(n), np.arange(n)))
        mask = ((gap > 0) & (gap <= 12)) | (rng.random((n, n)) < 2e-4)
        np.fill_diagonal(mask, False)
        L = np.where(mask, rng.choice([4096.0, 65536.0, 2097152.0], (n, n)), 0.0)
        lam = np.where(mask, rng.uniform(1.0, 50.0, (n, n)), 0.0)
        cnt = np.where(mask, rng.integers(1, 20, (n, n)), 0)
        graphs.append(RefAppGraph(name=f"r{jid}", L=L, lam=lam, cnt=cnt,
                                  job_id=jid))
    want = R.new_mapping_tpu(graphs, topo, tracker)
    got = P.new_mapping_tpu(convert.from_reference(graphs), t_topo, t_tracker)
    _same_assignments(got, want)
    np.testing.assert_array_equal(t_tracker.used, tracker.used)
    big = got.assignments[0]
    assert np.unique(t_topo.pod_of(big)).size == 2


# ---------------------------------------------------------------------------
# Static metrics: plan_device_order / compare_strategies / fleet_nic_load
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,axes", [
    ("phi3.5-moe-42b-a6.6b", TWO_PODS), ("yi-6b", TWO_PODS),
    ("granite-3-2b", ONE_POD)], ids=["phi3.5-moe", "yi-6b", "granite-one-pod"])
def test_compare_strategies_matches_reference(arch, axes):
    want = R.compare_strategies(ref_configs.get_config(arch),
                                ref_configs.SHAPES["train_4k"], axes)
    got = P.compare_strategies(configs.get_config(arch),
                               configs.SHAPES["train_4k"], axes)
    assert list(got) == list(want) == list(STRATEGIES)
    for s in STRATEGIES:
        assert got[s].strategy == s
        np.testing.assert_array_equal(got[s].perm, want[s].perm)
        _close_tree(got[s].metrics, want[s].metrics, 1e-12, s)


def test_chip_metrics_match_on_a_random_map():
    topo, t_topo = _topos()
    ref, port = _specs(QUICKSTART)
    cores = np.random.default_rng(5).permutation(512)
    want = R.chip_metrics(ref[0].appgraph(), cores, topo)
    got = P.chip_metrics(port[0].appgraph(), cores, t_topo)
    _close_tree(got, want, 1e-12)
    assert want["dcn_bytes"] > 0


@pytest.mark.parametrize("strategy", STRATEGIES[:5])
def test_fleet_nic_load_and_simulation_match_reference(strategy):
    """``examples/multi_job_placement.py`` on both packages: the same
    placement, NIC loads to 1e-12 and the full simulation on the host
    ``segmented`` backend to 1e-9."""
    topo, t_topo = _topos()
    ref, port = _specs(MULTI_JOB)
    want, want_graphs = R.place_jobs(ref, topo, strategy=strategy)
    got, graphs = P.place_jobs(port, t_topo, strategy=strategy)
    _same_assignments(got, want)
    _close_tree(P.fleet_nic_load(got, graphs, t_topo),
                R.fleet_nic_load(want, want_graphs, topo), 1e-12)
    if strategy == "new_tpu":
        res = simulate(graphs, got, t_topo, count_scale=1.0,
                       backend="segmented", device="cpu")
        base = ref_simulate(want_graphs, want, topo, count_scale=1.0,
                            backend="segmented")
        assert res.n_messages == base.n_messages == 116_160
        assert_results_close(res, base, 1e-9, "multi_job new_tpu")


# ---------------------------------------------------------------------------
# place_jobs: incremental mode, overflow, rollback
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("strategy", ["new", "new_tpu"])
def test_place_jobs_incremental_matches_reference(strategy):
    topo, t_topo = _topos()
    base = (("a", "qwen3-0.6b", "decode_32k", {"data": 4, "model": 4}),)
    extra = (("b", "granite-3-2b", "decode_32k", {"data": 4, "model": 8}),
             ("c", "mamba2-370m", "decode_32k", {"data": 8, "model": 2}))
    out = []
    for pkg, idx in ((R, 0), (P, 1)):
        topo_ = (topo, t_topo)[idx]
        placement, _ = pkg.place_jobs(_specs(base)[idx], topo_, strategy=strategy)
        before = {jid: c.copy() for jid, c in placement.assignments.items()}
        specs = _specs(extra)[idx]
        placement, graphs = pkg.place_jobs(specs, topo_, strategy=strategy,
                                           placement=placement)
        assert [g.job_id for g in graphs] == [j.job_id for j in specs] == [1, 2]
        placement.validate()
        for jid, cores in before.items():
            assert np.array_equal(placement.assignments[jid], cores)
        out.append(placement)
    _same_assignments(out[1], out[0])


@pytest.mark.parametrize("strategy", ["new_tpu", "blocked"])
def test_fleet_overflow_raises_cluster_full_and_restores(strategy):
    """A batch larger than the 512-chip fleet raises mid-batch: the
    reference a ``RuntimeError``, the port ``ClusterFull`` (a
    ``RuntimeError``); the caller's tracker is rolled back to its snapshot
    and the placement keeps only what it held."""
    topo, t_topo = _topos()
    first = (("a", "qwen3-0.6b", "decode_32k", {"data": 4, "model": 4}),)
    overflow = (("b", "yi-6b", "train_4k", ONE_POD),
                ("c", "granite-3-2b", "train_4k", ONE_POD))
    for pkg, idx, err in ((R, 0, RuntimeError), (P, 1, ClusterFull)):
        topo_ = (topo, t_topo)[idx]
        placement, _ = pkg.place_jobs(_specs(first)[idx], topo_, strategy=strategy)
        tracker = (RefFreeCoreTracker if idx == 0 else
                   P.FreeCoreTracker).from_placement(placement)
        snap = tracker.snapshot()
        with pytest.raises(err, match="full") as raised:
            pkg.place_jobs(_specs(overflow)[idx], topo_, strategy=strategy,
                           placement=placement, tracker=tracker)
        assert isinstance(raised.value, RuntimeError)
        np.testing.assert_array_equal(tracker.used, snap)
        assert sorted(placement.assignments) == [0]


# ---------------------------------------------------------------------------
# search:new_tpu
# ---------------------------------------------------------------------------
def _assert_same_search(res, ref):
    assert res.trajectory == ref.trajectory
    assert (res.objective, res.seed_objective) == (ref.objective,
                                                   ref.seed_objective)
    assert res.seeds_scored == ref.seeds_scored
    assert (res.evaluations, res.accepted) == (ref.evaluations, ref.accepted)
    assert res.seed_name == ref.seed_name == "new_tpu"
    _same_assignments(res.placement, ref.placement)


@pytest.mark.parametrize("fragmented", [False, True], ids=["empty", "fragmented"])
def test_search_seeded_from_new_tpu_matches_reference(fragmented):
    topo, t_topo = _topos()
    tracker = t_tracker = None
    if fragmented:
        tracker, t_tracker = _fragmented(3, topo, t_topo)
    graphs = ref_traces.serve_fleet_mix()[:3]
    knobs = dict(seed="new_tpu", budget=24, population=6, rng_seed=4)
    ref = ref_search_placement(graphs, topo, tracker, backend="segmented",
                               **knobs)
    res = search_placement(convert.from_reference(graphs), t_topo, t_tracker,
                           backend="segmented", device="cpu", **knobs)
    _assert_same_search(res, ref)
    assert res.objective <= res.seed_objective


def test_search_new_tpu_through_place_jobs_matches_reference():
    """The registered strategy at its defaults (``place_jobs`` on the
    multi-job set), scored on the host in both packages."""
    topo, t_topo = _topos()
    ref, port = _specs(MULTI_JOB)
    want, _ = R.place_jobs(ref, topo, strategy="search:new_tpu")
    got, _ = P.place_jobs(port, t_topo, strategy="search:new_tpu", device="cpu")
    _same_assignments(got, want)
    assert P.TPU_STRATEGIES["search:new_tpu"].__name__ == "search:new_tpu"


def test_search_new_tpu_on_torch_matches_reference_jax():
    """The port's plain torch scan against the reference's float64 ``jax``
    backend: objectives within 1e-9, the same placement."""
    topo, t_topo = _topos()
    graphs = ref_traces.serve_fleet_mix()[:2]
    knobs = dict(seed="new_tpu", budget=12, population=4, rng_seed=1)
    with reference_x64():
        ref = ref_search_placement(graphs, topo, backend="jax", **knobs)
    tracker = P.FreeCoreTracker(t_topo)
    pl = P.TPU_STRATEGIES["search:new_tpu"](
        convert.from_reference(graphs), t_topo, tracker, backend="torch",
        device="cpu", **{k: v for k, v in knobs.items() if k != "seed"})
    res = search_placement(convert.from_reference(graphs), t_topo,
                           backend="torch", device="cpu", **knobs)
    assert res.objective == pytest.approx(ref.objective, rel=1e-9)
    assert res.seed_objective == pytest.approx(ref.seed_objective, rel=1e-9)
    _same_assignments(res.placement, ref.placement)
    _same_assignments(pl, ref.placement)
    assert tracker.used.sum() == sum(g.n_procs for g in graphs)


def test_search_new_tpu_without_a_device_needs_cuda(monkeypatch):
    """``device=None`` is the CUDA card: without one the search raises, it
    neither falls back nor runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, t_topo = _topos()
    graphs = convert.from_reference(ref_traces.serve_fleet_mix()[:1])
    strategy = resolve_strategy("search:new_tpu", device=None)
    with pytest.raises(RuntimeError, match="device=None means the CUDA card"):
        strategy(graphs, t_topo, P.FreeCoreTracker(t_topo))
    with pytest.raises(RuntimeError, match="device=None means the CUDA card"):
        P.place_jobs(_specs(QUICKSTART)[1], t_topo, strategy="search:new_tpu")
    # the one-shot fleet strategy uses no device
    assert resolve_strategy("new_tpu") is P.new_mapping_tpu


# ---------------------------------------------------------------------------
# The serve_fleet trace in the scheduler
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [{"seed": 3, "n_arrivals": 20}, {"rate": 0.1}],
                         ids=["seed3", "rate"])
def test_serve_fleet_trace_matches_reference(kw):
    from repro_torch.sched import get_trace

    want = ref_get_trace("serve_fleet", **kw)
    got = get_trace("serve_fleet", **kw)
    assert convert._cluster_fields_of(got.cluster) == \
        convert._cluster_fields_of(want.cluster)
    assert [(a.time, a.graph.name, a.graph.job_id) for a in got.arrivals] == \
        [(a.time, a.graph.name, a.graph.job_id) for a in want.arrivals]
    for a, b in zip(got.arrivals, want.arrivals):
        np.testing.assert_array_equal(a.graph.cnt, b.graph.cnt)
        np.testing.assert_array_equal(a.graph.lam, b.graph.lam)
    assert (got.count_scale, got.state_bytes_per_proc) == (1.0, 2e9)


@pytest.mark.parametrize("strategy", ["new_tpu", "search:new_tpu", "cyclic", "new"])
def test_serve_fleet_run_matches_reference(strategy):
    """The registered trace (12 arrivals, 288 chips asked for in all) on
    the 512-chip fleet: equal ``FleetStats``, identical decisions and
    byte-identical recorder dumps, invariants after every event."""
    ref, port = run_pair(ref_get_trace("serve_fleet"), strategy, SEGMENTED)
    assert ref.stats.n_jobs == 12 and ref.events
    assert sum(a.graph.n_procs for a in ref_get_trace("serve_fleet").arrivals) == 288
    assert_same_run(port, ref)


# ---------------------------------------------------------------------------
# The reference's own meshplan assertions, on the port
# ---------------------------------------------------------------------------
def test_plan_perm_is_bijection():
    res = P.plan_device_order(configs.get_config("yi-6b"),
                              configs.SHAPES["train_4k"], TWO_PODS,
                              strategy="new_tpu")
    assert res.perm.size == 512
    assert np.array_equal(np.sort(res.perm), np.arange(512))


def test_new_tpu_never_worse_nic_than_blocked():
    topo = P.tpu_topology(n_pods=2)
    for arch in ("yi-6b", "phi3.5-moe-42b-a6.6b", "granite-3-2b"):
        res = P.compare_strategies(configs.get_config(arch),
                                   configs.SHAPES["train_4k"], TWO_PODS, topo,
                                   strategies=("blocked", "new_tpu"))
        assert (res["new_tpu"].metrics["max_nic_load"]
                <= res["blocked"].metrics["max_nic_load"] * 1.001), arch
        assert (res["new_tpu"].metrics["dcn_bytes"]
                <= res["blocked"].metrics["dcn_bytes"] * 1.001), arch


def test_new_tpu_fits_jobs_in_pods():
    topo = P.tpu_topology(n_pods=2)
    _, jobs = _specs((("a", "yi-6b", "train_4k", {"data": 8, "model": 16}),
                      ("b", "granite-3-2b", "train_4k", {"data": 8, "model": 16})))
    placement, graphs = P.place_jobs(jobs, topo, strategy="new_tpu")
    assert P.fleet_nic_load(placement, graphs, topo)["total_dcn_bytes"] == 0.0


def test_new_tpu_balances_overflow_job():
    topo = P.tpu_topology(n_pods=2)
    res = {}
    for s in ("blocked", "new_tpu"):
        placement, graphs = P.place_jobs(_specs(SPANNING)[1], topo, strategy=s)
        res[s] = P.fleet_nic_load(placement, graphs, topo)
    np.testing.assert_allclose(res["new_tpu"]["total_dcn_bytes"],
                               res["blocked"]["total_dcn_bytes"], rtol=1e-6)
    assert res["new_tpu"]["max_nic_load"] < res["blocked"]["max_nic_load"]


def test_chip_metrics_zero_when_single_pod():
    from repro_torch.core.commgraph import appgraph_for

    ag = appgraph_for(configs.get_config("granite-3-2b"),
                      configs.SHAPES["train_4k"], ONE_POD)
    m = P.chip_metrics(ag, np.arange(256), P.tpu_topology(n_pods=1))
    assert m["dcn_bytes"] == 0.0
    assert m["ici_bytes"] > 0


def test_place_jobs_incremental_extends_existing_placement():
    topo = P.tpu_topology(n_pods=2)
    _, base = _specs((("a", "qwen3-0.6b", "decode_32k", {"data": 4, "model": 4}),))
    placement, graphs = P.place_jobs(base, topo, strategy="new")
    before = {jid: c.copy() for jid, c in placement.assignments.items()}
    _, extra = _specs((("b", "granite-3-2b", "decode_32k", {"data": 4, "model": 8}),))
    placement, new_graphs = P.place_jobs(extra, topo, strategy="new",
                                         placement=placement)
    assert new_graphs[0].job_id == 1
    placement.validate()
    for jid, cores in before.items():
        assert np.array_equal(placement.assignments[jid], cores)
    assert not set(placement.assignments[1]) & set(before[0])


def test_rb_registered_everywhere():
    assert "recursive_bisect" in P.TPU_STRATEGIES
    assert resolve_strategy("recursive_bisect") is recursive_bisect
    assert set(P.TPU_STRATEGIES) == set(R.TPU_STRATEGIES)
    for name in ("new_tpu", "search:new_tpu"):
        assert callable(ref_resolve_strategy(name))
