"""The port's placement search against the reference's, on the CPU.

Scores are quantised to 7 significant digits, so with one ``rng_seed``
the port on its ``torch`` and ``kernel`` backends (``device="cpu"``) must
reproduce the reference's ``segmented`` trajectory move for move, with
equal quantised objectives and equal winning placements.
"""
import numpy as np
import pytest
import torch

from repro.core.graphs import AppGraph, ClusterTopology, FreeCoreTracker
from repro.core.mapping import make_search_strategy as ref_make_search_strategy
from repro.search import joint_candidates as ref_joint_candidates
from repro.search import objective_of as ref_objective_of
from repro.search import search_placement as ref_search_placement
from repro_torch.core import convert
from repro_torch.core.mapping import STRATEGIES as PORT_STRATEGIES
from repro_torch.core.mapping import make_search_strategy
from repro_torch.search import (joint_candidates, objective_of,
                                search_placement, search_strategy_result)

torch.set_num_threads(1)


def _small_cluster():
    return ClusterTopology(n_nodes=8, sockets_per_node=2, cores_per_socket=2)


def _small_jobs(rng, n_jobs=4):
    patterns = ("all_to_all", "bcast_scatter", "gather_reduce", "linear")
    return [AppGraph.from_pattern(
        name=f"j{j}", pattern=patterns[int(rng.integers(len(patterns)))],
        n_procs=int(rng.integers(4, 9)),
        length=float(rng.choice([64 << 10, 2 << 20])),
        rate=10.0, count=40, job_id=j) for j in range(n_jobs)]


def _case(seed, fragmented):
    rng = np.random.default_rng(seed)
    cluster = _small_cluster()
    jobs = _small_jobs(rng, n_jobs=3 if fragmented else 4)
    tracker = None
    if fragmented:
        tracker = FreeCoreTracker(cluster)
        tracker.take_cores(rng.choice(cluster.n_cores, size=5, replace=False))
        tracker.set_offline(np.array([30, 31]))
    return jobs, cluster, tracker


def _assert_same_search(res, ref):
    assert res.trajectory == ref.trajectory
    assert res.objective == ref.objective
    assert res.seed_objective == ref.seed_objective
    assert res.seeds_scored == ref.seeds_scored
    assert (res.evaluations, res.accepted) == (ref.evaluations, ref.accepted)
    assert res.objective_scale == ref.objective_scale
    assert res.objective <= res.seed_objective          # never worse
    for jid, cores in ref.placement.assignments.items():
        np.testing.assert_array_equal(res.placement.assignments[jid], cores)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("anneal", [False, True], ids=["greedy", "anneal"])
@pytest.mark.parametrize("seed,fragmented,strategy",
                         [(7, False, "new"), (8, True, "cyclic"),
                          (9, False, "blocked")])
def test_trajectory_matches_reference_move_for_move(seed, fragmented,
                                                    strategy, anneal, backend):
    jobs, cluster, tracker = _case(seed, fragmented)
    ref = ref_search_placement(jobs, cluster, tracker, seed=strategy,
                               anneal=anneal, budget=64, population=8,
                               rng_seed=123, backend="segmented")
    t_cluster = convert.from_reference(cluster)
    t_tracker = None if tracker is None else \
        convert.from_reference(tracker, t_cluster)
    res = search_placement(convert.from_reference(jobs), t_cluster, t_tracker,
                           seed=strategy, anneal=anneal, budget=64,
                           population=8, rng_seed=123, backend=backend,
                           device="cpu")
    _assert_same_search(res, ref)
    assert ref.evaluations <= 64


@pytest.mark.parametrize("backend", ["segmented", "torch", "kernel"])
def test_objective_of_matches_reference(backend):
    jobs, cluster, _ = _case(3, False)
    ref = ref_search_placement(jobs, cluster, budget=16, rng_seed=1,
                               backend="segmented")
    want = ref_objective_of(jobs, ref.placement, cluster,
                            objective_scale=ref.objective_scale,
                            backend="segmented")
    t_cluster = convert.from_reference(cluster)
    got = objective_of(convert.from_reference(jobs),
                       convert.from_reference(ref.placement, t_cluster),
                       t_cluster, objective_scale=ref.objective_scale,
                       backend=backend, device="cpu")
    assert got == want == ref.objective


def test_search_strategies_claim_cores_like_the_reference():
    """``make_search_strategy`` binds ``device`` with its other defaults;
    the adapter claims the winning cores from the tracker it was given."""
    jobs, cluster, tracker = _case(8, True)
    t_cluster = convert.from_reference(cluster)
    t_tracker = convert.from_reference(tracker, t_cluster)
    t_jobs = convert.from_reference(jobs)
    knobs = dict(budget=32, population=8, rng_seed=5)
    ref_pl = ref_make_search_strategy("new", backend="segmented", **knobs)(
        jobs, cluster, tracker)
    strategy = make_search_strategy("new", backend="kernel", device="cpu",
                                    **knobs)
    assert strategy.__name__ == "search:new"
    pl = strategy(t_jobs, t_cluster, t_tracker)
    for jid, cores in ref_pl.assignments.items():
        np.testing.assert_array_equal(pl.assignments[jid], cores)
    np.testing.assert_array_equal(t_tracker.used, tracker.used)
    # the registered names take device= per call
    res = search_strategy_result(t_jobs, t_cluster, None, seed="new",
                                 backend="torch", device="cpu", **knobs)
    pl2 = PORT_STRATEGIES["search:new"](t_jobs, t_cluster, None,
                                        backend="torch", device="cpu", **knobs)
    for jid, cores in res.placement.assignments.items():
        np.testing.assert_array_equal(pl2.assignments[jid], cores)


def test_seed_resolution_errors():
    jobs, cluster, _ = _case(3, False)
    t_cluster = convert.from_reference(cluster)
    with pytest.raises(ValueError):
        search_placement([], t_cluster, seed="search:new", device="cpu")
    with pytest.raises(KeyError):
        search_placement([], t_cluster, seed="no_such_strategy", device="cpu")
    # the unknown-seed error lists the reference's seeds, the fleet's too
    with pytest.raises(KeyError) as want:
        ref_search_placement([], cluster, seed="no_such_strategy",
                             backend="segmented")
    with pytest.raises(KeyError) as got:
        search_placement([], t_cluster, seed="no_such_strategy", device="cpu")
    assert "new_tpu" in str(got.value) and str(got.value) == str(want.value)
    # the fleet seed resolves through core.meshplan and the search succeeds
    t_jobs = convert.from_reference(jobs)
    knobs = dict(budget=16, population=4, rng_seed=2)
    ref = ref_search_placement(jobs, cluster, seed="new_tpu",
                               backend="segmented", **knobs)
    res = search_placement(t_jobs, t_cluster, seed="new_tpu",
                           backend="segmented", device="cpu", **knobs)
    assert res.seed_name == ref.seed_name == "new_tpu"
    _assert_same_search(res, ref)


def test_search_without_a_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jobs, cluster, _ = _case(3, False)
    with pytest.raises(RuntimeError):
        search_placement(convert.from_reference(jobs),
                         convert.from_reference(cluster), budget=8)


@pytest.mark.parametrize("seed,k", [(0, 4), (1, 8), (2, 12)])
def test_joint_candidates_same_list(seed, k):
    jobs, cluster, tracker = _case(seed, True)
    free = tracker.free_mask()
    want = ref_joint_candidates(jobs, cluster, free,
                                np.random.default_rng(seed), k)
    got = joint_candidates(convert.from_reference(jobs),
                           convert.from_reference(cluster), free.copy(),
                           np.random.default_rng(seed), k)
    assert len(got) == len(want) >= 1
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for jid in b:
            np.testing.assert_array_equal(a[jid], b[jid])


@pytest.mark.parametrize("n_free", [0, 3, 12])
def test_joint_candidates_tight_pool_same_list(n_free):
    """A pool the batch does not fit, or barely fits: strategies that run
    out of cores are skipped in both packages, nothing else is."""
    jobs, cluster, _ = _case(0, False)
    free = np.zeros(cluster.n_cores, dtype=bool)
    free[:n_free] = True
    batch = jobs[:2]
    want = ref_joint_candidates(batch, cluster, free,
                                np.random.default_rng(0), 6)
    got = joint_candidates(convert.from_reference(batch),
                           convert.from_reference(cluster), free.copy(),
                           np.random.default_rng(0), 6)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for jid in b:
            np.testing.assert_array_equal(a[jid], b[jid])


def test_joint_candidates_lets_a_fault_of_extra_pass():
    """Only "does not fit" drops a candidate: a strategy that fails for
    another reason (a kernel that does not launch, no CUDA device) is not
    swallowed."""
    jobs, cluster, tracker = _case(1, True)

    def broken(graphs, cluster, tracker):
        raise RuntimeError("kernel launch failed")

    with pytest.raises(RuntimeError, match="kernel launch failed"):
        joint_candidates(convert.from_reference(jobs),
                         convert.from_reference(cluster),
                         tracker.free_mask(), np.random.default_rng(0), 4,
                         extra=broken)
