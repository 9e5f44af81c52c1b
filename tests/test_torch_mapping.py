"""One-shot mapping strategies and message flattening: port vs reference.

Host-side combinatorial code, so the contract is exact: every strategy
gives the reference's placement core for core, and ``FlatMessages``
arrays are bit-equal.
"""
import numpy as np
import pytest
import torch

from repro.core import ClusterTopology, FreeCoreTracker, NetLevel, NetworkHierarchy
from repro.core import mapping as ref_mapping
from repro.core import workloads as ref_workloads
from repro_torch.core import convert
from repro_torch.core import mapping as port_mapping
from repro_torch.core import workloads as port_workloads

torch.set_num_threads(1)

TABLES = ["synt_workload_1", "synt_workload_2", "synt_workload_3",
          "synt_workload_4"]


def _rack_cluster():
    hier = NetworkHierarchy([
        NetLevel("node", fan_in=8, bw=1e9, latency=100e-9),
        NetLevel("rack", fan_in=4, bw=1e9, latency=300e-9),
        NetLevel("pod", fan_in=4, bw=1e9, latency=1e-6),
    ])
    return ClusterTopology(n_nodes=32, sockets_per_node=2, cores_per_socket=4,
                           nic_bw=1e9, hierarchy=hier)


def _assert_same_placement(ref_pl, port_pl):
    assert ref_pl.assignments.keys() == port_pl.assignments.keys()
    for jid, cores in ref_pl.assignments.items():
        np.testing.assert_array_equal(port_pl.assignments[jid], cores)


def test_strategy_registries_match():
    assert port_mapping.ONE_SHOT_STRATEGIES == ref_mapping.ONE_SHOT_STRATEGIES
    assert sorted(port_mapping.STRATEGIES) == sorted(ref_mapping.STRATEGIES)


@pytest.mark.parametrize("strategy", ref_mapping.ONE_SHOT_STRATEGIES)
@pytest.mark.parametrize("table", TABLES)
def test_paper_tables_place_core_for_core(table, strategy):
    ref_jobs = getattr(ref_workloads, table)()
    port_jobs = getattr(port_workloads, table)()
    ref_cluster = ClusterTopology()
    port_cluster = convert.from_reference(ref_cluster)
    _assert_same_placement(
        ref_mapping.STRATEGIES[strategy](ref_jobs, ref_cluster),
        port_mapping.STRATEGIES[strategy](port_jobs, port_cluster))


@pytest.mark.parametrize("strategy", ref_mapping.ONE_SHOT_STRATEGIES)
def test_rack_oversub_mix_on_three_level_hierarchy(strategy):
    ref_cluster = _rack_cluster()
    port_cluster = convert.from_reference(ref_cluster)
    assert port_cluster.net_hierarchy().describe() \
        == ref_cluster.net_hierarchy().describe()
    _assert_same_placement(
        ref_mapping.STRATEGIES[strategy](ref_workloads.rack_oversub_mix(),
                                         ref_cluster),
        port_mapping.STRATEGIES[strategy](port_workloads.rack_oversub_mix(),
                                          port_cluster))


@pytest.mark.parametrize("strategy", ref_mapping.ONE_SHOT_STRATEGIES)
@pytest.mark.parametrize("seed", [0, 1])
def test_prefragmented_tracker_with_offline_cores(seed, strategy):
    rng = np.random.default_rng(seed)
    ref_cluster = ClusterTopology()
    used = rng.random(ref_cluster.n_cores) < 0.25
    ref_tracker = FreeCoreTracker(ref_cluster, occupied=used)
    dead_node = int(rng.integers(0, ref_cluster.n_nodes))
    lo = dead_node * ref_cluster.cores_per_node
    ref_tracker.set_offline(np.arange(lo, lo + ref_cluster.cores_per_node))
    port_tracker = convert.from_reference(ref_tracker)
    port_cluster = port_tracker.cluster
    ref_jobs = ref_workloads.synt_workload_3()[:4]
    port_jobs = convert.from_reference(ref_jobs)
    _assert_same_placement(
        ref_mapping.STRATEGIES[strategy](ref_jobs, ref_cluster, ref_tracker),
        port_mapping.STRATEGIES[strategy](port_jobs, port_cluster,
                                          port_tracker))
    np.testing.assert_array_equal(port_tracker.used, ref_tracker.used)
    np.testing.assert_array_equal(port_tracker.offline, ref_tracker.offline)


@pytest.mark.parametrize("count_scale", [0.05, 0.02])
@pytest.mark.parametrize("table", ["synt_workload_3", "real_workload_1",
                                   "rack_oversub_mix"])
def test_flat_messages_bit_equal(table, count_scale):
    for rj, pj in zip(getattr(ref_workloads, table)(),
                      getattr(port_workloads, table)()):
        rf, pf = rj.flat_messages(count_scale), pj.flat_messages(count_scale)
        for field in ("pair_src", "pair_dst", "pair_size", "pair_of", "emit",
                      "time_order"):
            a, b = getattr(rf, field), getattr(pf, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)


def test_converted_jobs_equal_generated_jobs():
    for rj, pj in zip(ref_workloads.synt_workload_3(),
                      port_workloads.synt_workload_3()):
        cj = convert.from_reference(rj)
        assert (cj.name, cj.job_id) == (pj.name, pj.job_id)
        for field in ("L", "lam", "cnt"):
            np.testing.assert_array_equal(getattr(cj, field),
                                          getattr(pj, field))
            assert getattr(cj, field) is not getattr(rj, field)
