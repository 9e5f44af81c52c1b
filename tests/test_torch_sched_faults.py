"""The port's failure handling against the reference's, run live on the CPU.

Node failures, recoveries and maintenance drains under each recovery
policy, with the restart cost and fault models of ``ckpt``: both packages
on the host ``segmented`` backend must decide identically and record
byte-identical flight-recorder dumps. Mirrors ``tests/test_faults.py``
and the cost / fault model cases of ``tests/test_ckpt.py``.
"""
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointCostModel as RefCheckpointCostModel
from repro.ckpt import ElasticReMesher as RefElasticReMesher
from repro.ckpt import HeartbeatMonitor as RefHeartbeatMonitor
from repro.ckpt import StragglerTracker as RefStragglerTracker
from repro.core import ClusterTopology as RefClusterTopology
from repro.core.graphs import AppGraph as RefAppGraph
from repro.core.workloads import Arrival as RefArrival
from repro.sched import DRAIN, NODE_FAIL, NODE_RECOVER, NodeEvent, TraceSpec
from repro.sched import fault_trace as ref_fault_trace
from repro.sched import get_trace as ref_get_trace
from repro.sched import reference_fault_trace as ref_reference_fault_trace
from repro_torch.ckpt import (CheckpointCostModel, ElasticReMesher,
                              HeartbeatMonitor, ReMeshResult, StragglerTracker)
from repro_torch.core import convert
from repro_torch.sched import fault_trace, reference_fault_trace
from repro_torch.sched.admission import AdmissionController
from torch_port_util import MB, assert_same_run, run_pair

torch.set_num_threads(1)

KB = 1 << 10
SEGMENTED = {"sim_backend": "segmented"}
#: ``benchmarks/fault_bench.py``'s recovery policies
POLICIES = [("requeue", "kill"), ("elastic", "kill"), ("requeue", "proactive")]


def _fault_run(failure_policy, drain_policy, **flat):
    spec = ref_get_trace("table4_poisson")
    return run_pair(spec, "new",
                    dict(SEGMENTED, failure_policy=failure_policy,
                         drain_policy=drain_policy, **flat),
                    faults=ref_reference_fault_trace(spec.cluster))


@pytest.mark.parametrize("failure_policy,drain_policy", POLICIES)
def test_reference_fault_trace_matches_reference(failure_policy, drain_policy):
    ref, port = _fault_run(failure_policy, drain_policy)
    assert ref.stats.n_node_failures > 0 and ref.stats.n_drains > 0
    assert_same_run(port, ref)


def test_joint_admission_with_offline_cores_matches_reference(monkeypatch):
    """Admission ``window > 0`` under the reference fault trace: joint
    batches are placed while nodes are dead or draining, so the offline
    cores reach ``search.joint``. The port drops exactly the candidates
    the reference drops."""
    offline_at_batch = []
    place = AdmissionController.place_batch_jointly

    def spy(self, cell, jobs):
        offline_at_batch.append(bool(self.f.tracker.offline.any()))
        return place(self, cell, jobs)

    monkeypatch.setattr(AdmissionController, "place_batch_jointly", spy)
    ref, port = _fault_run("elastic", "proactive", admission_window=0.5)
    assert ref.stats.n_joint_batches > 0 and any(offline_at_batch)
    assert_same_run(port, ref)


@pytest.mark.parametrize("seed", [1, 5, 11])
def test_seeded_fault_storm_matches_reference(seed):
    """``test_faults``' property storm: per-node failures, rack blasts and
    drains from one seed, under both failure policies."""
    spec = ref_get_trace("table4_poisson", seed=seed)
    faults = ref_fault_trace(spec.cluster, horizon=50.0, node_mtbf=60.0,
                             node_mttr=8.0, rack_mtbf=90.0, n_drains=2,
                             drain_grace=5.0, maintenance_s=10.0, seed=seed)
    for failure_policy in ("requeue", "elastic"):
        ref, port = run_pair(spec, "new", dict(
            SEGMENTED, failure_policy=failure_policy,
            drain_policy="proactive"), faults=faults)
        assert_same_run(port, ref)


@pytest.mark.parametrize("seed", [1, 1234])
def test_fault_trace_is_the_reference_stream(seed):
    cluster = RefClusterTopology()
    kw = dict(horizon=80.0, node_mtbf=60.0, node_mttr=8.0, rack_mtbf=40.0,
              n_drains=3, seed=seed)
    want = ref_fault_trace(cluster, **kw)
    got = fault_trace(convert.from_reference(cluster), **kw)
    assert got == convert.from_reference(want)
    assert [(e.time, e.kind, e.node, e.deadline) for e in got] == \
        [(e.time, e.kind, e.node, e.deadline) for e in want]
    assert reference_fault_trace(convert.from_reference(cluster)) == \
        convert.from_reference(ref_reference_fault_trace(cluster))


def _small(faults):
    job = RefAppGraph.from_pattern("j0", "all_to_all", 32, 64 * KB, 10.0,
                                   3000, job_id=0)
    return TraceSpec(name="small", cluster=RefClusterTopology(n_nodes=2),
                     arrivals=[RefArrival(0.0, job)], count_scale=0.02,
                     state_bytes_per_proc=1 * MB)


@pytest.mark.parametrize("faults", [
    [NodeEvent(1.0, DRAIN, 0, 2.0), NodeEvent(3.0, NODE_RECOVER, 0)],
    [NodeEvent(1.0, DRAIN, 0, 2.0), NodeEvent(1.5, NODE_RECOVER, 0)],
    [NodeEvent(0.0, NODE_FAIL, 0), NodeEvent(0.1, NODE_FAIL, 0),
     NodeEvent(0.2, NODE_RECOVER, 0), NodeEvent(0.3, NODE_RECOVER, 0)],
], ids=["drain_deadline_kills", "recover_cancels_drain", "idempotent_fail"])
def test_drain_and_failure_cases_match_reference(faults):
    ref, port = run_pair(_small(faults), "new",
                         dict(SEGMENTED, failure_policy="requeue",
                              drain_policy="kill"), faults=faults)
    assert_same_run(port, ref)


# ---------------------------------------------------------------------------
# ckpt: the restart cost model and the fault models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("interval", [30.0, 0.0, -1.0])
def test_checkpoint_cost_model_matches_reference(interval):
    ref, port = RefCheckpointCostModel(interval), CheckpointCostModel(interval)
    for progress in (-5.0, 0.0, 29.9, 30.0, 65.0, 1e6 + 0.25):
        assert port.last_checkpoint(progress) == ref.last_checkpoint(progress)
        assert port.lost_work(progress) == ref.lost_work(progress)
    for nbytes, bw in ((2e9, 1e9), (2e9, 0.0), (2e9, -1.0), (64 * MB, 3e9)):
        assert port.restore_seconds(nbytes, bw) == ref.restore_seconds(nbytes, bw)


@pytest.mark.parametrize("model_size,hosts", [
    (8, [0, 1, 2, 4, 5, 6, 7]), (4, [0, 1]), (4, []), (8, [0, 2])])
def test_elastic_remesher_matches_reference(model_size, hosts):
    for planner in (None, lambda chips: chips[::-1]):
        want = RefElasticReMesher(model_size, 8, planner).replan(hosts)
        got = ElasticReMesher(model_size, 8, planner).replan(hosts)
        assert isinstance(got, ReMeshResult)
        assert (got.data_size, got.model_size, got.dropped_chips) == \
            (want.data_size, want.model_size, want.dropped_chips)
        np.testing.assert_array_equal(got.device_order, want.device_order)
    with pytest.raises(ValueError, match="permutation"):
        ElasticReMesher(8, 8, lambda chips: np.arange(chips.size)).replan([1, 2])


def test_heartbeat_and_straggler_match_reference():
    class Clock:
        t = 7.5

        def __call__(self):
            return self.t

    clocks = Clock(), Clock()
    ref = RefHeartbeatMonitor(3, deadline_s=10.0, clock=clocks[0])
    port = HeartbeatMonitor(3, deadline_s=10.0, clock=clocks[1])
    script = [("beat", 0, 12.0), ("sweep", None, 20.0), ("mark_dead", 1, 20.5),
              ("beat", 1, 21.0), ("revive", 1, 22.0), ("sweep", None, 40.0)]
    for op, host, t in script:
        for clock in clocks:
            clock.t = t
        args = () if host is None else (host,)
        assert getattr(port, op)(*args) == getattr(ref, op)(*args)
        np.testing.assert_array_equal(port.alive, ref.alive)
        np.testing.assert_array_equal(port.last_seen, ref.last_seen)
        assert port.alive_hosts() == ref.alive_hosts()
    ref_st, port_st = RefStragglerTracker(2.0, 0.9), StragglerTracker(2.0, 0.9)
    for step, dt in enumerate((1.0, 1.0, 10.0, 1.1, 0.9, 5.0)):
        assert port_st.record(step, dt) == ref_st.record(step, dt)
    assert (port_st.ewma, port_st.flagged_steps) == (ref_st.ewma, ref_st.flagged_steps)
