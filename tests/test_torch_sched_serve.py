"""The port's serving fleet against the reference's, run live on the CPU.

The autoscale closed loop on the ``serve_slo`` trace (resident replicas,
a bursty request stream, per-model SLOs) in both packages on the host
``segmented`` backend: identical decisions, equal ``FleetStats`` and
byte-identical flight-recorder dumps. Also the pure-math fleet layer
(``serve.fleet``) and the collective-traffic graphs (``core.commgraph``)
the trace is built from. Mirrors ``tests/test_serve_slo.py`` and the
commgraph cases of ``tests/test_commgraph_meshplan.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.core import commgraph as ref_commgraph
from repro.sched import get_trace as ref_get_trace
from repro.serve import fleet as ref_fleet
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import commgraph
from repro_torch.core import convert
from repro_torch.serve import fleet
from torch_port_util import assert_same_run, run_pair

torch.set_num_threads(1)

SEGMENTED = {"sim_backend": "segmented"}


@pytest.mark.parametrize("horizon,autoscale,cost", [
    (240.0, dict(actions=True, routing="capacity", max_replicas=5), 1.0),
    (120.0, dict(actions=False, routing="uniform"), 1.0),
    (120.0, dict(actions=True, routing="capacity", max_replicas=5), 1e9),
], ids=["closed_loop_240s", "static_uniform", "prohibitive_cost"])
def test_serve_slo_matches_reference(horizon, autoscale, cost):
    """``serve_slo`` with the autoscaler on (``test_serve_slo``'s legs: the
    closed loop at the trace's registered 240 s horizon, the static fleet,
    and a migration price that vetoes every scale-up)."""
    spec = ref_get_trace("serve_slo", seed=0, horizon=horizon, epoch_dt=4.0)
    ref, port = run_pair(spec, "new", dict(SEGMENTED, migration_cost_factor=cost),
                         autoscale=dict(autoscale, lookahead_s=30.0))
    assert ref.stats.slo_violation_s > 0.0
    if autoscale["actions"]:
        assert ref.sched.autoscale.decisions
    assert_same_run(port, ref)


def test_request_stream_matches_reference():
    kw = dict(base_rates={"a": 40.0, "b": 20.0}, horizon=62.0, epoch_dt=4.0,
              diurnal_period=60.0, diurnal_amp=0.3)
    for poisson in (True, False):
        for seed in (7, 8):
            want = ref_fleet.RequestStream(
                spikes=(ref_fleet.TrafficSpike("a", 20.0, 10.0, 3.0),),
                poisson=poisson, seed=seed, **kw)
            got = convert.from_reference(want)
            assert isinstance(got, fleet.RequestStream)
            assert [(e.time, e.rates) for e in got.epochs()] == \
                [(e.time, e.rates) for e in want.epochs()]
            for t in (0.0, 15.0, 25.0, 45.0, 61.0):
                assert got.expected_rate("a", t) == want.expected_rate("a", t)
    with pytest.raises(ValueError):
        fleet.RequestStream({"a": 1.0}, horizon=0.0, epoch_dt=1.0)


def test_latency_model_and_routing_match_reference():
    for args in ((50.0, 100.0, 1.0), (40.0, 100.0, 2.0), (100.0, 100.0, 1.0),
                 (60.0, 100.0, 2.0), (50.0, 100.0, 0.5), (0.0, 10.0, 3.0)):
        assert fleet.replica_p99(*args) == ref_fleet.replica_p99(*args)
    for jids, caps, mode in (([1, 2], {1: 100.0, 2: 50.0}, "uniform"),
                             ([1, 2], {1: 100.0, 2: 50.0}, "capacity"),
                             ([1, 2], {}, "capacity"), ([], {}, "capacity")):
        assert fleet.route_weights(jids, caps, mode=mode) == \
            ref_fleet.route_weights(jids, caps, mode=mode)
    with pytest.raises(ValueError, match="unknown routing mode"):
        fleet.route_weights([1], {1: 1.0}, mode="bogus")
    slos = {m: ref_fleet.ModelSLO(m, 0.5, 100.0) for m in "ab"}
    cases = [({"a": [], "b": []}, {}, {"a": 10.0, "b": 0.0}, {}),
             ({"a": [1, 2], "b": []}, {"a": {1: 0.5, 2: 0.5}}, {"a": 80.0},
              {1: 1.0, 2: 2.0})]
    for replicas, weights, rates, slowdowns in cases:
        want = ref_fleet.fleet_p99s(slos, replicas, weights, rates, slowdowns)
        got = fleet.fleet_p99s({m: convert.from_reference(s) for m, s in slos.items()},
                               replicas, weights, rates, slowdowns)
        assert got == want


def test_accountant_matches_reference():
    obs = [(0.0, 4.0, {"a": 1.0, "b": 0.1}), (4.0, 8.0, {"a": 1.0, "b": 2.0}),
           (8.0, 12.0, {"a": 0.2, "b": 0.1}), (12.0, 13.0, {})]
    ref, port = ref_fleet.SLOAccountant({"a": 0.5, "b": 0.5}), \
        fleet.SLOAccountant({"a": 0.5, "b": 0.5})
    for args in obs:
        assert port.observe(*args) == ref.observe(*args)
    assert port.close(13.0) == ref.close(13.0)
    assert port.close(13.0) == ref.close(13.0) == []
    assert (port.violation_s, port.total_violation_s) == \
        (ref.violation_s, ref.total_violation_s)


def test_clone_replica_matches_reference():
    t = ref_commgraph.appgraph_for(ref_get_config("qwen3-0.6b"),
                                   REF_SHAPES["decode_32k"],
                                   {"data": 4, "model": 4}, job_id=0)
    want = ref_fleet.clone_replica(ref_fleet.clone_replica(t, 7), 9)
    got = fleet.clone_replica(fleet.clone_replica(convert.from_reference(t), 7), 9)
    assert (got.name, got.job_id) == (want.name, want.job_id) == (f"{t.name}@9", 9)
    assert fleet.model_key(got.name) == ref_fleet.model_key(want.name) == t.name
    for field in ("L", "lam", "cnt"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


# ---------------------------------------------------------------------------
# core.commgraph
# ---------------------------------------------------------------------------
def _assert_same_graph(got, want):
    assert (got.name, got.job_id, got.n_procs) == (want.name, want.job_id, want.n_procs)
    for field in ("L", "lam", "cnt"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


@pytest.mark.parametrize("kind,axis,axes", [
    ("all_reduce", "model", {"data": 1, "model": 8}),
    ("all_to_all", "model", {"model": 4}),
    ("all_reduce", "data", {"pod": 2, "data": 2, "model": 2}),
    ("all_gather", "data", {"data": 4, "model": 2}),
    ("reduce_scatter", "model", {"data": 2, "model": 4}),
])
def test_traffic_appgraph_matches_reference(kind, axis, axes):
    want_c = ref_commgraph.Collective(kind, axis, 1000.0, 3)
    got_c = commgraph.Collective(kind, axis, 1000.0, 3)
    _assert_same_graph(commgraph.traffic_appgraph("t", [got_c], axes),
                       ref_commgraph.traffic_appgraph("t", [want_c], axes))
    assert commgraph.total_collective_bytes([got_c], axes) == \
        ref_commgraph.total_collective_bytes([want_c], axes)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "yi-6b", "qwen2-moe-a2.7b",
                                  "granite-3-2b", "qwen3-0.6b", "mamba2-370m"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k", "prefill_32k"])
def test_job_collectives_and_appgraph_match_reference(arch, shape):
    want = ref_commgraph.job_collectives(ref_get_config(arch), REF_SHAPES[shape],
                                         dp=16, tp=16)
    got = commgraph.job_collectives(get_config(arch), SHAPES[shape], dp=16, tp=16)
    assert [dataclasses.astuple(c) for c in got] == \
        [dataclasses.astuple(c) for c in want]
    axes = {"data": 4, "model": 4}
    _assert_same_graph(
        commgraph.appgraph_for(get_config(arch), SHAPES[shape], axes, job_id=3,
                               steps_per_sec=4.0),
        ref_commgraph.appgraph_for(ref_get_config(arch), REF_SHAPES[shape], axes,
                                   job_id=3, steps_per_sec=4.0))
