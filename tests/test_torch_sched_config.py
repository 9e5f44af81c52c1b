"""The port's scheduler configuration, trace registry and free-core
tracker against the reference's, on the CPU.

``SchedulerConfig.from_legacy`` must build the reference's config, the
port's ``get_trace(name, **kw)`` the reference's trace from the same seed,
and the tracker must answer every interleaving of take / release /
snapshot / restore as the reference's does. Mirrors
``tests/test_sched_config.py`` and ``tests/test_tracker_properties.py``.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import repro.sched as ref_sched
from repro.core import ClusterTopology as RefClusterTopology
from repro.core import FreeCoreTracker as RefFreeCoreTracker
from repro.sched import traces as ref_traces
from repro_torch.ckpt import CheckpointCostModel
from repro_torch.core import ClusterTopology, FreeCoreTracker, convert
from repro_torch.sched import (TRACES, AutoscaleConfig, FleetScheduler,
                               RemapConfig, SchedulerConfig, get_trace,
                               trace_names)
from repro_torch.sched import traces
from repro_torch.sched.config import LEGACY_KWARGS
from repro_torch.serve import ModelSLO

torch.set_num_threads(1)

LEGACY = dict(remap_interval=5.0, util_threshold=0.5, migration_cost_factor=0.0,
              max_migrations_per_job=2, remap_candidates=3, remap_budget=64,
              remap_population=8, remap_rng_seed=3, admission_window=0.5,
              admission_k=12, admission_lookahead=4, admission_rng_seed=5,
              failure_policy="elastic", drain_policy="kill",
              elastic_model_size=2, cells=4, cross_cell_migration=False,
              state_bytes_per_proc=1e6, count_scale=0.1,
              sim_backend="segmented", reclock=False)


def test_from_legacy_builds_the_reference_config():
    assert LEGACY_KWARGS == ref_sched.config.LEGACY_KWARGS
    assert set(LEGACY) | {"ckpt_model"} == set(LEGACY_KWARGS)
    got = SchedulerConfig.from_legacy(ckpt_model=CheckpointCostModel(10.0), **LEGACY)
    want = ref_sched.SchedulerConfig.from_legacy(
        ckpt_model=ref_sched.config.CheckpointCostModel(10.0), **LEGACY)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(SchedulerConfig()) == \
        dataclasses.asdict(ref_sched.SchedulerConfig())
    assert not any(f.name == "device" for f in dataclasses.fields(SchedulerConfig))
    with pytest.raises(dataclasses.FrozenInstanceError):
        got.remap.interval = 1.0


def test_constructor_errors_match_reference():
    cluster = ClusterTopology(n_nodes=2)
    with pytest.raises(TypeError, match="not both"):
        FleetScheduler(cluster, "new", config=SchedulerConfig(),
                       remap_interval=5.0, device="cpu")
    with pytest.raises(TypeError, match="unknown FleetScheduler kwargs"):
        with pytest.warns(DeprecationWarning):
            FleetScheduler(cluster, "new", bogus_knob=1, device="cpu")
    with pytest.raises(ValueError, match="reclock"):
        FleetScheduler(cluster, "new", device="cpu", config=SchedulerConfig(
            reclock=False, autoscale=AutoscaleConfig(
                enabled=True, slos=(ModelSLO("m", 0.5, 100.0),))))
    with pytest.raises(ValueError, match="reclock"):
        FleetScheduler(ClusterTopology(n_nodes=4), "new", device="cpu",
                       config=SchedulerConfig.from_legacy(cells=2, reclock=False))


def test_legacy_kwargs_warn_and_build_the_same_scheduler():
    cluster = ClusterTopology(n_nodes=2)
    with pytest.warns(DeprecationWarning, match="flat FleetScheduler"):
        legacy = FleetScheduler(cluster, "new", device="cpu", remap_interval=5.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        composed = FleetScheduler(cluster, "new", device="cpu", config=SchedulerConfig(
            remap=RemapConfig(interval=5.0)))
    assert legacy.config == composed.config


# ---------------------------------------------------------------------------
# The trace registry
# ---------------------------------------------------------------------------
def test_registry_matches_reference():
    assert trace_names() == ref_sched.trace_names() == sorted(TRACES)
    with pytest.raises(TypeError):
        TRACES["rogue"] = lambda: None
    with pytest.raises(KeyError, match="unknown trace") as err:
        get_trace("no_such_trace")
    for name in trace_names():
        assert name in str(err.value)


def _same_graph(a, b):
    assert (a.name, a.job_id) == (b.name, b.job_id)
    for field in ("L", "lam", "cnt"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def _assert_same_spec(got, want):
    assert type(got).__name__ == type(want).__name__
    assert (got.name, got.count_scale, got.state_bytes_per_proc) == \
        (want.name, want.count_scale, want.state_bytes_per_proc)
    # fields by name, the hierarchy as its levels' fields
    assert convert._cluster_fields_of(got.cluster) == \
        convert._cluster_fields_of(want.cluster)
    assert [a.time for a in got.arrivals] == [a.time for a in want.arrivals]
    for a, b in zip(got.arrivals, want.arrivals):
        _same_graph(a.graph, b.graph)
    if hasattr(want, "stream"):
        for a, b in zip(got.replicas, want.replicas, strict=True):
            _same_graph(a, b)
        assert got.slos == convert.from_reference(want.slos)
        assert [(e.time, e.rates) for e in got.stream.epochs()] == \
            [(e.time, e.rates) for e in want.stream.epochs()]


@pytest.mark.parametrize("name,kw", [
    ("table2_poisson", {}), ("table3_poisson", {"seed": 3}),
    ("table4_poisson", {}), ("table5_poisson", {"n_arrivals": 6}),
    ("npb_poisson", {}), ("rack_oversub", {"seed": 2}),
    ("fleet64", {"n_arrivals": 16}), ("fleet1k", {"n_arrivals": 64}),
    ("serve_slo", {}), ("serve_slo", {"seed": 4, "horizon": 60.0}),
])
def test_get_trace_builds_the_reference_trace(name, kw):
    want = ref_sched.get_trace(name, **kw)
    got = get_trace(name, **kw)
    _assert_same_spec(got, want)
    _assert_same_spec(convert.from_reference(want), want)


def test_serve_fleet_waits_for_meshplan():
    """The serving-fleet trace on ``core.meshplan``'s fleet topology (the
    name dates from before the port held it): the port builds the
    reference's trace field for field, and its job mix the reference's
    graphs."""
    want = ref_sched.get_trace("serve_fleet")
    got = get_trace("serve_fleet")
    assert got.cluster.n_cores == 512 and got.cluster.pods == 2
    _assert_same_spec(got, want)
    _assert_same_spec(convert.from_reference(want), want)
    for a, b in zip(traces.serve_fleet_mix(), ref_traces.serve_fleet_mix(),
                    strict=True):
        _same_graph(a, b)


# ---------------------------------------------------------------------------
# The free-core tracker under arbitrary interleavings
# ---------------------------------------------------------------------------
def _outcome(fn, *args):
    try:
        out = fn(*args)
    except (RuntimeError, ValueError) as e:
        return ("raises", isinstance(e, RuntimeError), str(e))
    return ("ok", None if out is None else int(out))


@pytest.mark.parametrize("seed", range(6))
def test_tracker_interleavings_match_reference(seed):
    """``test_tracker_properties``' random walk of take_core / take_cores /
    release / snapshot / restore / offline, applied to both trackers: the
    same answers and errors, the same masks after every operation."""
    rng = np.random.default_rng(seed)
    ref_cluster = RefClusterTopology(n_nodes=int(rng.integers(2, 6)),
                                     sockets_per_node=int(rng.integers(1, 4)),
                                     cores_per_socket=int(rng.integers(1, 5)))
    ref, port = RefFreeCoreTracker(ref_cluster), \
        FreeCoreTracker(convert.from_reference(ref_cluster))
    n = ref_cluster.n_cores
    snaps = []
    for _ in range(120):
        op = int(rng.integers(0, 6))
        if op == 0:
            node = int(rng.integers(0, ref_cluster.n_nodes))
            socket = None if rng.random() < 0.5 else \
                int(rng.integers(0, ref_cluster.sockets_per_node))
            assert _outcome(port.take_core, node, socket) == \
                _outcome(ref.take_core, node, socket)
        elif op in (1, 2):
            cores = rng.choice(n, size=int(rng.integers(1, min(n, 5) + 1)),
                               replace=False)
            fn = "take_cores" if op == 1 else "release_cores"
            assert _outcome(getattr(port, fn), cores) == \
                _outcome(getattr(ref, fn), cores)
        elif op == 3:
            snaps.append((port.snapshot(), ref.snapshot()))
        elif op == 4 and snaps:
            a, b = snaps[int(rng.integers(0, len(snaps)))]
            port.restore(a)
            ref.restore(b)
        elif op == 5:
            node = int(rng.integers(0, ref_cluster.n_nodes))
            cores = np.arange(node * ref_cluster.cores_per_node,
                              (node + 1) * ref_cluster.cores_per_node)
            fn = "set_offline" if rng.random() < 0.5 else "set_online"
            getattr(port, fn)(cores)
            getattr(ref, fn)(cores)
        np.testing.assert_array_equal(port.used, ref.used)
        np.testing.assert_array_equal(port.offline, ref.offline)
        # conservation: a core is free, used or offline (used may be offline)
        assert port.total_free() == n - int((port.used | port.offline).sum())
        assert port.total_free() == ref.total_free()
        np.testing.assert_array_equal(port.free_per_node(), ref.free_per_node())
    with pytest.raises(ValueError):
        port.restore(np.zeros(n + 1, dtype=bool))
