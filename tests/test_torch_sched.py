"""The port's fleet scheduler against the reference's, run live on the CPU.

Both packages run the same seeded trace on the host ``segmented`` backend
(the port with ``device="cpu"``), and must agree exactly: every handled
event, every placement change (admission order, every core of every
job), every remap verdict, every ``FleetStats`` field and the flight
recorder's dump byte for byte. Mirrors ``tests/test_sched.py`` and the
device contract of ``FleetScheduler``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import ClusterTopology as RefClusterTopology
from repro.core.graphs import PATTERNS
from repro.core.graphs import AppGraph as RefAppGraph
from repro.core.workloads import Arrival as RefArrival
from repro.sched import FleetScheduler as RefFleetScheduler
from repro.sched import SchedulerConfig as RefSchedulerConfig
from repro.sched import TraceSpec as RefTraceSpec
from repro.sched import get_trace as ref_get_trace
from repro.sched import resolve_strategy as ref_resolve_strategy
from repro_torch.core import ClusterTopology, convert
from repro_torch.core.mapping import ONE_SHOT_STRATEGIES
from repro_torch.sched import FleetScheduler, SchedulerConfig, resolve_strategy
from torch_port_util import MB, assert_same_run, run_pair

torch.set_num_threads(1)

KB = 1 << 10
SEGMENTED = {"sim_backend": "segmented"}


def _job(job_id, pattern="all_to_all", procs=8, length=64 * KB, rate=10.0,
         count=50):
    return RefAppGraph.from_pattern(f"j{job_id}_{pattern}", pattern, procs,
                                    length, rate, count, job_id=job_id)


def _spec(arrivals, cluster, count_scale=0.02, state=64 * MB):
    return RefTraceSpec(name="custom", cluster=cluster,
                        arrivals=[RefArrival(t, g) for g, t in arrivals],
                        count_scale=count_scale, state_bytes_per_proc=state)


@pytest.mark.parametrize("strategy", ONE_SHOT_STRATEGIES)
def test_table4_run_matches_reference(strategy):
    """The paper's trace (16 arrivals on 16 x 16) with periodic remaps."""
    ref, port = run_pair(ref_get_trace("table4_poisson"), strategy,
                         dict(SEGMENTED, remap_interval=5.0))
    assert ref.stats.n_jobs == 16 and ref.events
    assert_same_run(port, ref)


def test_search_strategy_run_matches_reference():
    """``search:new`` places each arrival with the batched search, scored by
    ``simulate_batch`` on the scheduler's device."""
    ref, port = run_pair(ref_get_trace("table4_poisson", n_arrivals=4),
                         "search:new", SEGMENTED)
    assert_same_run(port, ref)


@pytest.mark.parametrize("strategy", list(ONE_SHOT_STRATEGIES) + ["search:new"])
def test_random_admit_depart_matches_reference(strategy):
    """60 random low-level admits / departs (``test_sched``'s accounting
    walk): the same cores every time, invariants after every step."""
    ref_cluster = RefClusterTopology(n_nodes=4)
    ref = RefFleetScheduler(ref_cluster, strategy,
                            config=RefSchedulerConfig(sim_backend="segmented"))
    port = FleetScheduler(convert.from_reference(ref_cluster), strategy,
                          config=SchedulerConfig(sim_backend="segmented"),
                          device="cpu")
    rng = np.random.default_rng(7)
    next_id = 0
    for _ in range(60):
        if ref.live and (ref.tracker.total_free() < 16 or rng.random() < 0.4):
            victim = int(rng.choice(sorted(ref.live)))
            ref.depart(victim)
            port.depart(victim)
        else:
            g = _job(next_id, PATTERNS[int(rng.integers(0, len(PATTERNS)))],
                     int(rng.integers(2, 17)))
            a = ref.admit(g)
            b = port.admit(convert.from_reference(g))
            np.testing.assert_array_equal(b.cores, a.cores)
            next_id += 1
        port.check_invariants()
        np.testing.assert_array_equal(port.tracker.used, ref.tracker.used)
    assert sorted(port.live) == sorted(ref.live)


def test_admit_raises_when_job_cannot_fit():
    port = FleetScheduler(ClusterTopology(n_nodes=2), "new", device="cpu")
    port.admit(convert.from_reference(_job(0, procs=30)))
    with pytest.raises(RuntimeError, match="does not fit"):
        port.admit(convert.from_reference(_job(1, procs=8)))


def test_oversubscribed_arrivals_queue_fifo_as_reference():
    spec = _spec([(_job(k, "linear", 24, count=20), at)
                  for k, at in enumerate((0.0, 0.1, 0.2))],
                 RefClusterTopology(n_nodes=2), count_scale=0.1)
    ref, port = run_pair(spec, "blocked", SEGMENTED)
    assert ref.stats.total_queue_wait > 0.0
    assert_same_run(port, ref)


@pytest.mark.parametrize("state,cost", [(64 * MB, 1.0), (1e15, 1.0),
                                        (64 * MB, 1e9)],
                         ids=["cheap", "state_too_big", "cost_too_high"])
def test_remap_verdicts_match_reference(state, cost):
    """Remap commits when migration is cheap and is vetoed when it is not
    (``test_sched``'s remap cases): the same verdicts, the same moves."""
    spec = dataclasses.replace(ref_get_trace("table4_poisson", n_arrivals=12),
                               state_bytes_per_proc=state)
    ref, port = run_pair(spec, "new", dict(SEGMENTED, remap_interval=5.0,
                                           migration_cost_factor=cost))
    assert ref.sched.decisions
    assert_same_run(port, ref)


def test_resolve_strategy_lists_the_reference_registry():
    """An unknown name lists the same strategies as the reference; the
    fleet strategies of ``core.meshplan`` resolve in both packages and a
    scheduler builds on them."""
    with pytest.raises(KeyError) as want:
        ref_resolve_strategy("omnet_magic")
    with pytest.raises(KeyError) as got:
        resolve_strategy("omnet_magic")
    known = str(want.value).split("known: ")[1]
    assert known in str(got.value)
    for name in ("new_tpu", "search:new_tpu"):
        assert callable(ref_resolve_strategy(name))
        assert callable(resolve_strategy(name, device="cpu"))
        sched = FleetScheduler(ClusterTopology(n_nodes=2), name, device="cpu")
        assert sched.strategy_name == name


def test_device_none_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=None means the CUDA card"):
        FleetScheduler(ClusterTopology(n_nodes=2), "new")


def test_device_none_is_the_card_and_the_kernel(monkeypatch):
    """``device=None`` resolves to the CUDA card and ``auto`` to the kernel
    backend there; a named backend stays; ``"cpu"`` is the host scan.
    Every simulation handle of the scheduler (the facade's, each cell's,
    the autoscaler's) carries that device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cluster = convert.from_reference(ref_get_trace("fleet64").cluster)
    sched = FleetScheduler(cluster, "new", config=SchedulerConfig(
        cells=dataclasses.replace(SchedulerConfig().cells, cells="pod/rack")))
    assert sched.device == torch.device("cuda") and sched.sim_backend == "kernel"
    handles = [sched._sim, sched.autoscale._solo_sim] + [c.sim for c in sched.cells]
    assert {(h.device.type, h.backend) for h in handles} == {("cuda", "kernel")}
    twin = FleetScheduler(cluster, "new",
                          config=SchedulerConfig(sim_backend="torch"))
    assert twin.sim_backend == "torch"
    host = FleetScheduler(cluster, "new", device="cpu")
    assert (host.device.type, host.sim_backend) == ("cpu", "segmented")


def test_a_strategy_fault_is_not_taken_for_a_full_cluster():
    """The engines skip a trial placement only when it does not fit
    (``ClusterFull``); a strategy that fails otherwise — a search
    strategy whose kernel does not launch — stops the scheduler instead of
    being read as "no room"."""
    from repro_torch.core.mapping import new_mapping

    state = {"fault": False}

    def strategy(graphs, cluster, tracker=None):
        if state["fault"]:
            raise RuntimeError("kernel launch failed")
        return new_mapping(graphs, cluster, tracker)

    spec = convert.from_reference(ref_get_trace("table4_poisson", n_arrivals=6))
    sched = FleetScheduler(spec.cluster, strategy, device="cpu",
                           config=SchedulerConfig.from_legacy(
                               count_scale=spec.count_scale, remap_interval=1.0,
                               util_threshold=0.0))
    for a in spec.arrivals:
        sched.admit(a.graph)
    sched.clock.reclock_fleet()
    state["fault"] = True
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        sched.remap.run_pass()
