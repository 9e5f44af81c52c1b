"""The port's re-clocking engine against the reference's, run live on the CPU.

The honest clock (every arrival, departure and remap commit re-keys the
live jobs' departures) and the stale baseline (``reclock=False``), on
saturating traces, in both packages on the host ``segmented`` backend:
identical decisions, equal ``FleetStats`` and byte-identical
flight-recorder dumps. Mirrors ``tests/test_reclock.py``.
"""
import numpy as np
import pytest
import torch

from repro.core.graphs import PATTERNS, AppGraph, ClusterTopology
from repro.core.workloads import Arrival
from repro.sched import TraceSpec
from repro.sched import get_trace as ref_get_trace
from repro_torch.core import convert
from repro_torch.sched import DEPARTURE, REMAP, Event, FleetScheduler, SchedulerConfig
from torch_port_util import MB, assert_same_run, run_pair

torch.set_num_threads(1)

# heavy enough to saturate the shared NIC servers (``test_reclock``'s scale)
COUNT_SCALE = 0.2


def _heavy(jid, count, procs=16):
    return AppGraph.from_pattern(f"j{jid}", "all_to_all", procs, 1 * MB,
                                 50.0, count, job_id=jid)


def _spec(jobs_at, count_scale=COUNT_SCALE, state=64 * MB):
    return TraceSpec(name="custom", cluster=ClusterTopology(n_nodes=2),
                     arrivals=[Arrival(at, g) for g, at in jobs_at],
                     count_scale=count_scale, state_bytes_per_proc=state)


CHURN = {
    "arrival_lengthens": [(_heavy(0, 200), 0.0), (_heavy(1, 200), 0.5)],
    "departure_shortens": [(_heavy(0, 40), 0.0), (_heavy(1, 400), 0.1)],
    "no_churn": [(_heavy(0, 200), 0.0)],
    "zero_traffic": [(AppGraph(name="silent", L=np.zeros((8, 8)),
                               lam=np.zeros((8, 8)),
                               cnt=np.zeros((8, 8), dtype=np.int64), job_id=0), 0.0),
                     (_heavy(1, 60), 0.5)],
}


@pytest.mark.parametrize("reclock", [False, True])
@pytest.mark.parametrize("case", sorted(CHURN))
def test_churn_matches_reference(case, reclock):
    ref, port = run_pair(_spec(CHURN[case]), "cyclic",
                         dict(sim_backend="segmented", reclock=reclock))
    assert_same_run(port, ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_traces_with_remaps_match_reference(seed):
    """``test_reclock``'s property traces: queueing, remap ticks every
    second at a low threshold and cheap migrations."""
    rng = np.random.default_rng(seed)
    jobs_at, t = [], 0.0
    for jid in range(10):
        pattern = PATTERNS[int(rng.integers(0, len(PATTERNS)))]
        jobs_at.append((AppGraph.from_pattern(
            f"j{jid}", pattern, int(rng.integers(4, 25)), 1 * MB, 50.0,
            int(rng.integers(20, 120)), job_id=jid), t))
        t += float(rng.exponential(0.5))
    ref, port = run_pair(_spec(jobs_at, count_scale=0.1, state=1 * MB), "cyclic",
                         dict(sim_backend="segmented", remap_interval=1.0,
                              util_threshold=0.5))
    assert len(ref.sched.done) == 10
    assert_same_run(port, ref)


@pytest.mark.parametrize("reclock", [False, True])
def test_table4_remap_commits_match_reference(reclock):
    ref, port = run_pair(ref_get_trace("table4_poisson", n_arrivals=12), "new",
                         dict(sim_backend="segmented", remap_interval=5.0,
                              reclock=reclock))
    assert ref.stats.n_remap_commits >= 1
    assert_same_run(port, ref)


def test_stale_epoch_departure_event_is_ignored():
    sched = FleetScheduler(convert.from_reference(ClusterTopology(n_nodes=2)),
                           "cyclic", device="cpu",
                           config=SchedulerConfig(count_scale=COUNT_SCALE))
    sched.submit(convert.from_reference(_heavy(0, 200)), at=0.0)
    assert sched.step().kind == "arrival"
    job = sched.jobs[0]
    sched.events.push(Event(time=sched.now, kind=DEPARTURE, job_id=0,
                            epoch=job.epoch - 1))
    sched.step()
    assert 0 in sched.live, "a stale-epoch event must not depart the job"
    sched.run()
    sched.check_invariants()
    assert 0 in sched.done and not sched.live


def test_fifo_drain_placement_schedules_remap_tick():
    sched = FleetScheduler(convert.from_reference(ClusterTopology(n_nodes=2)),
                           "cyclic", device="cpu",
                           config=SchedulerConfig(count_scale=COUNT_SCALE))
    sched.submit(convert.from_reference(_heavy(0, 120, procs=24)), at=0.0)
    sched.submit(convert.from_reference(_heavy(1, 120, procs=24)), at=0.1)
    sched.step()
    sched.step()
    assert list(sched.pending) == [1] and sched.events.count(REMAP) == 0
    sched.remap_interval = 5.0
    while sched.pending:
        assert sched.step() is not None
    assert sched.events.count(REMAP) == 1
    sched.run()
    sched.check_invariants()
