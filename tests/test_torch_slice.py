"""The ported slice as a whole, at small size, against the reference.

Table 4 at ``count_scale=0.02`` (86.8 k messages) goes through mapping →
``simulate`` → ``simulate_batch`` → ``search_placement`` in both packages
with a flight recorder installed in each: equal placements, ``SimResult``s
at 1e-9, equal search trajectories and byte-identical recorder dumps.
"""
import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.core import ClusterTopology
from repro.core import mapping as ref_mapping
from repro.core import simulate as ref_simulate
from repro.core import simulate_batch as ref_simulate_batch
from repro.core import workloads as ref_workloads
from repro.search import search_placement as ref_search_placement
from repro_torch import obs as port_obs
from repro_torch.core import ClusterTopology as PortClusterTopology
from repro_torch.core import mapping as port_mapping
from repro_torch.core import simulate, simulate_batch
from repro_torch.core import workloads as port_workloads
from repro_torch.core.sim_scan import _FLAT_CACHE
from repro_torch.search import search_placement
from torch_port_util import assert_results_close, permuted_trials

torch.set_num_threads(1)

SCALE = 0.02
K = 8


def _drive(jobs, cluster, strategies, simulate_fn, batch_fn, search_fn,
           recording, **device):
    """One pass over the slice with the given package's entry points."""
    out = {"placements": {}, "results": {}}
    with recording() as rec:
        for name in strategies.ONE_SHOT_STRATEGIES:
            pl = strategies.STRATEGIES[name](jobs, cluster)
            out["placements"][name] = pl
            out["results"][name] = simulate_fn(jobs, pl, cluster, SCALE,
                                               backend="segmented", **device)
        trials = permuted_trials(np.random.default_rng(0), jobs,
                                 out["placements"]["new"], K)
        out["trials"] = trials
        out["batch"] = batch_fn(jobs, trials, cluster, SCALE,
                                backend="segmented", **device)
        out["search"] = search_fn(jobs, cluster, seed="new", budget=48,
                                  rng_seed=0, backend="segmented", **device)
        out["dump"] = rec.dump_json()
    return out


@pytest.fixture(scope="module")
def both():
    ref = _drive(ref_workloads.synt_workload_3(), ClusterTopology(),
                 ref_mapping, ref_simulate, ref_simulate_batch,
                 ref_search_placement, ref_obs.recording)
    port = _drive(port_workloads.synt_workload_3(), PortClusterTopology(),
                  port_mapping, simulate, simulate_batch, search_placement,
                  port_obs.recording, device="cpu")
    return ref, port


def test_message_count(both):
    ref, port = both
    assert port["results"]["new"].n_messages == 86_800
    assert ref["results"]["new"].n_messages == 86_800


@pytest.mark.parametrize("name", ref_mapping.ONE_SHOT_STRATEGIES)
def test_one_shot_strategy_placed_and_simulated(both, name):
    ref, port = both
    for jid, cores in ref["placements"][name].assignments.items():
        np.testing.assert_array_equal(
            port["placements"][name].assignments[jid], cores)
    assert_results_close(port["results"][name], ref["results"][name], 1e-9,
                         name)


def test_new_mapping_beats_blocked(both):
    _, port = both
    assert port["results"]["new"].total_wait \
        < port["results"]["blocked"].total_wait


def test_batch_of_trial_placements(both):
    ref, port = both
    assert len(port["batch"]) == K
    for i in range(K):
        for jid, cores in ref["trials"][i].assignments.items():
            np.testing.assert_array_equal(
                port["trials"][i].assignments[jid], cores)
        assert_results_close(port["batch"][i], ref["batch"][i], 1e-9,
                             f"trial {i}")


def test_search_trajectory(both):
    ref, port = both
    r, p = ref["search"], port["search"]
    assert p.trajectory == r.trajectory
    assert (p.objective, p.seed_objective) == (r.objective, r.seed_objective)
    assert p.evaluations == r.evaluations <= 48
    for jid, cores in r.placement.assignments.items():
        np.testing.assert_array_equal(p.placement.assignments[jid], cores)


def test_recorder_dumps_byte_identical(both):
    ref, port = both
    assert port["dump"] == ref["dump"]
    assert '"sim.calls.segmented"' in port["dump"]
    assert '"search_end"' in port["dump"]


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_device_backends_on_the_slice(both, backend):
    """The device backends (on the CPU here) on the same 86.8 k-message
    batch, and the scan timing counters a recorder collects for them."""
    ref, _ = both
    jobs = port_workloads.synt_workload_3()
    cluster = PortClusterTopology()
    trials = [port_mapping.STRATEGIES[n](jobs, cluster)
              for n in port_mapping.ONE_SHOT_STRATEGIES]
    with port_obs.recording() as rec:
        batch = simulate_batch(jobs, trials, cluster, SCALE, backend=backend,
                               device="cpu")
    for name, res in zip(port_mapping.ONE_SHOT_STRATEGIES, batch):
        assert_results_close(res, ref["results"][name], 1e-9,
                             f"{backend} {name}")
    wall = rec.metrics.to_dict(include_wall=True)
    for leg in ("sim.h2d_s", "sim.scan_s", "sim.d2h_s"):
        assert wall[leg]["n"] >= 1 and wall[leg]["total"] >= 0.0
        assert leg not in rec.metrics.to_dict()     # wall-clock: not dumped
    _FLAT_CACHE.clear()
