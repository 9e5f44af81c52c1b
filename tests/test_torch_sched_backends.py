"""The port's scheduler on its float64 device backends against the
reference's ``jax`` backend, on the CPU.

The port runs ``sim_backend="torch"`` and ``"kernel"`` with
``device="cpu"`` (where the kernel's wrapper takes its plain version, the
same scan in the kernel's order), the reference its ``jax`` backend in
float64 (``reference_x64``). The scans associate their sums differently,
so the decisions must be identical — every event, admission, core,
remap and autoscale verdict — and every float within 1e-9 relative, the
reference's own ``TOL`` (``tests/test_sim_backends.py``).
"""
import pytest
import torch

from repro.sched import get_trace as ref_get_trace
from repro.sched import reference_fault_trace as ref_reference_fault_trace
from torch_port_util import assert_same_run, reference_x64, run_pair

torch.set_num_threads(1)

TOL = 1e-9
REF = {"sim_backend": "jax"}


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_table4_with_remaps_matches_reference_jax(backend):
    with reference_x64():
        ref, port = run_pair(ref_get_trace("table4_poisson", n_arrivals=8), "new",
                             dict(REF, remap_interval=5.0),
                             port_flat={"sim_backend": backend, "remap_interval": 5.0})
    assert_same_run(port, ref, tol=TOL)


def test_remap_search_matches_reference_jax():
    """The budgeted remap search scores populations with ``simulate_batch``:
    one batched device scan per population."""
    with reference_x64():
        ref, port = run_pair(ref_get_trace("rack_oversub", n_arrivals=6), "new",
                             dict(REF, remap_interval=5.0, remap_budget=16),
                             port_flat={"sim_backend": "torch", "remap_interval": 5.0,
                                        "remap_budget": 16})
    assert ref.sched.decisions
    assert_same_run(port, ref, tol=TOL)


def test_faults_and_joint_admission_match_reference_jax():
    spec = ref_get_trace("table4_poisson", n_arrivals=8)
    flat = dict(failure_policy="requeue", drain_policy="proactive",
                admission_window=0.5)
    with reference_x64():
        ref, port = run_pair(spec, "new", dict(REF, **flat),
                             port_flat=dict(flat, sim_backend="torch"),
                             faults=ref_reference_fault_trace(spec.cluster))
    assert ref.stats.n_node_failures > 0
    assert_same_run(port, ref, tol=TOL)


def test_serve_slo_autoscale_matches_reference_jax():
    spec = ref_get_trace("serve_slo", seed=0, horizon=60.0, epoch_dt=4.0)
    with reference_x64():
        ref, port = run_pair(spec, "new", REF, port_flat={"sim_backend": "torch"},
                             autoscale=dict(actions=True, max_replicas=5,
                                            lookahead_s=30.0))
    assert_same_run(port, ref, tol=TOL)
