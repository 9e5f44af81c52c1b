"""The port's cell fabric and joint admission against the reference's.

Flat and nested cells on the 64-node fleet, windowed joint admission,
cross-cell migration and the facade's layering, run live in both
packages on the host ``segmented`` backend: identical decisions, equal
``FleetStats`` and byte-identical flight-recorder dumps. Mirrors
``tests/test_joint_admission.py`` and ``tests/test_sched_layers.py``.
"""
import ast
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro.core.workloads import rack_oversub_mix as ref_rack_oversub_mix
from repro.sched import CellConfig as RefCellConfig
from repro.sched import FleetScheduler as RefFleetScheduler
from repro.sched import RemapConfig as RefRemapConfig
from repro.sched import SchedulerConfig as RefSchedulerConfig
from repro.sched import build_cells as ref_build_cells
from repro.sched import fault_trace as ref_fault_trace
from repro.sched import get_trace as ref_get_trace
from repro_torch.core import convert
from repro_torch.sched import (CellConfig, FleetScheduler, RemapConfig,
                               SchedulerConfig, build_cells)
from torch_port_util import assert_same_run, run_pair

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEGMENTED = {"sim_backend": "segmented"}


@pytest.mark.parametrize("cells,window", [("rack", 0.0), ("rack", 0.5),
                                          ("pod", 0.5), ("pod/rack", 0.5)])
def test_fleet64_cells_match_reference(cells, window):
    ref, port = run_pair(ref_get_trace("fleet64", n_arrivals=16), "new",
                         dict(SEGMENTED, cells=cells, admission_window=window))
    assert ref.sched.n_cells > 1
    assert_same_run(port, ref)


def test_fleet64_nested_cells_under_fault_storm_match_reference():
    spec = ref_get_trace("fleet64", n_arrivals=16)
    faults = ref_fault_trace(spec.cluster, horizon=40.0, node_mtbf=120.0,
                             node_mttr=8.0, rack_mtbf=40.0, rack_size=4,
                             n_drains=2, seed=7)
    ref, port = run_pair(spec, "new", dict(SEGMENTED, cells="pod/rack",
                                           admission_window=0.5),
                         faults=faults)
    assert ref.stats.n_node_failures > 0
    assert_same_run(port, ref)


@pytest.mark.parametrize("trace", ["table4_poisson", "rack_oversub"])
@pytest.mark.parametrize("window", [0.25, 1.0])
def test_windowed_admission_matches_reference(trace, window):
    ref, port = run_pair(ref_get_trace(trace, n_arrivals=12), "new",
                         dict(SEGMENTED, admission_window=window))
    assert ref.stats.n_joint_batches > 0
    assert_same_run(port, ref)


def test_rack_oversub_remap_search_matches_reference():
    """The budgeted remap search scores its populations through
    ``simulate_batch`` (the golden scenario's knobs)."""
    ref, port = run_pair(ref_get_trace("rack_oversub", n_arrivals=10), "new",
                         dict(SEGMENTED, remap_interval=5.0, remap_budget=64))
    assert ref.sched.decisions
    assert_same_run(port, ref)


@pytest.mark.parametrize("spec", ["pod/rack", "rack", 4, "rack/pod", "pod/rack/node"])
def test_build_cells_matches_reference(spec):
    cluster = ref_get_trace("fleet64").cluster
    kw = dict(count_scale=0.02, backend="segmented")
    try:
        want = ref_build_cells(cluster, spec, **kw)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20]):
            build_cells(convert.from_reference(cluster), spec, device="cpu", **kw)
        return
    got = build_cells(convert.from_reference(cluster), spec, device="cpu", **kw)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.cell_id, a.parent, a.children, a.uplink_bw) == \
            (b.cell_id, b.parent, b.children, b.uplink_bw)
        np.testing.assert_array_equal(a.nodes, b.nodes)
        np.testing.assert_array_equal(a.tracker.offline, b.tracker.offline)
        assert a.sim.device == torch.device("cpu")


def _packed_two_cells(sched, mix):
    """``test_sched_layers``' two racks packed solid (24 + 8 cores each),
    then one remap pass."""
    jid = 0
    for k in range(2):
        for g in mix:
            sched.admit(dataclasses.replace(g, job_id=jid),
                        cell=sched.fabric.cells[k])
            jid += 1
    sched.clock.reclock_fleet()
    sched.remap.run_pass()
    sched.check_invariants()
    return sched


@pytest.mark.parametrize("cost,cross", [(0.0, True), (0.0, False), (1e9, True)],
                         ids=["commits", "gated", "priced"])
def test_cross_cell_migration_matches_reference(cost, cross):
    def config(cfg, cells, remap):
        return cfg(cells=cells(cells="rack", cross_cell_migration=cross),
                   remap=remap(interval=2.0, util_threshold=0.05,
                               migration_cost_factor=cost),
                   sim_backend="segmented")

    mix = [g for g in ref_rack_oversub_mix() if g.n_procs in (24, 8)]
    cluster = ref_get_trace("fleet64").cluster
    ref = _packed_two_cells(RefFleetScheduler(cluster, "new", config=config(
        RefSchedulerConfig, RefCellConfig, RefRemapConfig)), mix)
    port = _packed_two_cells(FleetScheduler(
        convert.from_reference(cluster), "new", device="cpu",
        config=config(SchedulerConfig, CellConfig, RemapConfig)),
        convert.from_reference(mix))
    assert port.fabric.job_cell == ref.fabric.job_cell
    assert [dataclasses.astuple(d) for d in port.decisions] == \
        [dataclasses.astuple(d) for d in ref.decisions]
    for jid, job in ref.live.items():
        np.testing.assert_array_equal(port.live[jid].cores, job.cores)
    assert dataclasses.asdict(port.stats()) == dataclasses.asdict(ref.stats())
    if cross and cost == 0.0:
        assert ref.stats().n_cross_cell_migrations == 1


def _check_layering():
    spec = importlib.util.spec_from_file_location(
        "check_layering", ROOT / "benchmarks" / "check_layering.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_engines_respect_the_reference_layering(monkeypatch):
    """``benchmarks/check_layering.py``'s rule, applied to the port's
    ``sched`` package: the five engines import only the leaf siblings, the
    foundation packages, the stdlib's allowed modules and numpy. The port
    imports relatively, so its modules resolve as the reference's do."""
    lint = _check_layering()
    monkeypatch.setattr(lint, "SCHED", str(ROOT / "src" / "repro_torch" / "sched"))
    for mod in lint.ENGINES:
        assert lint.check_module(mod) == [], mod
        tree = ast.parse((ROOT / "src" / "repro_torch" / "sched" / f"{mod}.py").read_text())
        assert all(node.level > 0 for node in ast.walk(tree)
                   if isinstance(node, ast.ImportFrom)
                   and node.module not in lint.STDLIB_OK)


def test_the_layering_rule_catches_an_engine_import(monkeypatch, tmp_path):
    """The rule is live on the port's tree: an engine that imports a
    peer engine, or ``torch``, is flagged."""
    lint = _check_layering()
    src = (ROOT / "src" / "repro_torch" / "sched" / "remap.py").read_text()
    (tmp_path / "remap.py").write_text(
        src + "\nfrom .admission import AdmissionController\nimport torch\n")
    monkeypatch.setattr(lint, "SCHED", str(tmp_path))
    bad = lint.check_module("remap")
    assert any("admission" in b for b in bad) and any("torch" in b for b in bad)
