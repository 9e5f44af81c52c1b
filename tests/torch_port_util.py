"""Shared helpers of the ``test_torch_*`` differential tests.

Inputs are made once, from a seed with numpy, as the reference package's
objects; ``repro_torch.core.convert`` rebuilds them for the port from
their plain fields, so both packages compute on the same jobs, cluster
and placement.
"""
import contextlib

import jax
import numpy as np
import pytest

from repro.core import ClusterTopology, NetLevel, NetworkHierarchy, Placement
from repro.core.graphs import PATTERNS, AppGraph
from repro_torch.core import convert

KB = 1 << 10
MB = 1 << 20


@contextlib.contextmanager
def reference_x64():
    """Scope in which the reference's ``jax`` backend computes in float64.

    ``sim_scan._waits_jax`` asks for ``jax.experimental.enable_x64``; where
    the installed JAX no longer has it the backend silently runs float32,
    so the tests scope 64-bit mode themselves (nothing global changes).
    """
    if hasattr(jax, "enable_x64"):
        with jax.enable_x64(True):
            yield
    else:
        from jax.experimental import enable_x64
        with enable_x64():
            yield


def random_workload(rng, cluster, n_jobs, lengths=(256.0, 64 * KB, 2 * MB)):
    """Random reference jobs + a random valid reference placement (the
    generator of the reference's own differential fuzz)."""
    jobs = []
    free = list(range(cluster.n_cores))
    rng.shuffle(free)
    placement = Placement(cluster)
    for jid in range(n_jobs):
        procs = int(rng.integers(2, 9))
        if procs > len(free):
            break
        pattern = PATTERNS[int(rng.integers(0, len(PATTERNS)))]
        length = float(rng.choice(lengths))
        rate = float(rng.uniform(5.0, 200.0))
        count = int(rng.integers(1, 30))
        jobs.append(AppGraph.from_pattern(f"j{jid}", pattern, procs, length,
                                          rate, count, job_id=jid))
        placement.assign(jid, np.array([free.pop() for _ in range(procs)],
                                       dtype=np.int64))
    return jobs, placement


def random_hierarchy(rng, cores_per_node, n_nodes):
    """Random 2-4 level tree (the reference fuzz's generator)."""
    levels = [NetLevel("node", fan_in=cores_per_node,
                       bw=float(rng.uniform(4e9, 50e9)),
                       latency=float(rng.choice([0.0, 1e-7, 1e-6])))]
    group_nodes = 1
    for k in range(int(rng.integers(1, 4))):
        fan = int(rng.integers(2, 4))
        if group_nodes * fan > n_nodes:
            break
        group_nodes *= fan
        express = bool(rng.random() < 0.4)
        attach = cores_per_node if express and rng.random() < 0.5 else None
        levels.append(NetLevel(
            f"l{k}", fan_in=fan, bw=float(rng.uniform(4e9, 20e9)),
            latency=float(rng.choice([0.0, 1e-7, 5e-7])),
            express=express, attach_cores=attach))
    return NetworkHierarchy(levels)


def scenario(kind, seed, n_jobs=4):
    """(reference jobs, reference placement, reference cluster) of one
    random scenario on a flat, ICI/pod or random-hierarchy cluster."""
    rng = np.random.default_rng(seed)
    lengths = (256.0, 64 * KB, 2 * MB)
    if kind == "flat":
        cluster = ClusterTopology(n_nodes=4)
    elif kind == "ici_pod":
        cluster = ClusterTopology(n_nodes=8, pods=2, ici_bw=50e9,
                                  cache_msg_cap=float(1 << 19))
    elif kind == "hierarchy":
        n_nodes = int(rng.choice([8, 12, 16]))
        cluster = ClusterTopology(
            n_nodes=n_nodes, sockets_per_node=2, cores_per_socket=2,
            cache_msg_cap=float(rng.choice([1 << 19, 1 << 62])))
        cluster.hierarchy = random_hierarchy(rng, cluster.cores_per_node,
                                             n_nodes)
        lengths = (256.0, 64 * KB, 512 * KB)
    else:
        raise KeyError(kind)
    jobs, placement = random_workload(rng, cluster, n_jobs, lengths)
    return jobs, placement, cluster


def to_port(jobs, placement, cluster):
    """The same scenario as the port's objects."""
    t_cluster = convert.from_reference(cluster)
    return (convert.from_reference(jobs),
            convert.from_reference(placement, t_cluster), t_cluster)


def permuted_trials(rng, jobs, placement, k):
    """K reference trial placements: one job's cores permuted per trial."""
    trials = []
    for i in range(k):
        p = placement.copy()
        jid = jobs[i % len(jobs)].job_id
        cores = p.assignments[jid].copy()
        rng.shuffle(cores)
        p.assign(jid, cores)
        trials.append(p)
    return trials


def close(a, b, tol, what):
    assert a == pytest.approx(b, rel=tol, abs=tol), f"{what}: {a} vs {b}"


def assert_results_close(res, base, tol, what):
    """The reference's own agreement rule (``tests/test_sim_backends.py``):
    metrics at ``tol``, utilisation at ``abs max(tol, 1e-6)`` because
    busy/span is ill-conditioned at saturation."""
    close(res.total_wait, base.total_wait, tol, f"{what} total_wait")
    close(res.workload_finish, base.workload_finish, tol,
          f"{what} workload_finish")
    close(res.total_job_finish, base.total_job_finish, tol,
          f"{what} total_job_finish")
    assert res.max_server_utilisation == pytest.approx(
        base.max_server_utilisation, rel=tol, abs=max(tol, 1e-6)), \
        f"{what} util"
    assert res.n_messages == base.n_messages
    assert res.job_finish.keys() == base.job_finish.keys()
    for jid in base.job_finish:
        close(res.job_finish[jid], base.job_finish[jid], tol,
              f"{what} job_finish[{jid}]")
        close(res.per_job_wait[jid], base.per_job_wait[jid],
              max(tol, tol * base.per_job_wait[jid]),
              f"{what} per_job_wait[{jid}]")
