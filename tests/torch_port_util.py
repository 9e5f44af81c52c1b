"""Shared helpers of the ``test_torch_*`` differential tests.

Inputs are made once, from a seed with numpy, as the reference package's
objects; ``repro_torch.core.convert`` rebuilds them for the port from
their plain fields, so both packages compute on the same jobs, cluster
and placement.
"""
import contextlib
import dataclasses
import json

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


class FakeLibrary:
    """Stands in for a built kernel library (``ctypes.CDLL``) where there
    is no ``nvcc``: every attribute is a callable that records the
    ``argtypes`` / ``restype`` a wrapper declares on it and returns the
    value given for its name (0 otherwise)."""

    class Function:
        def __init__(self, value):
            self.value, self.argtypes, self.restype = value, None, None

        def __call__(self, *args):
            return self.value

    def __init__(self, **values):
        self._values = values

    def __getattr__(self, name):
        fn = self.Function(self._values.get(name, 0))
        setattr(self, name, fn)
        return fn


# ---------------------------------------------------------------------------
# The fleet scheduler, run live in both packages on the same trace
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SchedRun:
    """One scheduler run and what it decided, step by step."""

    sched: object
    stats: object
    dump: str            # the flight recorder, wall-clock fields excluded
    events: list         # (time, kind, job_id, epoch, node, deadline) handled
    placements: list     # (now, "assign" | "remove", job_id, cores)


def _log_placements(sched, log: list) -> None:
    """Record every change of the scheduler's live placement: every admit,
    migration, shrink, eviction and departure goes through these two."""
    placement = sched.placement
    assign, remove = placement.assign, placement.remove

    def logged_assign(job_id, cores):
        log.append((sched.now, "assign", int(job_id),
                    tuple(int(c) for c in cores)))
        return assign(job_id, cores)

    def logged_remove(job_id):
        log.append((sched.now, "remove", int(job_id), ()))
        return remove(job_id)

    placement.assign, placement.remove = logged_assign, logged_remove


def sched_config(pkg, spec, flat=None, autoscale=None):
    """``pkg``'s :class:`SchedulerConfig` for ``spec`` from the historical
    flat kwargs (each package's ``from_legacy``) plus an enabled autoscale
    section over the spec's SLOs."""
    cfg = pkg.SchedulerConfig.from_legacy(
        state_bytes_per_proc=spec.state_bytes_per_proc,
        count_scale=spec.count_scale, **(flat or {}))
    if autoscale is not None:
        cfg = dataclasses.replace(cfg, autoscale=pkg.AutoscaleConfig(
            enabled=True, slos=spec.slos, **autoscale))
    return cfg


def run_sched(package, spec, strategy="new", flat=None, *, autoscale=None,
              faults=None, check=True, **sched_kw) -> SchedRun:
    """Run ``spec`` (a reference-made trace, converted for the port) through
    ``package`` ("ref" or "port") event by event, checking the invariants
    after every event. The port runs on the host (``device="cpu"``)."""
    if package == "port":
        import repro_torch.obs as obs_mod
        import repro_torch.sched as pkg
        spec = convert.from_reference(spec)
        faults = None if faults is None else convert.from_reference(list(faults))
        sched_kw.setdefault("device", "cpu")
    else:
        import repro.obs as obs_mod
        import repro.sched as pkg
    rec = obs_mod.Recorder()
    sched = pkg.FleetScheduler(spec.cluster, strategy, recorder=rec,
                               config=sched_config(pkg, spec, flat, autoscale),
                               **sched_kw)
    placements: list = []
    _log_placements(sched, placements)
    for g in getattr(spec, "replicas", ()):
        sched.submit(g, at=0.0, resident=True)
    sched.submit_trace(spec.arrivals)
    if faults is not None:
        sched.submit_faults(faults)
    if autoscale is not None:
        sched.submit_traffic(spec.stream)
    until = sched.autoscale.horizon if sched.autoscale.enabled else None
    events = []
    while until is None or (sched.events.peek() is not None
                            and sched.events.peek().time <= until):
        ev = sched.step()
        if ev is None:
            break
        events.append((ev.time, ev.kind, ev.job_id, ev.epoch, ev.node,
                       ev.deadline))
        if check:
            sched.check_invariants()
    stats = sched.run()          # nothing left to step: settles the clock
    return SchedRun(sched, stats, json.dumps(rec.dump(), sort_keys=True),
                    events, placements)


def run_pair(spec, strategy="new", flat=None, *, port_flat=None, **kw):
    """The same trace through the reference and the port: ``(ref, port)``.
    ``port_flat`` replaces ``flat`` for the port (another backend)."""
    return (run_sched("ref", spec, strategy, flat, **kw),
            run_sched("port", spec, strategy,
                      flat if port_flat is None else port_flat, **kw))


def _assert_tree_close(a, b, tol, what):
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), what
        for k in b:
            _assert_tree_close(a[k], b[k], tol, f"{what}[{k!r}]")
    elif isinstance(b, (list, tuple)):
        assert isinstance(a, (list, tuple)) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_close(x, y, tol, f"{what}[{i}]")
    elif isinstance(b, float) and not isinstance(a, bool):
        close(a, b, tol, what)
    else:
        assert a == b, f"{what}: {a!r} vs {b!r}"


def decisions(run: SchedRun) -> dict:
    """What the scheduler decided: handled events, placement changes
    (admission order, every core of every job), remap, autoscale and drain
    verdicts, as plain values."""
    s = run.sched
    return {"events": run.events, "placements": run.placements,
            "remap": [dataclasses.astuple(d) for d in s.decisions],
            "autoscale": [dataclasses.astuple(d) for d in s.autoscale.decisions],
            "draining": dict(s.draining),
            "pending": list(s.pending)}


def assert_same_run(port: SchedRun, ref: SchedRun, tol=None):
    """``tol=None``: the two runs are equal — every decision, every
    ``FleetStats`` field and the flight-recorder dump byte for byte.
    Otherwise the decisions (kinds, jobs, nodes, cores, verdicts) are
    identical and every float, in the stats, the decisions and the
    dump's records, agrees within ``tol`` relative."""
    if tol is None:
        assert decisions(port) == decisions(ref)
        assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
        assert port.dump == ref.dump
        return
    _assert_tree_close(decisions(port), decisions(ref), tol, "decisions")
    _assert_tree_close(dataclasses.asdict(port.stats),
                       dataclasses.asdict(ref.stats), tol, "stats")
    _assert_tree_close(json.loads(port.dump), json.loads(ref.dump), tol, "dump")
