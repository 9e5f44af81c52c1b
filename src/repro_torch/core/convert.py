"""Build this package's objects from plain arrays, scalars and field dicts.

The state this system carries is its workload and fleet state: job
traffic matrices, the cluster's fields and network hierarchy, a
placement's per-job core arrays, a tracker's used / offline masks, and
the fleet scheduler's inputs: a trace (its cluster, timestamped
arrivals and knobs and, for a serving trace, resident replicas, SLOs and
request stream) and injected node events; and the mesh planner's inputs:
model configs, input shapes, the fleet's parameters and job specs
(``core.meshplan.JobSpec``). These functions rebuild each
from values read off another implementation's objects **by attribute**
— no import of that implementation is needed, so a differential test
can hand both packages the same jobs, cluster, placement and trace.
Arrays are copied; nothing aliases the source object.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np

from .graphs import AppGraph, ClusterTopology, FreeCoreTracker, Placement
from .hierarchy import NetLevel, NetworkHierarchy

_CLUSTER_FIELDS = tuple(f.name for f in dataclasses.fields(ClusterTopology))
_LEVEL_FIELDS = tuple(f.name for f in dataclasses.fields(NetLevel))


def appgraph_from_arrays(name: str, L, lam, cnt, job_id: int = 0) -> AppGraph:
    """An :class:`AppGraph` from its three (P, P) traffic matrices."""
    L = np.array(L, dtype=np.float64)
    lam = np.array(lam, dtype=np.float64)
    cnt = np.array(cnt)
    if not (L.ndim == 2 and L.shape[0] == L.shape[1]
            and lam.shape == L.shape and cnt.shape == L.shape):
        raise ValueError(f"traffic matrices must be one (P, P) shape, got "
                         f"{L.shape}, {lam.shape}, {cnt.shape}")
    return AppGraph(name=str(name), L=L, lam=lam, cnt=cnt, job_id=int(job_id))


def hierarchy_from_levels(levels: Sequence[Mapping]) -> NetworkHierarchy:
    """A :class:`NetworkHierarchy` from per-level field dicts (the keys of
    :class:`NetLevel`; extra keys such as ``describe()``'s derived
    ``group_cores`` are ignored)."""
    return NetworkHierarchy([
        NetLevel(**{k: lv[k] for k in _LEVEL_FIELDS if k in lv})
        for lv in levels])


def cluster_from_fields(**fields) -> ClusterTopology:
    """A :class:`ClusterTopology` from its fields by name.

    ``hierarchy`` is ``None`` or a list of per-level field dicts (see
    :func:`hierarchy_from_levels`). Unknown field names raise.
    """
    unknown = sorted(set(fields) - set(_CLUSTER_FIELDS))
    if unknown:
        raise TypeError(f"unknown ClusterTopology fields: {unknown}")
    levels = fields.pop("hierarchy", None)
    if levels is not None:
        fields["hierarchy"] = hierarchy_from_levels(levels)
    return ClusterTopology(**fields)


def placement_from_assignments(cluster: ClusterTopology,
                               assignments: Mapping[int, Sequence[int]]
                               ) -> Placement:
    """A :class:`Placement` on ``cluster`` from ``{job_id: cores}``."""
    placement = Placement(cluster)
    for job_id, cores in assignments.items():
        placement.assign(int(job_id), np.array(cores, dtype=np.int64))
    return placement


def tracker_from_masks(cluster: ClusterTopology, used,
                       offline=None) -> FreeCoreTracker:
    """A :class:`FreeCoreTracker` from its ``used`` / ``offline`` masks."""
    used = np.array(used, dtype=bool)
    if used.shape != (cluster.n_cores,):
        raise ValueError(f"used mask has shape {used.shape}, the cluster "
                         f"has {cluster.n_cores} cores")
    tracker = FreeCoreTracker(cluster, occupied=used)
    if offline is not None:
        offline = np.array(offline, dtype=bool)
        if offline.shape != used.shape:
            raise ValueError(f"offline mask has shape {offline.shape}, the "
                             f"cluster has {cluster.n_cores} cores")
        tracker.offline |= offline
    return tracker


def _cluster_fields_of(obj) -> dict:
    fields = {k: getattr(obj, k) for k in _CLUSTER_FIELDS if k != "hierarchy"}
    hier = getattr(obj, "hierarchy", None)
    fields["hierarchy"] = None if hier is None else [
        {k: getattr(lv, k) for k in _LEVEL_FIELDS} for lv in hier.levels]
    return fields


def _fields(obj, cls) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}


def _trace_from(obj):
    """A ``sched.traces`` spec (a ``ServeTraceSpec`` when it has a stream)."""
    from ..sched.traces import ServeTraceSpec, TraceSpec  # sched imports core

    fields = dict(name=obj.name, cluster=from_reference(obj.cluster),
                  arrivals=from_reference(list(obj.arrivals)),
                  count_scale=obj.count_scale,
                  state_bytes_per_proc=obj.state_bytes_per_proc)
    if not hasattr(obj, "stream"):
        return TraceSpec(**fields)
    return ServeTraceSpec(
        **fields, replicas=from_reference(tuple(obj.replicas)),
        slos=from_reference(tuple(obj.slos)),
        stream=None if obj.stream is None else from_reference(obj.stream))


def _arrival_from(obj):
    from .workloads import Arrival

    return Arrival(time=obj.time, graph=from_reference(obj.graph))


def _node_event_from(obj):
    from ..sched.traces import NodeEvent

    return NodeEvent(**_fields(obj, NodeEvent))


def _slo_from(obj):
    from ..serve.fleet import ModelSLO

    return ModelSLO(**_fields(obj, ModelSLO))


def _spike_from(obj):
    from ..serve.fleet import TrafficSpike

    return TrafficSpike(**_fields(obj, TrafficSpike))


def _stream_from(obj):
    from ..serve.fleet import RequestStream

    return RequestStream(obj.base_rates, obj.horizon, obj.epoch_dt,
                         diurnal_period=obj.diurnal_period,
                         diurnal_amp=obj.diurnal_amp,
                         spikes=from_reference(tuple(obj.spikes)),
                         poisson=obj.poisson, seed=obj.seed)


def _config_from(obj):
    """A ``configs`` dataclass (model config, shape, fleet parameters) of
    the same name, field for field; nested MoE / SSM configs too."""
    from .. import configs

    cls = getattr(configs, type(obj).__name__)
    return cls(**{f.name: _config_from(getattr(obj, f.name))
                  if dataclasses.is_dataclass(getattr(obj, f.name))
                  else getattr(obj, f.name)
                  for f in dataclasses.fields(cls)})


def _jobspec_from(obj):
    from .meshplan import JobSpec  # meshplan imports configs

    return JobSpec(name=obj.name, cfg=_config_from(obj.cfg),
                   shape=_config_from(obj.shape),
                   mesh_axes=dict(obj.mesh_axes), job_id=obj.job_id)


#: (attributes that identify a scheduler or mesh-planner input, its
#: converter), tried in this order before the core objects
_SCHED_INPUTS = (
    (("cfg", "shape", "mesh_axes", "job_id"), _jobspec_from),
    (("arch_id", "family", "d_model"), _config_from),
    (("kind", "seq_len", "global_batch"), _config_from),
    (("chips_per_pod", "chips_per_host", "dcn_bw_per_host"), _config_from),
    (("arrivals", "cluster", "count_scale", "state_bytes_per_proc"),
     _trace_from),
    (("time", "graph"), _arrival_from),
    (("time", "kind", "node", "deadline"), _node_event_from),
    (("model", "p99_target_s", "service_rate"), _slo_from),
    (("model", "start", "duration", "multiplier"), _spike_from),
    (("base_rates", "horizon", "epoch_dt", "epochs"), _stream_from),
)


def from_reference(obj, cluster: Optional[ClusterTopology] = None):
    """Duck-typed conversion into this package's classes of a job graph,
    cluster, hierarchy, placement or tracker, of a scheduler input: a
    trace spec, an arrival, a node event, a model SLO, a traffic spike or
    a request stream, or of a mesh-planner input: a job spec, a model
    config, a shape or the fleet's parameters (or a list / tuple of any
    of them).

    ``cluster`` is the already-converted cluster a placement or tracker
    should hang on; without it their own ``.cluster`` is converted too.
    """
    if isinstance(obj, (list, tuple)):
        return type(obj)(from_reference(o, cluster) for o in obj)
    for attrs, convert in _SCHED_INPUTS:
        if all(hasattr(obj, k) for k in attrs):
            return convert(obj)
    if all(hasattr(obj, k) for k in ("L", "lam", "cnt", "job_id")):
        return appgraph_from_arrays(obj.name, obj.L, obj.lam, obj.cnt,
                                    obj.job_id)
    if all(hasattr(obj, k) for k in ("n_nodes", "sockets_per_node", "nic_bw")):
        return cluster_from_fields(**_cluster_fields_of(obj))
    if hasattr(obj, "levels") and hasattr(obj, "group_cores"):
        return hierarchy_from_levels(
            [{k: getattr(lv, k) for k in _LEVEL_FIELDS} for lv in obj.levels])
    if hasattr(obj, "assignments") and hasattr(obj, "cluster"):
        cl = cluster if cluster is not None else from_reference(obj.cluster)
        return placement_from_assignments(cl, obj.assignments)
    if hasattr(obj, "used") and hasattr(obj, "offline"):
        cl = cluster if cluster is not None else from_reference(obj.cluster)
        return tracker_from_masks(cl, obj.used, obj.offline)
    raise TypeError(f"cannot convert {type(obj).__name__}")
