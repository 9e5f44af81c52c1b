"""Serving layer of the port: the batched decode engine and the fleet's
closed loop.

``serve.fleet`` (request streams, the SLO latency model, the violation
accountant) is numpy on the host; the fleet scheduler's autoscaler
depends on it. ``serve.engine`` holds ``ServeEngine``.
"""
from .engine import Request, ServeEngine
from .fleet import (LN100, ModelSLO, RequestStream, SLOAccountant,
                    TrafficEpoch, TrafficSpike, clone_replica, fleet_p99s,
                    model_key, replica_p99, route_weights)

__all__ = [
    "Request", "ServeEngine",
    "LN100", "ModelSLO", "RequestStream", "SLOAccountant",
    "TrafficEpoch", "TrafficSpike", "clone_replica", "fleet_p99s",
    "model_key", "replica_p99", "route_weights",
]
