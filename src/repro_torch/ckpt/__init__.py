"""Checkpoint cost and fault models of the fleet scheduler (host, numpy).

  checkpoint      — CheckpointCostModel: what a restart loses and costs
  fault_tolerance — HeartbeatMonitor, ElasticReMesher, StragglerTracker
"""
from .checkpoint import CheckpointCostModel
from .fault_tolerance import (ElasticReMesher, HeartbeatMonitor,
                              ReMeshResult, StragglerTracker)

__all__ = ["CheckpointCostModel", "ElasticReMesher", "HeartbeatMonitor",
           "ReMeshResult", "StragglerTracker"]
