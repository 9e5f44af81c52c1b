"""Serving layer of the port: the batched decode engine.

``repro.serve.fleet`` (the fleet's request streams and SLO accounting) is
ported with the scheduler (ROADMAP queue 1).
"""
from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
