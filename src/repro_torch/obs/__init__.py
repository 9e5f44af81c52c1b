"""Flight-recorder observability: tracing, metrics, exporters (§11).

Public surface:
  recorder — Recorder / NULL no-op, install()/current()/recording(),
             REPRO_TRACE env opt-in (from_env)
  metrics  — Metrics registry (Counter / Gauge / Histogram / Series)
  export   — Chrome trace-event (Perfetto) + CSV exporters, trace-schema
             validators, ``python -m repro_torch.obs.export`` CLI
"""
from .metrics import Counter, Gauge, Histogram, Metrics, Series
from .recorder import (CAT_METRIC, CAT_SCHED, CAT_SEARCH, CAT_SIM, NULL,
                       NullRecorder, Recorder, TraceEvent, current, from_env,
                       install, recording)

__all__ = [
    "CAT_METRIC", "CAT_SCHED", "CAT_SEARCH", "CAT_SIM",
    "Counter", "Gauge", "Histogram", "Metrics", "Series",
    "NULL", "NullRecorder", "Recorder", "TraceEvent",
    "current", "from_env", "install", "recording",
]
