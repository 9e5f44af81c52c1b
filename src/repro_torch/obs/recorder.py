"""Structured trace recorder — deterministic spans and instant events.

The flight-recorder observability layer (DESIGN.md §11). One
:class:`Recorder` collects every event the instrumented subsystems emit
— the fleet scheduler's admit/depart/remap decisions, the simulator's
per-call provenance (backend, message counts, warm vs cold assembly),
the placement search's evaluation trajectory — as structured records
keyed on **simulation time**, plus a :class:`~repro_torch.obs.metrics.Metrics`
registry for aggregate counters.

Event model (native format ``repro-trace-v1``):

* ``phase``: ``"i"`` (instant), ``"X"`` (complete span with a sim-time
  duration), ``"C"`` (counter sample) — the same phase letters the
  Chrome trace-event exporter maps through 1:1.
* ``ts`` / ``dur``: simulation seconds. No event ever reads the wall
  clock for its timestamp, so two seeded runs record byte-identical
  streams. An *optional* ``wall`` field carries a wall-clock duration
  (how long a simulate call or a search actually took) and is excluded
  from dumps unless asked for — determinism by default, profiling on
  demand.
* ``proc`` / ``track``: the Perfetto process/thread the exporter places
  the event on (one process per subsystem or benchmark leg, one track
  per rack / level / event class).

Cost contract: call sites guard on ``Recorder.enabled`` — the single
attribute test is the whole disabled-path cost, and the module-level
default is the shared :data:`NULL` no-op recorder, so un-instrumented
programs never allocate a buffer (gated in ``baselines.json``:
disabled-recorder overhead <= 3% of sched_bench quick wall time).

Flight-recorder mode (``mode="ring"``) bounds the buffer to the last
``ring`` events; ``flight_lines()`` formats that tail as a timeline for
``FleetScheduler.check_invariants()`` failures, so property-test
counterexamples arrive with the events that led up to them.

Install a recorder process-wide with :func:`install` (or the
:func:`recording` context manager) so module-level instrumentation
(simulator, search) can reach it via :func:`current`; ``REPRO_TRACE=1``
(full) / ``=ring`` opt in from the environment via :func:`from_env`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from collections import deque
from typing import Iterator, Optional

from .metrics import Metrics

FORMAT = "repro-trace-v1"

INSTANT = "i"
SPAN = "X"
COUNTER = "C"

#: event categories (one Perfetto process each, unless overridden)
CAT_SCHED = "sched"
CAT_SIM = "sim"
CAT_SEARCH = "search"
CAT_METRIC = "metric"

_DEF_RING = 256


@dataclasses.dataclass
class TraceEvent:
    """One structured record. ``ts``/``dur`` are simulation seconds;
    ``wall`` is an optional wall-clock duration in seconds (profiling
    only — excluded from dumps by default)."""

    name: str
    cat: str
    ph: str
    ts: float
    dur: float = 0.0
    proc: str = "main"
    track: str = ""
    args: Optional[dict] = None
    wall: Optional[float] = None

    def to_dict(self, include_wall: bool = False) -> dict:
        d = {"name": self.name, "cat": self.cat, "ph": self.ph,
             "ts": self.ts, "dur": self.dur, "proc": self.proc,
             "track": self.track or self.cat,
             "args": self.args if self.args is not None else {}}
        if include_wall and self.wall is not None:
            d["wall"] = self.wall
        return d

    def line(self) -> str:
        """Compact one-line rendering for flight-recorder dumps."""
        args = "" if not self.args else " " + " ".join(
            f"{k}={v}" for k, v in sorted(self.args.items()))
        dur = f" dur={self.dur:g}" if self.ph == SPAN else ""
        return f"t={self.ts:<12g} [{self.cat}] {self.name}{dur}{args}"


class Recorder:
    """Collects :class:`TraceEvent` records plus a metrics registry.

    ``mode="full"`` keeps every event; ``mode="ring"`` keeps the last
    ``ring`` (the flight recorder). A recorder constructed with
    ``enabled=False`` is a pure no-op whose methods return immediately —
    the object call sites see when tracing is off.
    """

    def __init__(self, mode: str = "full", ring: int = _DEF_RING,
                 enabled: bool = True):
        if mode not in ("full", "ring"):
            raise ValueError(f"unknown recorder mode {mode!r}")
        self.enabled = enabled
        self.mode = mode
        self.ring = ring
        self.events: "deque[TraceEvent] | list[TraceEvent]" = (
            deque(maxlen=ring) if mode == "ring" else [])
        self.metrics = Metrics()
        self.clock = 0.0          # current simulation time (set by owners)
        self.process = "main"     # current Perfetto process label

    # -- context set by the owning subsystem -------------------------------
    def set_clock(self, t: float) -> None:
        self.clock = t

    def set_process(self, name: str) -> None:
        self.process = name

    # -- emission ----------------------------------------------------------
    def instant(self, name: str, cat: str = CAT_SCHED, *,
                ts: Optional[float] = None, track: str = "",
                wall: Optional[float] = None, **args) -> None:
        if not self.enabled:
            return
        self.events.append(TraceEvent(
            name=name, cat=cat, ph=INSTANT,
            ts=self.clock if ts is None else ts, proc=self.process,
            track=track, args=args or None, wall=wall))

    def span(self, name: str, cat: str = CAT_SCHED, *, ts: float,
             dur: float, track: str = "", wall: Optional[float] = None,
             **args) -> None:
        if not self.enabled:
            return
        self.events.append(TraceEvent(
            name=name, cat=cat, ph=SPAN, ts=ts, dur=max(dur, 0.0),
            proc=self.process, track=track, args=args or None, wall=wall))

    def counter(self, name: str, value, cat: str = CAT_METRIC, *,
                ts: Optional[float] = None, track: str = "") -> None:
        """One sample of a counter track; ``value`` is a number or a
        {series-name: number} dict (multi-line counter)."""
        if not self.enabled:
            return
        args = dict(value) if isinstance(value, dict) else {"value": value}
        self.events.append(TraceEvent(
            name=name, cat=cat, ph=COUNTER,
            ts=self.clock if ts is None else ts, proc=self.process,
            track=track, args=args))

    # -- dumps -------------------------------------------------------------
    def n_events(self) -> int:
        return len(self.events)

    def dump(self, extra_metrics: Optional[dict] = None,
             include_wall: bool = False) -> dict:
        """Native-format document: events + metrics registries.

        ``extra_metrics`` maps namespace -> :class:`Metrics` (e.g. one
        per scheduler run) merged next to the recorder's own registry
        under ``"metrics"``. Deterministic: sorted keys, wall-clock
        fields excluded unless ``include_wall``.
        """
        metrics = {"recorder": self.metrics.to_dict(include_wall)}
        for ns, reg in (extra_metrics or {}).items():
            metrics[ns] = (reg.to_dict(include_wall)
                           if isinstance(reg, Metrics) else dict(reg))
        return {
            "format": FORMAT,
            "clock": "sim-seconds",
            "mode": self.mode,
            "events": [e.to_dict(include_wall) for e in self.events],
            "metrics": metrics,
        }

    def dump_json(self, extra_metrics: Optional[dict] = None,
                  include_wall: bool = False) -> str:
        return json.dumps(self.dump(extra_metrics, include_wall),
                          indent=1, sort_keys=True)

    # -- flight recorder ---------------------------------------------------
    def flight_lines(self, n: int = _DEF_RING) -> list[str]:
        """The last ``n`` events as one-line strings (newest last)."""
        tail = list(self.events)[-n:]
        return [e.line() for e in tail]

    def flight_dump(self, n: int = _DEF_RING) -> str:
        lines = self.flight_lines(n)
        if not lines:
            return ""
        head = f"-- flight recorder: last {len(lines)} events --"
        return "\n".join([head] + lines)


class NullRecorder(Recorder):
    """The shared disabled recorder — every emission is a no-op."""

    def __init__(self) -> None:
        super().__init__(enabled=False)


#: process-wide default; swap with install()/recording()
NULL = NullRecorder()
_CURRENT: Recorder = NULL


def current() -> Recorder:
    """The installed process-wide recorder (the NULL no-op by default)."""
    return _CURRENT


def install(rec: Optional[Recorder]) -> Recorder:
    """Install ``rec`` process-wide; ``None`` restores the NULL no-op."""
    global _CURRENT
    _CURRENT = rec if rec is not None else NULL
    return _CURRENT


@contextlib.contextmanager
def recording(rec: Optional[Recorder] = None) -> Iterator[Recorder]:
    """Scoped install: ``with recording() as rec: ...`` traces the block."""
    rec = rec if rec is not None else Recorder()
    prev = _CURRENT
    install(rec)
    try:
        yield rec
    finally:
        install(prev if prev is not NULL else None)


def from_env(env: Optional[dict] = None) -> Optional[Recorder]:
    """Recorder configured by ``REPRO_TRACE`` (None when unset/empty).

    ``REPRO_TRACE=1|full`` -> full recorder; ``REPRO_TRACE=ring`` ->
    flight-recorder ring (size ``REPRO_TRACE_RING``, default 256);
    ``REPRO_TRACE=0`` / unset -> None.
    """
    env = os.environ if env is None else env
    val = str(env.get("REPRO_TRACE", "")).strip().lower()
    if val in ("", "0", "off", "false"):
        return None
    ring = int(env.get("REPRO_TRACE_RING", _DEF_RING))
    if val == "ring":
        return Recorder(mode="ring", ring=ring)
    return Recorder(mode="full")
