"""Metrics registry — counters, gauges, histograms and time series.

The flight-recorder layer (DESIGN.md §11) splits observability into two
halves: *events* (``repro_torch.obs.recorder``) and *metrics* (this module).
A :class:`Metrics` registry is a flat, name-keyed collection of four
primitive instrument kinds:

* :class:`Counter`   — monotonically accumulated totals (simulate calls
  per backend, flat-cache hits, evaluations spent).
* :class:`Gauge`     — last-value-wins samples with an optional
  time-stamped history (queue depth, live jobs). The history makes a
  gauge a deterministic step time series the Perfetto exporter turns
  into a counter track.
* :class:`Histogram` — scalar sample distributions summarised as
  count/mean/min/max/p50/p99 (peak server utilisation per mutation).
* :class:`Series`    — time-stamped vector samples (per-link utilisation
  of one hierarchy level at each fleet mutation); the p99 is taken over
  the concatenation of every sample, and the summary always carries the
  sample count so a 3-sample p99 is distinguishable from a 3000-sample
  one (the ``FleetStats`` metadata satellite).

Everything is plain Python + numpy, no locks (the schedulers are
single-threaded), and every summary is a deterministic function of the
recorded values: two seeded runs dump byte-identical JSON. Instruments
created with ``wall=True`` hold wall-clock-derived values (evals/s,
simulate wall spans) and are excluded from :meth:`Metrics.to_dict` by
default so the determinism contract survives instrumentation that
happens to measure real time.
"""
from __future__ import annotations

from typing import Union

import numpy as np

Number = Union[int, float]


def _round(x: float) -> float:
    """Canonical float for dumps: finite repr, no -0.0 noise."""
    x = float(x)
    return 0.0 if x == 0.0 else x


class Counter:
    """Accumulated total + increment count."""

    __slots__ = ("name", "wall", "total", "n")

    def __init__(self, name: str, wall: bool = False):
        self.name = name
        self.wall = wall
        self.total = 0.0
        self.n = 0

    def inc(self, v: Number = 1) -> None:
        self.total += v
        self.n += 1

    def summary(self) -> dict:
        return {"kind": "counter", "total": _round(self.total), "n": self.n}


class Gauge:
    """Last-value sample with an optional (time, value) step history."""

    __slots__ = ("name", "wall", "value", "n", "times", "values")

    def __init__(self, name: str, wall: bool = False):
        self.name = name
        self.wall = wall
        self.value = 0.0
        self.n = 0
        self.times: list[float] = []
        self.values: list[float] = []

    def set(self, v: Number, t: float | None = None) -> None:
        self.value = float(v)
        self.n += 1
        if t is not None:
            self.times.append(float(t))
            self.values.append(float(v))

    def summary(self) -> dict:
        d = {"kind": "gauge", "value": _round(self.value), "n": self.n}
        if self.values:
            d["max"] = _round(max(self.values))
        return d


class Histogram:
    """Scalar sample distribution; keeps the raw samples (they are the
    p99 inputs the scheduler's stats need, and runs are short)."""

    __slots__ = ("name", "wall", "samples")

    def __init__(self, name: str, wall: bool = False):
        self.name = name
        self.wall = wall
        self.samples: list[float] = []

    def observe(self, v: Number) -> None:
        self.samples.append(float(v))

    @property
    def n(self) -> int:
        return len(self.samples)

    def percentile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        return float(np.percentile(np.asarray(self.samples), q))

    def summary(self) -> dict:
        if not self.samples:
            return {"kind": "histogram", "n": 0}
        a = np.asarray(self.samples)
        return {"kind": "histogram", "n": int(a.size),
                "mean": _round(a.mean()), "min": _round(a.min()),
                "max": _round(a.max()),
                "p50": _round(np.percentile(a, 50)),
                "p99": _round(np.percentile(a, 99))}


class Series:
    """Time-stamped vector samples — one np.ndarray (or scalar) per tick.

    The scheduler appends the per-link utilisation of one hierarchy
    level at every fleet mutation; percentiles are taken over the
    concatenation of all samples (every link at every tick weighted
    equally — the uniform-weighting contract of DESIGN.md §11).
    """

    __slots__ = ("name", "wall", "times", "values")

    def __init__(self, name: str, wall: bool = False):
        self.name = name
        self.wall = wall
        self.times: list[float] = []
        self.values: list[np.ndarray] = []

    def append(self, t: float, v) -> None:
        self.times.append(float(t))
        self.values.append(np.atleast_1d(np.asarray(v, dtype=np.float64)))

    @property
    def n(self) -> int:
        return len(self.values)

    def concat(self) -> np.ndarray:
        if not self.values:
            return np.zeros(0)
        return np.concatenate(self.values)

    def percentile(self, q: float) -> float:
        a = self.concat()
        return float(np.percentile(a, q)) if a.size else 0.0

    def summary(self) -> dict:
        if not self.values:
            return {"kind": "series", "n": 0}
        a = self.concat()
        return {"kind": "series", "n": len(self.values),
                "n_points": int(a.size), "mean": _round(a.mean()),
                "max": _round(a.max()),
                "p50": _round(np.percentile(a, 50)),
                "p99": _round(np.percentile(a, 99))}


class Metrics:
    """Flat name-keyed registry of the four instrument kinds.

    Accessors are get-or-create; asking for an existing name with a
    different kind raises (names are the schema). ``to_dict`` yields the
    flat metrics JSON merged into the ``BENCH_*.json`` artifacts —
    sorted names, summaries only, wall-derived instruments excluded
    unless ``include_wall``.
    """

    def __init__(self) -> None:
        self._instruments: dict[str, object] = {}

    def _get(self, cls, name: str, wall: bool):
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(name, wall=wall)
            self._instruments[name] = inst
        elif not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(inst).__name__}, not {cls.__name__}")
        return inst

    def counter(self, name: str, wall: bool = False) -> Counter:
        return self._get(Counter, name, wall)

    def gauge(self, name: str, wall: bool = False) -> Gauge:
        return self._get(Gauge, name, wall)

    def histogram(self, name: str, wall: bool = False) -> Histogram:
        return self._get(Histogram, name, wall)

    def series(self, name: str, wall: bool = False) -> Series:
        return self._get(Series, name, wall)

    def __contains__(self, name: str) -> bool:
        return name in self._instruments

    def __len__(self) -> int:
        return len(self._instruments)

    def names(self) -> list[str]:
        return sorted(self._instruments)

    def sample_counts(self) -> dict[str, int]:
        """Per-instrument record counts — the FleetStats metadata that
        tells a 3-sample p99 from a 3000-sample one."""
        return {name: self._instruments[name].n
                for name in sorted(self._instruments)}

    def to_dict(self, include_wall: bool = False) -> dict:
        return {name: inst.summary()
                for name, inst in sorted(self._instruments.items())
                if include_wall or not inst.wall}
