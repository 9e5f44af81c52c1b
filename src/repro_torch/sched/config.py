"""Scheduler configuration dataclasses (DESIGN.md §15).

``FleetScheduler.__init__`` had grown to 23 flat keyword arguments; this
module groups them by owning subsystem (DESIGN.md §14) into frozen
dataclasses composed into one :class:`SchedulerConfig`:

    cfg = SchedulerConfig(
        remap=RemapConfig(interval=5.0, budget=64),
        admission=AdmissionConfig(window=3.0),
    )
    sched = FleetScheduler(cluster, "new", config=cfg)

Every sub-config defaults to the historical flat-kwarg defaults, so
``SchedulerConfig()`` is exactly the old no-argument constructor. The
flat kwargs still work through :meth:`SchedulerConfig.from_legacy` (the
facade shims them with a ``DeprecationWarning``; removal is noted in
DESIGN.md §15).

Frozen on purpose: a config is a *recipe*, shareable across schedulers
and safe to hash into experiment manifests. The facade still copies the
values onto plain mutable attributes (``sched.remap_interval = 5.0``
mid-run remains supported — several tests steer the scheduler that way).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

from ..ckpt.checkpoint import CheckpointCostModel

MB = 1 << 20


@dataclasses.dataclass(frozen=True)
class RemapConfig:
    """RemapEngine knobs (DESIGN.md §9/§10)."""

    interval: Optional[float] = None      # was remap_interval
    util_threshold: float = 0.75
    migration_cost_factor: float = 1.0
    max_migrations_per_job: int = 1
    candidates: int = 4                   # was remap_candidates
    budget: Optional[int] = None          # was remap_budget
    population: int = 16                  # was remap_population
    rng_seed: int = 0                     # was remap_rng_seed


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """AdmissionController knobs (DESIGN.md §8)."""

    window: float = 0.0                   # was admission_window
    k: int = 24                           # was admission_k
    lookahead: int = 8                    # was admission_lookahead
    rng_seed: int = 0                     # was admission_rng_seed


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """RecoveryEngine knobs (DESIGN.md §12)."""

    failure_policy: str = "requeue"
    drain_policy: str = "proactive"
    ckpt_model: Optional[CheckpointCostModel] = None
    elastic_model_size: int = 1


@dataclasses.dataclass(frozen=True)
class CellConfig:
    """CellFabric knobs (DESIGN.md §13)."""

    cells: Union[int, str] = 1
    cross_cell_migration: bool = True


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """AutoscaleEngine knobs — the serving closed loop (DESIGN.md §15).

    Off by default (``enabled=False``): a default-config scheduler runs
    the historical batch path byte-identically. ``slos`` is the tuple of
    :class:`repro_torch.serve.fleet.ModelSLO` the loop optimises for; ``actions``
    gates structural scale-up/-down (routing-weight refresh alone when
    False — the "static replicas" baseline leg of slo_bench); ``routing``
    is ``"capacity"`` (placement-aware) or ``"uniform"``.
    """

    enabled: bool = False
    actions: bool = True
    routing: str = "capacity"
    slos: tuple = ()
    min_replicas: int = 1
    max_replicas: int = 4
    scale_down_margin: float = 0.5
    lookahead_s: float = 30.0


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Complete FleetScheduler configuration, grouped by subsystem."""

    remap: RemapConfig = dataclasses.field(default_factory=RemapConfig)
    admission: AdmissionConfig = dataclasses.field(
        default_factory=AdmissionConfig)
    recovery: RecoveryConfig = dataclasses.field(
        default_factory=RecoveryConfig)
    cells: CellConfig = dataclasses.field(default_factory=CellConfig)
    autoscale: AutoscaleConfig = dataclasses.field(
        default_factory=AutoscaleConfig)
    # facade-owned scalars (shared by every subsystem)
    state_bytes_per_proc: float = 64 * MB
    count_scale: float = 0.02
    sim_backend: str = "auto"
    reclock: bool = True

    @classmethod
    def from_legacy(cls, **kw) -> "SchedulerConfig":
        """Build a config from the historical flat kwargs.

        Raises ``TypeError`` on unknown names, mirroring what the old
        constructor signature did. Used by the facade's deprecation shim
        and by callers migrating stored flat-kwarg dicts.
        """
        unknown = sorted(set(kw) - set(LEGACY_KWARGS))
        if unknown:
            raise TypeError(
                f"unknown FleetScheduler kwargs {unknown}; "
                f"known legacy kwargs: {sorted(LEGACY_KWARGS)}")
        groups: dict = {}
        top: dict = {}
        for name, value in kw.items():
            section, field = LEGACY_KWARGS[name]
            if section is None:
                top[field] = value
            else:
                groups.setdefault(section, {})[field] = value
        sections = {"remap": RemapConfig, "admission": AdmissionConfig,
                    "recovery": RecoveryConfig, "cells": CellConfig,
                    "autoscale": AutoscaleConfig}
        return cls(**{s: klass(**groups.get(s, {}))
                      for s, klass in sections.items()}, **top)


# flat kwarg -> (sub-config section | None for facade scalars, field name)
LEGACY_KWARGS: dict = {
    "remap_interval": ("remap", "interval"),
    "util_threshold": ("remap", "util_threshold"),
    "migration_cost_factor": ("remap", "migration_cost_factor"),
    "max_migrations_per_job": ("remap", "max_migrations_per_job"),
    "remap_candidates": ("remap", "candidates"),
    "remap_budget": ("remap", "budget"),
    "remap_population": ("remap", "population"),
    "remap_rng_seed": ("remap", "rng_seed"),
    "admission_window": ("admission", "window"),
    "admission_k": ("admission", "k"),
    "admission_lookahead": ("admission", "lookahead"),
    "admission_rng_seed": ("admission", "rng_seed"),
    "failure_policy": ("recovery", "failure_policy"),
    "drain_policy": ("recovery", "drain_policy"),
    "ckpt_model": ("recovery", "ckpt_model"),
    "elastic_model_size": ("recovery", "elastic_model_size"),
    "cells": ("cells", "cells"),
    "cross_cell_migration": ("cells", "cross_cell_migration"),
    "state_bytes_per_proc": (None, "state_bytes_per_proc"),
    "count_scale": (None, "count_scale"),
    "sim_backend": (None, "sim_backend"),
    "reclock": (None, "reclock"),
}
