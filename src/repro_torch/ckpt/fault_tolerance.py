"""Fault tolerance: heartbeats, elastic re-meshing, straggler tracking.

On a real fleet these hook into the cluster control plane; here the same
logic runs against simulated host events so the *policies* are testable:

* :class:`HeartbeatMonitor` — per-host liveness with a deadline; a missed
  heartbeat marks the host (and its chips) dead.
* :class:`ElasticReMesher` — given the surviving chips, shrinks the data
  axis to the largest supported size, REORDERS the surviving devices with
  the paper's mapping algorithm (the degraded cluster is just a new CTG —
  this is where the paper's technique powers elasticity), and returns the
  new mesh. Training restores the last checkpoint onto it.
* :class:`StragglerTracker` — EWMA of step times; a step slower than
  ``k`` x the EWMA flags the slowest host for replacement — on accelerator fleets
  stragglers are usually a sick host, not transient load.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# Heartbeats
# ---------------------------------------------------------------------------
class HeartbeatMonitor:
    """Per-host liveness registry.

    ``clock`` defaults to wall-clock ``time.monotonic`` for production
    use; deterministic consumers — the fleet scheduler's failure engine —
    MUST inject their own clock (sim time) so ``last_seen`` and anything
    derived from it in trace dumps is byte-identical across seeded runs.

    ``beat`` on a dead host refreshes ``last_seen`` but does not revive:
    resurrection is a control-plane decision (:meth:`revive`), not an
    accidental side effect of a late packet.
    """

    def __init__(self, n_hosts: int, deadline_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.n_hosts = n_hosts
        self.deadline = deadline_s
        self.clock = clock
        now = clock()
        self.last_seen = np.full(n_hosts, now, dtype=float)
        self.alive = np.ones(n_hosts, dtype=bool)

    def beat(self, host: int) -> None:
        self.last_seen[host] = self.clock()

    def mark_dead(self, host: int) -> None:
        self.alive[host] = False

    def revive(self, host: int) -> None:
        """Bring a repaired host back: alive, with a fresh heartbeat."""
        self.alive[host] = True
        self.last_seen[host] = self.clock()

    def sweep(self) -> list[int]:
        """Returns hosts newly declared dead."""
        now = self.clock()
        newly = []
        for h in range(self.n_hosts):
            if self.alive[h] and now - self.last_seen[h] > self.deadline:
                self.alive[h] = False
                newly.append(h)
        return newly

    def alive_hosts(self) -> list[int]:
        return [h for h in range(self.n_hosts) if self.alive[h]]


# ---------------------------------------------------------------------------
# Elastic re-meshing
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ReMeshResult:
    data_size: int
    model_size: int
    device_order: np.ndarray       # indices into the surviving-device list
    dropped_chips: int


class ElasticReMesher:
    """Shrink the data axis to fit surviving chips; keep the model axis.

    Model-parallel groups must stay complete (a TP group straddling a dead
    host is unusable), so the unit of elasticity is one data slice =
    ``model_size`` chips. Surviving chips are re-ordered so each TP group
    is topologically compact — delegated to the paper's mapper when a
    planner is supplied.
    """

    def __init__(self, model_size: int, chips_per_host: int = 8,
                 planner: Optional[Callable[[np.ndarray], np.ndarray]] = None):
        self.model_size = model_size
        self.chips_per_host = chips_per_host
        self.planner = planner

    def replan(self, alive_hosts: Sequence[int]) -> ReMeshResult:
        chips = np.concatenate([
            np.arange(h * self.chips_per_host, (h + 1) * self.chips_per_host)
            for h in sorted(alive_hosts)]) if alive_hosts else np.array([], int)
        n = chips.size
        data = n // self.model_size
        # largest power-of-two data axis (keeps batch divisibility simple),
        # written as 2**floor(log2(data)) — the old ``data &= data - 1``
        # loop computed the same value but hid that every non-power-of-two
        # remainder slice is dropped on the floor
        data = (1 << (data.bit_length() - 1)) if data > 0 else 0
        usable = data * self.model_size
        order = np.arange(usable)
        if self.planner is not None and usable:
            planned = np.asarray(self.planner(chips[:usable]))
            if not np.array_equal(np.sort(planned), np.sort(chips[:usable])):
                raise ValueError("planner must return a permutation of the "
                                 "chip ids it was given")
            # the planner speaks global chip ids (it sees the degraded
            # cluster), but device_order is defined as indices into the
            # surviving-device list — translate back.  ``chips`` is sorted
            # ascending, so searchsorted inverts the id -> index map.
            order = np.searchsorted(chips, planned)
        return ReMeshResult(data_size=int(data), model_size=self.model_size,
                            device_order=order,
                            dropped_chips=int(n - usable))


# ---------------------------------------------------------------------------
# Stragglers
# ---------------------------------------------------------------------------
class StragglerTracker:
    def __init__(self, slow_factor: float = 2.0, ewma: float = 0.9):
        self.slow_factor = slow_factor
        self.ewma_w = ewma
        self.ewma: Optional[float] = None
        self.flagged_steps: list[int] = []

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler event."""
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = dt > self.slow_factor * self.ewma
        # stragglers don't poison the baseline estimate
        if not slow:
            self.ewma = self.ewma_w * self.ewma + (1 - self.ewma_w) * dt
        else:
            self.flagged_steps.append(step)
        return slow
