"""Event machinery for the online fleet scheduler.

A deliberately tiny discrete-event core: eight event kinds pushed onto a
single time-ordered heap. Ties are broken by a monotonically increasing
sequence number, then by kind priority so that at equal timestamps the
topology settles first (failures, then recoveries), departures free
cores *before* arrivals try to claim them, drains mark nodes
unschedulable before same-instant arrivals, admission-window closes
observe every same-instant arrival (joint batches never miss the
arrival that opened them), and remap passes observe a settled fleet.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Optional

ARRIVAL = "arrival"
DEPARTURE = "departure"
REMAP = "remap"
NODE_FAIL = "node_fail"
NODE_RECOVER = "node_recover"
DRAIN = "drain"
ADMIT = "admit"          # admission-window close: place the batch jointly
TRAFFIC = "traffic"      # serving traffic-epoch tick (autoscale loop)

# at equal timestamps: settle the topology (fail, then recover), release
# cores, mark draining nodes unschedulable, then admit, then account the
# traffic epoch, then consider remapping.  NODE_FAIL before DEPARTURE
# means a job departing at the exact failure instant is killed, not
# credited — the conservative tie.  ADMIT after ARRIVAL so a window
# closing exactly when a job arrives still sees that job in the batch.
# TRAFFIC after ADMIT so the autoscale tick observes a settled fleet,
# and before REMAP so any replica it adds is visible to the remap pass.
_KIND_PRIORITY = {NODE_FAIL: 0, NODE_RECOVER: 1, DEPARTURE: 2,
                  DRAIN: 3, ARRIVAL: 4, ADMIT: 5, TRAFFIC: 6, REMAP: 7}


@dataclasses.dataclass(frozen=True)
class Event:
    time: float
    kind: str            # ARRIVAL | DEPARTURE | REMAP | NODE_FAIL | NODE_RECOVER | DRAIN
    job_id: int = -1     # -1 for REMAP ticks and node events
    epoch: int = 0       # departure re-key generation (DESIGN.md §3)
    # ^ every re-clock that moves a job's departure bumps the job's epoch
    #   and pushes a fresh event; superseded events stay in the heap and
    #   are discarded lazily when their epoch no longer matches the job's.
    #   This replaces the old float-equality stale check, which broke as
    #   soon as a departure was re-derived rather than copied bit-for-bit.
    node: int = -1       # NODE_FAIL / NODE_RECOVER / DRAIN target
    deadline: float = 0.0  # DRAIN only: hard-kill time; an event whose
    #   time == deadline is the deadline enforcement tick itself

    def sort_key(self, seq: int) -> tuple:
        return (self.time, _KIND_PRIORITY[self.kind], seq)

    def describe(self) -> str:
        """Compact one-line rendering for traces and flight dumps."""
        if self.kind in (REMAP, ADMIT):
            return f"t={self.time:g} {self.kind}"
        if self.kind == TRAFFIC:
            return f"t={self.time:g} traffic epoch={self.epoch}"
        if self.kind in (NODE_FAIL, NODE_RECOVER):
            return f"t={self.time:g} {self.kind} node={self.node}"
        if self.kind == DRAIN:
            return (f"t={self.time:g} drain node={self.node}"
                    f" deadline={self.deadline:g}")
        tail = f" epoch={self.epoch}" if self.kind == DEPARTURE else ""
        return f"t={self.time:g} {self.kind} job={self.job_id}{tail}"


def stale_event(event_epoch: int, live_epoch: Optional[int]) -> bool:
    """THE staleness rule for lazily-invalidated event streams (§3).

    Re-keying never removes a superseded event from the heap: it bumps
    the target's generation and pushes a fresh event, leaving the old
    one to be discarded here when popped. An event is stale when its
    target is gone (``live_epoch is None``) or the generations no
    longer match. Both epoch streams route through this one predicate:

    * **departures** pass the job's ``epoch`` (``None`` once the job
      left the live set) — re-clocks and remap commits bump it;
    * **drain-deadline ticks** pass the node's drain generation
      (``None`` once the drain was cancelled by a failure/recover or
      already enforced) — every new drain window bumps it.
    """
    return live_epoch is None or event_epoch != live_epoch


class EventQueue:
    """Min-heap of events ordered by (time, kind priority, insertion seq).

    Per-kind counts are maintained on push/pop so :meth:`count` is O(1) —
    the failure-policy code polls pending-departure counts every event,
    which made the old O(n) heap scan quadratic over a run.  Stale
    (superseded-epoch) departures are counted until popped, exactly
    matching the semantics of the scan it replaces.
    """

    def __init__(self) -> None:
        self._heap: list[tuple[tuple, Event]] = []
        self._seq = itertools.count()
        self._counts: dict[str, int] = {}

    def push(self, event: Event) -> None:
        heapq.heappush(self._heap, (event.sort_key(next(self._seq)), event))
        self._counts[event.kind] = self._counts.get(event.kind, 0) + 1

    def pop(self) -> Event:
        event = heapq.heappop(self._heap)[1]
        self._counts[event.kind] -= 1
        return event

    def peek(self) -> Optional[Event]:
        return self._heap[0][1] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def count(self, kind: str) -> int:
        return self._counts.get(kind, 0)
