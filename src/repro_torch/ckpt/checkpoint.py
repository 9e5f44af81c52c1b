"""The restart cost model the fleet scheduler prices recoveries with.

A copy of ``CheckpointCostModel`` from ``src/repro/ckpt/checkpoint.py``.
Saving and loading model state (``save_checkpoint`` / ``load_checkpoint``
/ ``CheckpointManager``) are not part of this package yet.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class CheckpointCostModel:
    """Prices a restart for the fleet scheduler (DESIGN.md §12).

    Progress is measured in *work seconds* (the honest clock's
    ``work_done * sim_finish``).  A killed job resumes from its last
    checkpoint publish — everything since is lost work — and re-reads its
    state through the NIC before making progress again, which the
    scheduler books as work debt (the same ledger migration stalls use).

    ``interval_s <= 0`` means continuous checkpointing: restarts lose
    nothing and only pay the restore traffic.
    """

    interval_s: float = 30.0

    def last_checkpoint(self, progress_s: float) -> float:
        """Progress position of the most recent checkpoint publish."""
        progress_s = max(progress_s, 0.0)
        if self.interval_s <= 0.0:
            return progress_s
        return math.floor(progress_s / self.interval_s) * self.interval_s

    def lost_work(self, progress_s: float) -> float:
        """Work seconds discarded by a restart at ``progress_s``."""
        return max(progress_s, 0.0) - self.last_checkpoint(progress_s)

    def restore_seconds(self, state_bytes: float, nic_bw: float) -> float:
        """Restore stall: re-reading state, priced through the NIC."""
        if nic_bw <= 0.0:
            return 0.0
        return float(state_bytes) / float(nic_bw)
