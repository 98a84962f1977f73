"""Deadline-based straggler mitigation (port of
``repro.runtime.straggler``).

Tracks a robust moving estimate of step time; steps exceeding
``deadline_factor`` x median are flagged.  The trainer's response is
backup-dispatch or skip-with-accumulation: a flagged microbatch's
gradient contribution is dropped this step and the accumulation count
raised next step, so the optimizer statistics stay unbiased.
"""
from __future__ import annotations

import collections
import statistics
from typing import Deque, Optional


class StragglerMitigator:
    def __init__(self, *, window: int = 32, deadline_factor: float = 2.0):
        self.window: Deque[float] = collections.deque(maxlen=window)
        self.deadline_factor = deadline_factor
        self.flagged = 0
        self.catchup_pending = 0

    def observe(self, step_time_s: float) -> bool:
        """Record a step time; returns True when it breached the deadline."""
        deadline = self.deadline()
        self.window.append(step_time_s)
        if deadline is not None and step_time_s > deadline:
            self.flagged += 1
            self.catchup_pending += 1
            return True
        return False

    def deadline(self) -> Optional[float]:
        if len(self.window) < 8:
            return None
        return statistics.median(self.window) * self.deadline_factor

    def take_catchup(self) -> int:
        """Microbatches to add to the next accumulation round."""
        n, self.catchup_pending = self.catchup_pending, 0
        return n
