"""Named phase timers (the reference's `JDsTimers`, CPU ontology
`JDsTimersCpu.h:28-85`, TmStart/TmStop/ShowTimes).

Counterpart of the ``Timers`` class of
`dualsphysics_multilayer_tpu/utils/timers.py`, on ``time.perf_counter``.
A timer reads the host clock: around device work it measures launches
unless the caller synchronises the device first.
"""

from __future__ import annotations

import time
from collections import defaultdict


class Timers:
    """Named accumulating wall timers (TmStart/TmStop/ShowTimes analog)."""

    def __init__(self):
        self.acc = defaultdict(float)
        self.counts = defaultdict(int)
        self._t0 = {}

    def start(self, name):
        self._t0[name] = time.perf_counter()

    def stop(self, name):
        dt = time.perf_counter() - self._t0.pop(name)
        self.acc[name] += dt
        self.counts[name] += 1
        return dt

    def table(self):
        total = sum(self.acc.values()) or 1.0
        rows = [f"{'Timer':<24}{'calls':>8}{'total_s':>12}{'%':>8}"]
        for k in sorted(self.acc, key=lambda k: -self.acc[k]):
            rows.append(f"{k:<24}{self.counts[k]:>8}{self.acc[k]:>12.4f}"
                        f"{100 * self.acc[k] / total:>8.1f}")
        return "\n".join(rows)
