"""The open loop's schedule and the window arithmetic, apart from any
program so that the tests can drive them with a fake clock."""

from __future__ import annotations

import math
import time


class OpenLoop:
    """Request ``i`` of ``n`` is due ``i / rate`` seconds after ``t_open``,
    whatever the consumer does.  Iterating yields each index no earlier than
    its due time (sleeping until then when the consumer asks early) and
    records when it was handed over; ``late`` is the largest delay of a
    hand-over past both its due time and the consumer's request: the
    generator's own lateness, not the system's."""

    def __init__(self, n: int, rate: float, t_open: float, clock=time.perf_counter, sleep=time.sleep):
        self.due = [t_open + i / rate for i in range(n)]
        self.handed: list[float] = []
        self.late = 0.0
        self.clock, self.sleep = clock, sleep

    def __iter__(self):
        for i, due in enumerate(self.due):
            asked = self.clock()
            if asked < due:
                self.sleep(due - asked)
            now = self.clock()
            self.late = max(self.late, now - max(due, asked))
            self.handed.append(now)
            yield i


def latencies(due: list[float], finish: list[float], t_close: float) -> list[float]:
    """Each request's latency from its due time to its result, or to the
    window's end ``t_close`` when it had none by then (results in order:
    ``finish[i]`` is request ``i``'s)."""
    return [min(finish[i] if i < len(finish) else math.inf, t_close) - d for i, d in enumerate(due)]
