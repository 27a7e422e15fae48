"""Open loop with periodic arrivals (a camera's fixed cadence): frame i
is due at t0 + i / rate_fps, for every i due inside the window, and is
handed to the stream no earlier than that, whether or not the stream has
caught up. Latency runs from the due time."""

from __future__ import annotations

import math
import time


class Loop:
    def __init__(self, traffic: dict, pool, seconds: float):
        self.pool = pool
        self.rate = float(traffic["rate_fps"])
        self.n_due = int(math.ceil(float(seconds) * self.rate))
        self.t0 = None
        self.handed: list = []

    def start(self, t0: float):
        self.t0 = t0

    def due(self, i: int):
        return self.t0 + i / self.rate

    def frames(self):
        for i in range(self.n_due):
            wait = self.due(i) - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            self.handed.append(time.perf_counter())
            yield self.pool[i % len(self.pool)]
