"""Closed loop: the whole backlog is waiting (a downlinked pass), so the
next frame is handed over as soon as the stream takes it. The loop stops
at the first batch boundary past the window's end, so every batch is
full; no frame is due at a time of its own."""

from __future__ import annotations

import time


class Loop:
    def __init__(self, traffic: dict, pool, seconds: float):
        self.pool = pool
        self.seconds = float(seconds)
        self.batch = int(traffic["batch"])
        self.t0 = None
        self.handed: list = []

    def start(self, t0: float):
        self.t0 = t0

    def due(self, i: int):
        """The frame's due time: None in a closed loop."""
        return None

    def frames(self):
        end = self.t0 + self.seconds
        i = 0
        while i % self.batch or time.perf_counter() < end:
            self.handed.append(time.perf_counter())
            yield self.pool[i % len(self.pool)]
            i += 1
