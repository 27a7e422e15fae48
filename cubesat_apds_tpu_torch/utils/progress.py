"""Terminal progress reporting — the indicatif equivalent (a copy of
utils/progress.py; host only).

The reference renders one ProgressBar per LoD under a MultiProgress and
ticks per tile (preprocessor main.rs:178-181, 221-224, 326). Same shape
here, dependency-free.
"""

from __future__ import annotations

import sys
import time
from typing import Optional, TextIO


class ProgressBar:
    def __init__(self, total: int, label: str = "", width: int = 40,
                 stream: Optional[TextIO] = None, quiet: bool = False):
        self.total = max(total, 1)
        self.label = label
        self.width = width
        self.n = 0
        self.stream = stream or sys.stderr
        self.quiet = quiet
        self._t0 = time.perf_counter()
        self._last_render = 0.0

    def inc(self, k: int = 1):
        self.n = min(self.n + k, self.total)
        now = time.perf_counter()
        if not self.quiet and (now - self._last_render > 0.1
                               or self.n == self.total):
            self._render(now)
            self._last_render = now

    def _render(self, now: float):
        frac = self.n / self.total
        filled = int(frac * self.width)
        bar = "#" * filled + "-" * (self.width - filled)
        rate = self.n / max(now - self._t0, 1e-9)
        self.stream.write(
            f"\r{self.label} [{bar}] {self.n}/{self.total} "
            f"({rate:.1f}/s)")
        if self.n == self.total:
            self.stream.write("\n")
        self.stream.flush()

    def finish(self):
        self.n = self.total
        if not self.quiet:
            self._render(time.perf_counter())


class MultiProgress:
    """Sequential multi-bar manager (one live bar at a time, like the
    per-LoD bars of the reference)."""

    def __init__(self, quiet: bool = False):
        self.quiet = quiet
        self.bars = []

    def add(self, total: int, label: str = "") -> ProgressBar:
        bar = ProgressBar(total, label, quiet=self.quiet)
        self.bars.append(bar)
        return bar
