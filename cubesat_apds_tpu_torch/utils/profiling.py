"""Stage timers, spans and counts, and a device trace (port of
utils/profiling.py).

`StageTimes` collects, on the `time.perf_counter` clock, wall-clock
samples per named stage for the stream's cadence report (same report
format as the JAX package's), spans (name, start, end, id, parent id),
CUDA-event spans placed on that clock through a host anchor
(`host_anchor`, `clock_drift_us`), and counts; from the spans it works
out the share of time a device waited on the host (`starved`).
`time_jitted` (the JAX package's name and arguments) times a call on
any device by the host clock, and `device_trace` records a
torch.profiler trace (CPU and CUDA activity) into a Chrome trace file.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from collections import defaultdict
from typing import Dict, List, Optional

# What a consumer thread can be doing while a device waits on it (the
# stream's `frames`, `dispatch`, `device_wait` and `yielded` spans).
CONSUMER_STATES = ("frames", "dispatch", "device_wait", "yielded")


class StageTimes:
    """Accumulates wall-clock samples per named stage, spans and counts.

    A span is (start, end, id, parent id) under a name, in seconds on the
    `time.perf_counter` clock; the id and parent tie, say, a frame's spans
    to the batch that carried it. A stage recorded by `stage` keeps its
    interval as a span of the same name besides its sample.
    """

    def __init__(self):
        self._samples: Dict[str, List[float]] = defaultdict(list)
        self._spans: Dict[str, List[tuple]] = defaultdict(list)
        self._counts: Dict[str, int] = defaultdict(int)

    def add(self, stage: str, seconds: float):
        self._samples[stage].append(seconds)

    def stage(self, stage: str, start: float, end: float):
        """A stage sample of end - start that keeps its interval too."""
        self._samples[stage].append(end - start)
        self._spans[stage].append((start, end, None, None))

    def span(self, name: str, start: float, end: float, id=None,
             parent=None):
        self._spans[name].append((start, end, id, parent))

    def device_span(self, name: str, anchor, start, end, id=None,
                    parent=None) -> float:
        """A span between two CUDA events (`enable_timing=True`) recorded
        on the stream of `anchor` (`host_anchor`'s (event, host seconds)),
        placed on the host clock: it starts at the anchor's host time plus
        the time from the anchor's event to `start`, and lasts the time
        from `start` to `end`. Call it only once `end` has completed (after
        an event queued behind it has), so that nothing waits.
        Returns the span's end on the host clock."""
        ev, t = anchor
        t0 = t + ev.elapsed_time(start) / 1e3
        t1 = t0 + start.elapsed_time(end) / 1e3
        self.span(name, t0, t1, id, parent)
        return t1

    def count(self, name: str, n: int = 1):
        self._counts[name] += int(n)

    def values(self, stage: str) -> List[float]:
        """Raw samples for one stage ([] if never recorded)."""
        return list(self._samples.get(stage, []))

    def spans(self, name: str) -> List[tuple]:
        """The (start, end, id, parent) spans of one name, in the order
        recorded ([] if never recorded)."""
        return list(self._spans.get(name, []))

    def counts(self) -> Dict[str, int]:
        return dict(self._counts)

    def starved(self) -> Optional[dict]:
        """How long the device waited on the host, from the `step` spans
        (the device's work, as the host queued it): over the time from
        the first step's start to the last one's end (`window_s`), their
        union (`busy_s`), the share of the window outside it (`share`),
        and the seconds of those gaps that each of CONSUMER_STATES (spans
        of the thread that feeds the device) overlaps (`split`; the rest
        is `other`). None without `step` spans."""
        merged = _union(self._spans.get("step", ()))
        if not merged:
            return None
        window = merged[-1][1] - merged[0][0]
        busy_s = sum(e - s for s, e in merged)
        gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
        split = {name: _overlap(gaps, _union(self._spans.get(name, ())))
                 for name in CONSUMER_STATES}
        split["other"] = window - busy_s - sum(split.values())
        return {"window_s": window, "busy_s": busy_s,
                "share": 1.0 - busy_s / window if window > 0 else 0.0,
                "split": split}

    @contextlib.contextmanager
    def measure(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(stage, time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {stage: _stats(xs) for stage, xs in self._samples.items()}

    def report(self) -> str:
        """The stage table; then the spans that are no stage, the
        device's starved share and its split, the `front` spans' mean and
        their share of the `step` spans' time, the stream's batches read
        back early (`readback_early`) as a share of its `dispatch`
        samples, and the counts."""
        lines = [f"{'stage':20s} {'count':>6s} {'mean':>9s} {'median':>9s} "
                 f"{'max':>9s}"]
        rows = sorted(self.summary().items())
        rows += sorted((f"{name} (span)", _stats([e - s for s, e, _, _ in xs]))
                       for name, xs in self._spans.items()
                       if xs and name not in self._samples)
        for stage, s in rows:
            lines.append(
                f"{stage:20s} {s['count']:6d} {s['mean_ms']:8.2f}m "
                f"{s['median_ms']:8.2f}m {s['max_ms']:8.2f}m")
        st = self.starved()
        if st is not None:
            split = ", ".join(f"{k} {100 * v / st['window_s']:.2f}%"
                              for k, v in st["split"].items())
            lines.append(f"device starved {100 * st['share']:.2f}% of "
                         f"{st['window_s']:.3f} s: {split}")
        front = [e - s for s, e, _, _ in self._spans.get("front", ())]
        step_s = sum(e - s for s, e, _, _ in self._spans.get("step", ()))
        if front and step_s > 0:
            lines.append(f"front half {1e3 * statistics.fmean(front):.2f} ms "
                         f"a step, {100 * sum(front) / step_s:.2f}% of the "
                         f"step time")
        batches = len(self._samples.get("dispatch", ()))
        if batches:
            early = self._counts.get("readback_early", 0)
            lines.append(f"read back early: {early} of {batches} batches "
                         f"({100 * early / batches:.2f}%)")
        if self._counts:
            lines.append("counts: " + ", ".join(
                f"{k} {v}" for k, v in sorted(self._counts.items())))
        return "\n".join(lines)


def _stats(xs) -> Dict[str, float]:
    return {"count": len(xs), "mean_ms": 1e3 * statistics.fmean(xs),
            "median_ms": 1e3 * statistics.median(xs),
            "max_ms": 1e3 * max(xs), "total_s": sum(xs)}


def _union(spans) -> List[tuple]:
    """The union of spans (their first two fields) as sorted, disjoint
    (start, end) intervals."""
    out: List[list] = []
    for s, e in sorted((sp[0], sp[1]) for sp in spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def _overlap(a, b) -> float:
    """Seconds that two lists of sorted, disjoint intervals share."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def host_anchor(device):
    """Wait for `device` once, then record a timing event on its current
    stream and note the host time: the (event, perf_counter seconds) pair
    by which `StageTimes.device_span` places that stream's events on the
    host clock."""
    import torch

    torch.cuda.synchronize(device)
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev, time.perf_counter()


def clock_drift_us(anchor, device) -> float:
    """Close `anchor` with a second one taken the same way: the host time
    that `anchor` gives the closing event less the host time noted at it,
    in microseconds."""
    close, t = host_anchor(device)
    close.synchronize()
    ev, t0 = anchor
    return (t0 + ev.elapsed_time(close) / 1e3 - t) * 1e6


@contextlib.contextmanager
def device_trace(log_dir: str, name: str = "trace"):
    """Record CPU and CUDA activity with torch.profiler; on exit write
    `<log_dir>/<name>.json` (Chrome trace format). Yields the profiler,
    whose key_averages() and events() the caller may read."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))


def _wait_for(out) -> None:
    """Wait for the cards that hold the tensors of `out` (a tensor, or a
    tuple or tensor dataclass of them, nested) to finish their work."""
    import torch

    from cubesat_apds_tpu_torch.core.types import _map_tensors

    cards = set()
    _map_tensors(out, lambda t: cards.add(t.device)
                 if t.device.type == "cuda" else None)
    for dev in cards:
        torch.cuda.synchronize(dev)


def time_jitted(fn, *args, iters: int = 20, warmup: int = 1) -> float:
    """Steady-state seconds per call of fn(*args) by the host clock,
    waiting for the result's devices after the warm-up calls and after
    the timed ones (the JAX package's time_jitted, which blocks on the
    result's leaves)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _wait_for(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _wait_for(out)
    return (time.perf_counter() - t0) / iters
