"""Stage timers, a CUDA-event timer and a device trace (port of
utils/profiling.py).

`StageTimes` collects wall-clock samples per named stage for the stream's
cadence report (same report format as the JAX package's). `time_cuda`
times a call on the card with CUDA events, `time_jitted` (the JAX
package's name and arguments) a call on any device by the host clock,
and `device_trace` records a torch.profiler trace (CPU and CUDA
activity) into a Chrome trace file.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from collections import defaultdict
from typing import Dict, List


class StageTimes:
    """Accumulates wall-clock samples per named stage."""

    def __init__(self):
        self._samples: Dict[str, List[float]] = defaultdict(list)

    def add(self, stage: str, seconds: float):
        self._samples[stage].append(seconds)

    def values(self, stage: str) -> List[float]:
        """Raw samples for one stage ([] if never recorded)."""
        return list(self._samples.get(stage, []))

    @contextlib.contextmanager
    def measure(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(stage, time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for stage, xs in self._samples.items():
            out[stage] = {
                "count": len(xs),
                "mean_ms": 1e3 * statistics.fmean(xs),
                "median_ms": 1e3 * statistics.median(xs),
                "max_ms": 1e3 * max(xs),
                "total_s": sum(xs),
            }
        return out

    def report(self) -> str:
        lines = [f"{'stage':20s} {'count':>6s} {'mean':>9s} {'median':>9s} "
                 f"{'max':>9s}"]
        for stage, s in sorted(self.summary().items()):
            lines.append(
                f"{stage:20s} {s['count']:6d} {s['mean_ms']:8.2f}m "
                f"{s['median_ms']:8.2f}m {s['max_ms']:8.2f}m")
        return "\n".join(lines)


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


def time_cuda(fn, *args, iters: int = 20, warmup: int = 1) -> float:
    """Seconds per call of fn(*args) on the card: CUDA events around
    `iters` back-to-back calls after `warmup` calls. Raises without a
    card."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("time_cuda needs a CUDA device")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


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
