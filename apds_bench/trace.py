"""The traced stretch of a `--trace 1` run: `torch.profiler` over a short
steady part of the window, reduced to the device's busy time, its idle
share, the device operations that took most time and the longest idle
gaps by what the host was doing."""

from __future__ import annotations

import dataclasses

import torch

TOP = 10


@dataclasses.dataclass
class Stretch:
    window_s: float          # the profiled stretch, host clock
    busy_s: float            # union of device intervals
    device_events: int       # kernels, copies and memsets on the device
    batches: int             # stream batches dispatched in the stretch
    device_ops: list         # [[name, seconds]], most time first
    idle_gaps: list          # [[host activity, seconds]], longest first


def profiler():
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def warm_profiler() -> None:
    """Start and stop the profiler once, so that its first start (CUPTI's
    set-up) falls in set-up and not in the window."""
    with profiler():
        torch.ones(1, device="cuda" if torch.cuda.is_available() else "cpu")


def _union(intervals) -> tuple:
    """(total covered, gaps [(start, end)]) of sorted (start, end)."""
    total, gaps, cur_s, cur_e = 0, [], None, None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            total += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def reduce(prof, window_s: float, batches: int) -> Stretch:
    """The stretch's numbers from the profiler's raw events."""
    events = prof.profiler.kineto_results.events()
    dev, host, by_name = [], [], {}
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((s, s + d))
            by_name[e.name()] = by_name.get(e.name(), 0) + d
        elif not getattr(e, "is_python_function", lambda: False)():
            host.append((s, s + d, e.name()))
    if host:                   # the stretch, on the host's clock
        lo = min(h[0] for h in host)
        hi = lo + int(window_s * 1e9)
        dev = [(max(s, lo), min(e, hi)) for s, e in dev if e > lo and s < hi]
    busy_ns, gaps = _union(dev)
    labelled = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        mid = (g0 + g1) // 2
        cover = [h for h in host if h[0] <= mid <= h[1]]
        name = min(cover, key=lambda h: h[1] - h[0])[2] if cover else "none"
        labelled.append([name, (g1 - g0) / 1e9])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return Stretch(window_s=window_s, busy_s=busy_ns / 1e9,
                   device_events=len(dev), batches=batches,
                   device_ops=[[k, v / 1e9] for k, v in ops],
                   idle_gaps=labelled)
