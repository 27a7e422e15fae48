"""The readers that the per-layer metrics share. Each metric file in this
folder exposes `read(ctx)`, the metric's value or None where the run
holds nothing to read it from; `ctx` is `run.Context`."""

from __future__ import annotations

from apds_bench import roofline


def dispatch_ms(ctx):
    """The stream's `dispatch` stage (StageTimes): mean ms a batch."""
    xs = ctx.times.values("dispatch")
    return 1e3 * sum(xs) / len(xs) if xs else None


def front_ms(ctx):
    """The front half and the ladder of one batch at the cell's shape
    (`detect_and_compute_batch`), CUDA events over back-to-back calls."""
    return ctx.cuda_ms(ctx.front_call())


def back_half_ms(ctx):
    """The back half of one batch at the cell's shape, on the features of
    the cell's frames, CUDA events over back-to-back calls."""
    return ctx.cuda_ms(ctx.back_call())


def knn2_roofline(ctx):
    """Kernel 4 alone at the cell's Q (batch × capacity) and M (the DB's
    rows): the least time an H100 could take over the time it took, %."""
    k = ctx.knn2_call()
    if k is None:
        return None
    fn, q, m = k
    ms = ctx.cuda_ms(fn)
    if ms is None:
        return None
    bound_s, _ = roofline.knn2_bound_s(q, m)
    return 100.0 * bound_s * 1e3 / ms


def idle_share(ctx):
    """The device's idle share of the traced stretch, %."""
    s = ctx.stretch
    if s is None or s.busy_s <= 0 or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
