"""The readers that the in-stream metrics share: the spans and counts that
the stream records in its `StageTimes` as it runs (`ctx.times`, the
window's). Each returns None where the run holds nothing to read: a
program whose StageTimes keeps no spans or counts, or, for a span timed
by CUDA events, a run off the card."""

from __future__ import annotations


def _method(ctx, name):
    return getattr(ctx.times, name, None)


def span_ms(ctx, name):
    """The mean length of the window's `name` spans, ms."""
    spans = _method(ctx, "spans")
    xs = spans(name) if callable(spans) else []
    return 1e3 * sum(s[1] - s[0] for s in xs) / len(xs) if xs else None


def starved_share(ctx):
    """The share of the time from the window's first step start to its
    last step end in which the device ran no step of the stream, %
    (`StageTimes.starved` over the `step` spans)."""
    starved = _method(ctx, "starved")
    st = starved() if callable(starved) else None
    return None if st is None else 100.0 * st["share"]


def query_use(ctx):
    """The back half's live queries over the query slots it matched, %
    (the counts `live_keypoints` and `query_slots`)."""
    counts = _method(ctx, "counts")
    c = counts() if callable(counts) else {}
    slots = c.get("query_slots")
    return 100.0 * c.get("live_keypoints", 0) / slots if slots else None
