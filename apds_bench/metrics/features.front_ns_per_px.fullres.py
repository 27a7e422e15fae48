"""The front half's device time a frame pixel, ns: the window's `front`
spans summed over its `front_pixels` count (B·H·W a batch, padded rows
included; StageTimes). None where either is missing: off the card, or in
a program that records neither."""

from apds_bench.metrics._spans import _method


def read(ctx):
    spans, counts = _method(ctx, "spans"), _method(ctx, "counts")
    xs = spans("front") if callable(spans) else []
    pixels = (counts() if callable(counts) else {}).get("front_pixels")
    if not xs or not pixels:
        return None
    return 1e9 * sum(s[1] - s[0] for s in xs) / pixels
