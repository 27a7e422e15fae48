"""The front half's device time a batch as the stream ran it, ms: CUDA
events from the step's start (after its waits on the uploads) to the
return of `detect_and_compute_batch` inside the step (StageTimes `front`;
none off the card, on the mesh path, or in a program that records no
`front` span)."""

from apds_bench.metrics._spans import span_ms


def read(ctx):
    return span_ms(ctx, "front")
