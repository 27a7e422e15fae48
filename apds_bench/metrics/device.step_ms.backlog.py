"""The step's device time a batch as the stream ran it, ms: CUDA events
from after its waits on the uploads to after its packed outputs
(StageTimes `step`; none off the card)."""

from apds_bench.metrics._spans import span_ms


def read(ctx):
    return span_ms(ctx, "step")
