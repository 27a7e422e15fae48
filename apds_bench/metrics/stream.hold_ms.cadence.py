"""A finished result's hold in the stream, ms: from its batch's step end
(CUDA events on the host clock) to the frame's yield (StageTimes `hold`)."""

from apds_bench.metrics._spans import span_ms


def read(ctx):
    return span_ms(ctx, "hold")
