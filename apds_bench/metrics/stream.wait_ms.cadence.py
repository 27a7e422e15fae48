"""A frame's wait in the stream, ms: from its enqueue by the producer to
its batch's dispatch start (queue plus batch fill; StageTimes `wait`)."""

from apds_bench.metrics._spans import span_ms


def read(ctx):
    return span_ms(ctx, "wait")
