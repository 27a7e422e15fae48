"""The stream's host dispatch time a batch, ms (StageTimes `dispatch`:
stacking the uploaded frames and queueing the front and back halves)."""

from apds_bench.metrics._layers import dispatch_ms as read  # noqa: F401
