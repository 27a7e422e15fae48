"""The stream's host dispatch time a batch in the pruned cell, ms
(StageTimes `dispatch`: stacking the uploaded frames and queueing the
front half and the pruned back half)."""

from apds_bench.metrics._layers import dispatch_ms as read  # noqa: F401
