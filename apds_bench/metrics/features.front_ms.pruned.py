"""The front half and the capacity ladder of one batch in the pruned
cell (`akaze.detect_and_compute_batch`), ms by CUDA events after the
window."""

from apds_bench.metrics._layers import front_ms as read  # noqa: F401
