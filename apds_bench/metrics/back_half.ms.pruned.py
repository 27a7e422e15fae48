"""The pruned back half of one batch (`pruned_back_half`: coarse fix,
window gather, match, RANSAC, PnP), ms by CUDA events after the
window."""

from apds_bench.metrics._layers import back_half_ms as read  # noqa: F401
