"""The back half of one batch at the cell's shape (`localize.back_half`
or `pruned_back_half`: match, window, RANSAC, PnP), ms by CUDA events after
the window."""

from apds_bench.metrics._layers import back_half_ms as read  # noqa: F401
