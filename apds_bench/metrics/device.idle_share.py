"""The device's idle share of the traced stretch, %: 1 − the union of the
device intervals of kernels, copies and memsets over the stretch, under
the profiler."""

from apds_bench.metrics._layers import idle_share as read  # noqa: F401
