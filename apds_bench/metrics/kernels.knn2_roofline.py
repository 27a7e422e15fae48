"""Kernel 4 (`match_kernel.knn2_hamming_cuda`) at the cell's Q and M: the
least time an H100 could take (roofline.py) over its CUDA-event time, %."""

from apds_bench.metrics._layers import knn2_roofline as read  # noqa: F401
