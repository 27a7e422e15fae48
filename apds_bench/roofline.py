"""Peaks of one NVIDIA H100 and the work of the port's kernels, counted
from the algorithm's shapes (never from a kernel's padding).

Published peaks (NVIDIA's data sheet, SXM part, dense, at 700 W): 1,979
TOP/s int8 on the tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

H100_INT8_OPS = 1979e12
H100_HBM_BYTES = 3.35e12

DESC_BITS = 486      # the MLDB descriptor's bits; its 61 bytes pad it by 2
DESC_BYTES = 61


def knn2_ops(q: int, m: int) -> float:
    """Kernel 4's operations: Q × M pairs of 486-bit descriptors, each
    bit counted as 2 operations (the product and the sum). The two bits
    that pad a descriptor to 61 bytes are zero and carry no work."""
    return 2.0 * q * m * DESC_BITS


def knn2_bytes(q: int, m: int) -> float:
    """Kernel 4's bytes: the DB's descriptors and the queries read once,
    and each query's (d0, d1, i0) written once."""
    return float(m * DESC_BYTES + q * DESC_BYTES + q * 12)


def knn2_bound_s(q: int, m: int) -> tuple:
    """(seconds, "ops" or "bytes"): the least time an H100 could take."""
    t_ops = knn2_ops(q, m) / H100_INT8_OPS
    t_bytes = knn2_bytes(q, m) / H100_HBM_BYTES
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
