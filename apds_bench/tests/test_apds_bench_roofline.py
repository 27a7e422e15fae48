"""Kernel 4's work, counted from the algorithm's shapes."""

import pytest

from apds_bench import roofline

Q, M = 16384, 1048576


def test_knn2_ops():
    assert roofline.knn2_ops(Q, M) == 2 * Q * M * 486
    assert roofline.knn2_ops(Q, M) == pytest.approx(1.6699e13, rel=1e-4)


def test_knn2_bytes():
    assert roofline.knn2_bytes(Q, M) == M * 61 + Q * 61 + Q * 12


def test_knn2_bound_is_the_operations():
    t, by = roofline.knn2_bound_s(Q, M)
    assert by == "ops"
    assert t * 1e3 == pytest.approx(8.4380, rel=1e-4)
