"""The reference against a second witness: the JAX package, and the shift
each frame was made with (jax_witness.py, in a process of its own so
that JAX never enters this one). The reference is a frozen copy of the
port's eager path; this is what makes it independent of the port.

The packages draw different RANSAC hypotheses, so homographies agree to
about a pixel at the frame's centre (both about a pixel from the truth)
and inlier counts to one; features and matches agree exactly. Measured
at the toy size: keypoints equal and all paired, descriptor bits
differing ≤ 5.4e-5, matches equal, inliers ±1, centres 1.39 px apart,
0.89 (reference) and 1.00 px (JAX) from the truth, rotations 0.0012°
and camera centres 0.011 apart, the prune index bit for bit, window
sizes within 2.2%."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

from apds_bench.spec import ROOT


@pytest.fixture(scope="module")
def jax_present():
    for name in ("jax", "cubesat_apds_tpu"):
        if importlib.util.find_spec(name) is None:
            pytest.skip(f"{name} is not installed here")


def _witness(path: str) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "apds_bench.tests.jax_witness", path],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("path", ["full", "pruned"])
def test_reference_agrees_with_the_jax_package(jax_present, path):
    w = _witness(path)
    assert w["frames"] == 4
    assert all(all(ok) for ok in w["ok"]), w["ok"]
    for k in w["keypoints"]:
        assert k["n_ref"] == k["n_jax"] > 50, k
        assert k["unpaired"] <= 0.01 and k["desc_bits"] <= 1e-3, k
    n = w["numbers"]
    assert n["missing"] == 0 and n["keypoints"] == 0, n
    assert n["matches"] <= 2 and n["inliers"] <= 3, n
    assert n["pose_deg"] <= 0.05 and n["pose_pos"] <= 0.1, n
    assert w["centre_px"] <= 2.5, w["centre_px"]
    assert max(w["truth_px"].values()) <= 1.5, w["truth_px"]
    if path == "pruned":
        assert all(w["prune_index_equal"].values()), w["prune_index_equal"]
        for ref, jax in w["windows"]:
            assert ref[:2] == jax[:2], w["windows"]
            assert abs(ref[2] - jax[2]) <= 0.05 * ref[2], w["windows"]
