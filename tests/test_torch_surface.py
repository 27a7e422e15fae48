"""The port's public surface against the JAX package's, where a call line
valid in the JAX package used to fail in the port or reach the wrong
parameter: `batched` in the three scale-space signatures, `key` in the
two RANSAC signatures, the fast and hybrid MLDB functions' arguments
(tests/test_torch_modes.py runs them on JAX's stack), and
`linalg_small.highest_matmul_precision`. Also: the front graph's CPU
tests hold when an earlier test file of the process left graphs in the
four graph caches.
"""

import dataclasses
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cubesat_apds_tpu_torch.core.config import (
    AkazeConfig, PnPConfig, RansacConfig)
from cubesat_apds_tpu_torch.core.step_graph import leaves
from cubesat_apds_tpu_torch.core.types import (
    CameraModel, Correspondences)
from cubesat_apds_tpu_torch.ops.features import akaze as takaze
from cubesat_apds_tpu_torch.ops.features import mldb as tmldb
from cubesat_apds_tpu_torch.ops.features import scale_space as tss
from cubesat_apds_tpu_torch.ops.geometry import homography as thom
from cubesat_apds_tpu_torch.ops.geometry import linalg_small as tlin
from cubesat_apds_tpu_torch.ops.geometry import pnp as tpnp
from cubesat_apds_tpu_torch.ops.kernels import diffusion as tdiff

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _same(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) > 0 and all(
        torch.equal(x, y) for x, y in zip(la, lb))


# ---- the signatures ---------------------------------------------------------

PAIRS = {  # name: (port module, JAX module)
    "detect_and_compute": (takaze, "cubesat_apds_tpu.ops.features.akaze"),
    "build_scale_space": (tss, "cubesat_apds_tpu.ops.features.scale_space"),
    "fed_cycle_fused": (tdiff, "cubesat_apds_tpu.ops.pallas.diffusion"),
    "find_homography_ransac": (thom,
                               "cubesat_apds_tpu.ops.geometry.homography"),
    "solve_pnp_ransac": (tpnp, "cubesat_apds_tpu.ops.geometry.pnp"),
    "mldb_descriptors_fast": (tmldb, "cubesat_apds_tpu.ops.features.mldb"),
    "mldb_descriptors_hybrid": (tmldb, "cubesat_apds_tpu.ops.features.mldb"),
    "highest_matmul_precision": (
        tlin, "cubesat_apds_tpu.ops.geometry.linalg_small"),
}


def _positional(fn) -> list:
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


@pytest.mark.parametrize("name", list(PAIRS))
def test_positional_parameters_are_the_jax_packages(name):
    """Each function takes the JAX package's parameters in the JAX
    package's positions (the port's own extras are keyword-only), so a
    JAX call line reaches the same parameters in the port."""
    import importlib

    port_module, jax_module = PAIRS[name]
    jax_fn = getattr(importlib.import_module(jax_module), name)
    assert _positional(getattr(port_module, name)) == _positional(jax_fn)


# ---- batched ----------------------------------------------------------------

def _frame(n=64, seed=3):
    rng = np.random.default_rng(seed)
    img = np.zeros((n, n), np.float32)
    for _ in range(12):
        cy, cx = rng.integers(2, n - 12, 2)
        s = int(rng.integers(4, 12))
        img[cy:cy + s, cx:cx + s] = rng.uniform(0.2, 1.0)
    return torch.from_numpy(img)


@pytest.mark.parametrize("how", ["position", "keyword"])
def test_batched_is_accepted_and_changes_nothing(how):
    """batched=True, by position and by keyword, in detect_and_compute,
    build_scale_space and fed_cycle_fused: the same bits as the call
    without it (on the TPU it only budgets memory for the strip plan)."""
    img = _frame()
    cfg = AkazeConfig(capacity=64)
    kw = {"batched": True} if how == "keyword" else {}
    pos = (True,) if how == "position" else ()

    want = takaze.detect_and_compute(img, cfg, 64, None)
    got = takaze.detect_and_compute(img, cfg, 64, None, *pos, **kw)
    assert _same(got, want) and int(want.keypoints.valid.sum()) > 0

    want = tss.build_scale_space(img, cfg, None)
    got = tss.build_scale_space(img, cfg, None, *pos, **kw)
    assert _same(tuple(got.Lt + got.Lsmooth),
                 tuple(want.Lt + want.Lsmooth))

    rng = np.random.default_rng(4)
    L = torch.from_numpy(rng.random((48, 40), dtype=np.float32))
    g = torch.from_numpy(rng.random((48, 40), dtype=np.float32))
    taus = tss.fed_tau_by_process_time(1.5, cfg.fed_tau_max)
    want = tdiff.fed_cycle_fused(L, g, taus)
    got = tdiff.fed_cycle_fused(L, g, taus, *pos, **kw)
    assert torch.equal(got, want)


# ---- key --------------------------------------------------------------------

def _homography_scene():
    rng = np.random.default_rng(5)
    src = rng.uniform(0, 256, (80, 2)).astype(np.float32)
    dst = src + np.array([13.0, 7.0], np.float32)
    dst[:20] = rng.uniform(0, 256, (20, 2))
    valid = rng.random(80) > 0.1
    return (torch.from_numpy(src), torch.from_numpy(dst),
            torch.from_numpy(valid))


def test_homography_key_seeds_the_draws():
    """key=None draws from config.seed (the JAX package's
    PRNGKey(config.seed) default); an int key seeds the draws itself, as
    config.seed = key would; `r` is keyword-only."""
    src, dst, valid = _homography_scene()
    cfg = RansacConfig(num_hypotheses=16)
    base = thom.find_homography_ransac(src, dst, valid, cfg)
    assert _same(thom.find_homography_ransac(src, dst, valid, cfg, None),
                 base)
    for key in (3, np.int64(11)):
        got = thom.find_homography_ransac(src, dst, valid, cfg, key, "ransac")
        want = thom.find_homography_ransac(
            src, dst, valid, dataclasses.replace(cfg, seed=int(key)))
        assert _same(got, want)
    r = thom.draw_indices(valid.sum(), (16, 4), 3, "cpu")
    assert _same(thom.find_homography_ransac(src, dst, valid, cfg, r=r),
                 thom.find_homography_ransac(src, dst, valid, cfg, 3))
    with pytest.raises(TypeError):
        thom.find_homography_ransac(src, dst, valid, cfg, None, "ransac",
                                    None, r)


def _pnp_scene():
    """Points near the z = 0 plane seen from a camera 2000 units down
    the -z side (its centre at z ≈ -2000), a quarter of them outliers."""
    rng = np.random.default_rng(31)
    n = 120
    obj = np.concatenate([rng.uniform(-500, 500, (n, 2)),
                          rng.uniform(-20, 20, (n, 1))], 1).astype(np.float32)
    cam = obj + np.array([10.0, -20.0, 2000.0], np.float32)
    pix = (cam[:, :2] / cam[:, 2:] * 800 + 256).astype(np.float32)
    out = rng.random(n) < 0.25
    pix[out] = rng.uniform(0, 512, (out.sum(), 2))
    corr = Correspondences(obj_points=torch.from_numpy(obj),
                           img_points=torch.from_numpy(pix),
                           valid=torch.ones(n, dtype=torch.bool))
    return corr, CameraModel.ideal(800.0, 800.0, 256.0, 256.0)


def test_pnp_key_and_up_take_the_jax_positions():
    """solve_pnp_ransac(corr, camera, config, key, up): `up` given by
    position reaches the up-gate (the JAX call `(corr, cam, cfg, None,
    up)`), with the same bits as by keyword; an `up` on the wrong side of
    the points rejects every hypothesis. An int key seeds the draws as
    config.seed would; `r` is keyword-only."""
    corr, cam = _pnp_scene()
    cfg = PnPConfig(num_hypotheses=32)
    up = torch.tensor([0.0, 0.0, -1.0])
    free = tpnp.solve_pnp_ransac(corr, cam, cfg)
    assert bool(free.ok)
    by_pos = tpnp.solve_pnp_ransac(corr, cam, cfg, None, up)
    assert _same(by_pos, tpnp.solve_pnp_ransac(corr, cam, cfg, up=up))
    assert bool(by_pos.ok)
    assert not bool(tpnp.solve_pnp_ransac(corr, cam, cfg, None, -up).ok)
    assert _same(tpnp.solve_pnp_ransac(corr, cam, cfg, 9),
                 tpnp.solve_pnp_ransac(corr, cam,
                                       dataclasses.replace(cfg, seed=9)))
    assert _same(tpnp.solve_pnp_ransac(corr, cam, cfg, None), free)
    with pytest.raises(TypeError):
        tpnp.solve_pnp_ransac(corr, cam, cfg, None, up, None)


# ---- highest_matmul_precision -----------------------------------------------

def _matmul_settings():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())


@pytest.mark.parametrize("caller", ["high", "medium", "highest"])
def test_highest_matmul_precision_turns_tf32_off_and_restores(caller):
    """Inside the wrapped call TF32 is off (allow_tf32 False, precision
    "highest"); after it, on return and on an exception, the caller's
    settings are back. The solvers carry the decorator, as in the JAX
    package."""
    seen = []

    @tlin.highest_matmul_precision
    def probe(x, fail=False):
        seen.append(_matmul_settings())
        if fail:
            raise ValueError("inside")
        return x + 1

    try:
        torch.set_float32_matmul_precision(caller)
        before = _matmul_settings()
        assert before[0] is (caller != "highest")
        assert probe(1) == 2
        assert seen[-1] == (False, "highest")
        assert _matmul_settings() == before
        with pytest.raises(ValueError, match="inside"):
            probe(1, fail=True)
        assert seen[-1] == (False, "highest")
        assert _matmul_settings() == before
    finally:
        torch.set_float32_matmul_precision("highest")
    for fn in (thom.dlt_homography, thom.dlt_homography_solve,
               thom.find_homography_ransac, tpnp.solve_pnp_ransac):
        assert fn.__wrapped__.__name__ == fn.__name__
        assert fn.__code__ is tlin.highest_matmul_precision(
            lambda: None).__code__


# ---- the graph caches -------------------------------------------------------

LEFT_BEHIND = """
import sys

import pytest

from cubesat_apds_tpu_torch.ops.features import akaze, ladder
from cubesat_apds_tpu_torch.parallel import mesh
from cubesat_apds_tpu_torch.pipelines import step_graph


class Left:
    def close(self):
        return False


for cache in (akaze._FRONT, ladder._GRAPHS, step_graph._GRAPHS,
              mesh._GRAPHS):
    cache.put(("left by an earlier test file",), Left())
sys.exit(pytest.main([
    "-q", "-p", "no:cacheprovider", "--noconftest",
    "tests/test_torch_front_graph.py", "-k",
    "cpu_makes_no_graph or shared_machinery"]))
"""


def test_front_graph_tests_ignore_graphs_left_by_earlier_files():
    """The front graph's CPU tests assert that the process holds no front
    graph and no back-half graph; run in a process whose four graph
    caches already hold an entry each (as a card test file run before
    them leaves), they still pass: the module clears the caches first."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", LEFT_BEHIND], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "2 passed" in out.stdout
