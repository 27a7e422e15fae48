"""Parity of the PyTorch port's matching and geometry with the JAX package.

Inputs come from numpy seeds; the RANSAC functions of both packages are
fed the same hypothesis draws (the JAX package's, through the port's `r`
argument), since torch and jax.random give different numbers.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubesat_apds_tpu.core import camera as jcam
from cubesat_apds_tpu.core.config import PnPConfig as JPnPConfig
from cubesat_apds_tpu.core.config import RansacConfig as JRansacConfig
from cubesat_apds_tpu.core.types import CameraModel as JCameraModel
from cubesat_apds_tpu.core.types import Correspondences as JCorr
from cubesat_apds_tpu.ops import match as jmatch
from cubesat_apds_tpu.ops import warp as jwarp
from cubesat_apds_tpu.ops.geometry import epnp as jepnp
from cubesat_apds_tpu.ops.geometry import homography as jhom
from cubesat_apds_tpu.ops.geometry import linalg_small as jla
from cubesat_apds_tpu.ops.geometry import planar as jplanar
from cubesat_apds_tpu.ops.geometry import pnp as jpnp
from cubesat_apds_tpu.ops.geometry import rodrigues as jrod
from cubesat_apds_tpu_torch import convert
from cubesat_apds_tpu_torch.core import camera as tcam
from cubesat_apds_tpu_torch.core.config import PnPConfig, RansacConfig
from cubesat_apds_tpu_torch.core.types import Correspondences
from cubesat_apds_tpu_torch.ops import match as tmatch
from cubesat_apds_tpu_torch.ops import warp as twarp
from cubesat_apds_tpu_torch.ops.geometry import epnp as tepnp
from cubesat_apds_tpu_torch.ops.geometry import homography as thom
from cubesat_apds_tpu_torch.ops.geometry import linalg_small as tla
from cubesat_apds_tpu_torch.ops.geometry import planar as tplanar
from cubesat_apds_tpu_torch.ops.geometry import pnp as tpnp
from cubesat_apds_tpu_torch.ops.geometry import rodrigues as trod

torch.set_num_threads(2)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _angle_deg(Ra, Rb):
    c = (np.trace(np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64))
         - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def _jaccard(a, b):
    a, b = np.asarray(a, bool), np.asarray(b, bool)
    union = (a | b).sum()
    return 1.0 if union == 0 else float((a & b).sum() / union)


# --- matching: bit-exact ---------------------------------------------------

@pytest.fixture(scope="module")
def descriptors():
    """Queries and a DB with exact duplicates (distance ties: the lowest
    index must win), near-duplicates and invalid rows on both sides."""
    rng = np.random.default_rng(11)
    m, q = 300, 96
    db = rng.integers(0, 256, (m, 61), dtype=np.uint8)
    db[100:150] = db[0:50]                     # exact duplicate rows
    noise = (rng.integers(0, 256, (q, 61), dtype=np.uint8)
             & (rng.random((q, 61)) < 0.05).astype(np.uint8) * 255)
    qd = db[rng.integers(0, 150, q)] ^ noise
    qd[:12] = db[:12]                           # exact hits with a duplicate
    db_valid = rng.random(m) > 0.1
    db_valid[:3] = False                        # best hit invalid → its twin
    q_valid = rng.random(q) > 0.1
    return qd, db, q_valid, db_valid


def test_unpack_pack_bits_match_jax(descriptors):
    """unpack_bits / pack_bits bit-exact, round trip included."""
    qd = descriptors[0]
    ub = tmatch.unpack_bits(torch.from_numpy(qd))
    np.testing.assert_array_equal(ub.numpy(), np.asarray(jmatch.unpack_bits(qd)))
    bits = np.random.default_rng(2).integers(0, 2, (17, 486)).astype(bool)
    np.testing.assert_array_equal(
        tmatch.pack_bits(torch.from_numpy(bits)).numpy(),
        np.asarray(jmatch.pack_bits(bits)))
    np.testing.assert_array_equal(tmatch.pack_bits(ub[:, :488]).numpy(), qd)


@pytest.mark.parametrize("ratio", [0.75, 0.3])
def test_knn_match_bit_exact(descriptors, ratio):
    """Every field of knn_match bit-exact: Hamming distances from a 0/1
    float32 product are exact, the 3.0e38 sentinel and the lowest-index
    tie-break are the same int32 keys."""
    qd, db, q_valid, db_valid = descriptors
    ref = jmatch.knn_match(jnp.asarray(qd), jnp.asarray(db), ratio=ratio,
                           q_valid=jnp.asarray(q_valid),
                           db_valid=jnp.asarray(db_valid), block=65536)
    got = tmatch.knn_match(torch.from_numpy(qd), torch.from_numpy(db),
                           ratio=ratio, q_valid=torch.from_numpy(q_valid),
                           db_valid=torch.from_numpy(db_valid), block=65536)
    for f in ("query_idx", "train_idx", "distance", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert got.valid.any() and not got.valid.all()


def test_knn2_ties_and_sentinels_match_jax(descriptors):
    """(d0, d1, i0) bit-exact, sentinel rows (invalid queries, a DB with
    one valid row) included."""
    qd, db, q_valid, _ = descriptors
    one_valid = np.zeros(len(db), bool)
    one_valid[7] = True
    for dbv in (None, one_valid):
        args = (tmatch.unpack_bits(torch.from_numpy(qd)),
                tmatch.unpack_bits(torch.from_numpy(db)),
                torch.from_numpy(q_valid),
                None if dbv is None else torch.from_numpy(dbv))
        got = tmatch.knn2(*args)
        ref = jmatch.knn2(jmatch.unpack_bits(qd), jmatch.unpack_bits(db),
                          jnp.asarray(q_valid),
                          None if dbv is None else jnp.asarray(dbv))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_knn_match_big_db_branch_not_ported(descriptors):
    """A DB past db_block (ported since: the big-DB branch) no longer
    raises: on CPU tensors it runs the blockwise twin, bit-exact with
    JAX's scan, and gives the dense branch's matches when no query is
    masked (q_valid masks only d0 there)."""
    qd, db, _, db_valid = descriptors
    kw = dict(ratio=0.75, db_valid=torch.from_numpy(db_valid))
    got = tmatch.knn_match(torch.from_numpy(qd), torch.from_numpy(db),
                           block=64, **kw)
    dense = tmatch.knn_match(torch.from_numpy(qd), torch.from_numpy(db), **kw)
    ref = jmatch.knn_match(jnp.asarray(qd), jnp.asarray(db), ratio=0.75,
                           db_valid=jnp.asarray(db_valid), block=64,
                           kernel="scan")
    for f in ("query_idx", "train_idx", "distance", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
        assert torch.equal(getattr(got, f), getattr(dense, f)), f


# --- small geometry: parity of each building block -------------------------

def _spd(rng, n, batch=5):
    a = rng.standard_normal((batch, n, n)).astype(np.float32)
    return a @ np.swapaxes(a, -1, -2) + n * np.eye(n, dtype=np.float32)


@pytest.mark.parametrize("name", ["inv3x3", "cholesky_solve", "eigh3x3",
                                  "eigh_smallest", "polar_rotation",
                                  "rodrigues", "matrix_to_rodrigues",
                                  "apply_homography", "pixels_to_normalized",
                                  "dlt_homography_solve", "epnp",
                                  "planar_pose", "ortho_pose_candidates"])
def test_geometry_block_matches_jax(name):
    """Each building block on the same inputs, float32, rtol/atol 1e-4
    (the unrolled solvers run the same float ops; matrix products sum in
    another order). Eigenvectors are compared up to sign."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "inv3x3":
        A = rng.standard_normal((6, 3, 3)).astype(np.float32) + 2 * np.eye(3)
        A = A.astype(np.float32)
        pairs = [(tla.inv3x3(_t(A)), jla.inv3x3(A))]
    elif name == "cholesky_solve":
        A, b = _spd(rng, 8), rng.standard_normal((5, 8)).astype(np.float32)
        pairs = [(tla.cholesky_solve(_t(A), _t(b), damp=1e-8),
                  jla.cholesky_solve(A, b, damp=1e-8))]
    elif name == "eigh3x3":
        A = _spd(rng, 3)
        (wt, vt), (wj, vj) = tla.eigh3x3(_t(A)), jla.eigh3x3(A)
        sign = np.sign((vt.numpy() * np.asarray(vj)).sum(-2, keepdims=True))
        pairs = [(wt, wj), (vt.numpy() * sign, vj)]
    elif name == "eigh_smallest":
        A = _spd(rng, 12, batch=3) - 11.0 * np.eye(12, dtype=np.float32)
        A = (A @ A).astype(np.float32)
        vt, vj = tla.eigh_smallest(_t(A), 4), jla.eigh_smallest(A, 4)
        sign = np.sign((vt.numpy() * np.asarray(vj)).sum(-2, keepdims=True))
        pairs = [(vt.numpy() * sign, vj)]
    elif name == "polar_rotation":
        S = rng.standard_normal((6, 3, 3)).astype(np.float32) + 3 * np.eye(3)
        S = S.astype(np.float32)
        pairs = [(tla.polar_rotation(_t(S)), jla.polar_rotation(S))]
    elif name == "rodrigues":
        rv = rng.standard_normal((8, 3)).astype(np.float32)
        rv[0] = 0.0
        pairs = [(trod.rodrigues_to_matrix(_t(rv)), jrod.rodrigues_to_matrix(rv))]
    elif name == "matrix_to_rodrigues":
        rv = (rng.standard_normal((8, 3)) * 0.8).astype(np.float32)
        rv[1] = [np.pi - 1e-4, 0, 0]
        R = np.asarray(jrod.rodrigues_to_matrix(rv))
        pairs = [(trod.matrix_to_rodrigues(_t(R)), jrod.matrix_to_rodrigues(R))]
    elif name == "apply_homography":
        H = np.array([[1.1, 0.02, 5.0], [-0.03, 0.95, -7.0], [1e-4, 2e-4, 1.0]],
                     np.float32)
        p = rng.uniform(0, 500, (40, 2)).astype(np.float32)
        pairs = [(twarp.apply_homography(_t(H), _t(p)),
                  jwarp.apply_homography(H, p))]
    elif name == "pixels_to_normalized":
        K = np.array([[800, 0.5, 250], [0, 790, 260], [0, 0, 1]], np.float32)
        dist = np.array([0.05, -0.01, 0.001, -0.002, 0.003], np.float32)
        p = rng.uniform(0, 500, (40, 2)).astype(np.float32)
        cam_t = convert.camera_from({"K": K, "dist": dist}, device="cpu")
        pairs = [(tcam.pixels_to_normalized(_t(p), cam_t),
                  jcam.pixels_to_normalized(p, JCameraModel(K=K, dist=dist)))]
    else:
        obj, uv, w = _pose_problem(rng)
        if name == "dlt_homography_solve":
            src = rng.uniform(0, 500, (4, 30, 2)).astype(np.float32)
            dst = (src * 1.05 + 3.0).astype(np.float32)
            pairs = [(thom.dlt_homography_solve(_t(src), _t(dst)),
                      jhom.dlt_homography_solve(src, dst))]
        elif name == "epnp":
            got = tepnp.epnp(_t(obj), _t(uv), _t(w))
            ref = jepnp.epnp(obj, uv, w)
            pairs = list(zip(got[:2], ref[:2]))
            assert bool(got[2]) == bool(ref[2])
        elif name == "planar_pose":
            got = tplanar.planar_pose(_t(obj), _t(uv), _t(w))
            ref = jplanar.planar_pose(obj, uv, w)
            pairs = list(zip(got[:2], ref[:2]))
            assert bool(got[2]) == bool(ref[2])
        else:
            got = tplanar.ortho_pose_candidates(_t(obj), _t(uv), _t(w))
            ref = jplanar.ortho_pose_candidates(obj, uv, w)
            pairs = list(zip(got[:2], ref[:2]))
            assert bool(got[2]) == bool(ref[2])
    for g, r in pairs:
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4, atol=1e-4)


def _pose_problem(rng, n=60):
    """Normalized-unit world points with relief, seen by a pose."""
    obj = np.concatenate([rng.uniform(-1, 1, (n, 2)),
                          rng.uniform(-0.2, 0.2, (n, 1))], 1).astype(np.float32)
    R = np.asarray(jrod.rodrigues_to_matrix(
        np.array([0.1, -0.2, 0.05], np.float32)))
    cam = obj @ R.T + np.array([0.1, -0.05, 4.0], np.float32)
    uv = (cam[:, :2] / cam[:, 2:]).astype(np.float32)
    uv += rng.normal(0, 1e-4, uv.shape).astype(np.float32)
    w = (rng.random(n) > 0.1).astype(np.float32)
    return obj, uv, w


# --- RANSAC with the JAX package's draws -----------------------------------

def test_homography_ransac_matches_jax():
    """Same draws fed to both: inlier Jaccard ≥ 0.95 and H within 1e-3
    relative (the winner's refit sums in another order)."""
    rng = np.random.default_rng(21)
    n = 300
    H_true = np.array([[1.02, 0.03, 12.0], [-0.02, 0.99, 7.0],
                       [1e-5, -2e-5, 1.0]], np.float32)
    src = rng.uniform(0, 512, (n, 2)).astype(np.float32)
    dst = np.asarray(jwarp.apply_homography(H_true, src))
    dst = dst + rng.normal(0, 0.3, dst.shape).astype(np.float32)
    out = rng.random(n) < 0.3
    dst[out] = rng.uniform(0, 512, (out.sum(), 2))
    valid = rng.random(n) > 0.05
    cfg_j = JRansacConfig(num_hypotheses=128)
    cfg_t = RansacConfig(num_hypotheses=128)

    ref = jhom.find_homography_ransac(jnp.asarray(src), jnp.asarray(dst),
                                      jnp.asarray(valid), config=cfg_j)
    r = jax.random.randint(jax.random.PRNGKey(cfg_j.seed), (128, 4), 0,
                           max(int(valid.sum()), 1))
    got = thom.find_homography_ransac(_t(src), _t(dst), torch.from_numpy(valid),
                                      config=cfg_t, r=torch.from_numpy(
                                          np.array(r)))
    assert bool(got.ok) and bool(ref.ok)
    assert _jaccard(got.inliers.numpy(), ref.inliers) >= 0.95
    Hr = np.asarray(ref.H)
    np.testing.assert_allclose(got.H.numpy(), Hr, atol=1e-3 * np.abs(Hr).max())


def test_homography_ransac_own_draws_recover_model():
    """Without `r` the port draws from a seeded CPU generator: the same
    result on every call, and the model is recovered."""
    rng = np.random.default_rng(5)
    src = rng.uniform(0, 256, (80, 2)).astype(np.float32)
    dst = src + np.array([13.0, 7.0], np.float32)
    dst[:20] = rng.uniform(0, 256, (20, 2))
    a = thom.find_homography_ransac(_t(src), _t(dst))
    b = thom.find_homography_ransac(_t(src), _t(dst))
    assert torch.equal(a.H, b.H) and torch.equal(a.inliers, b.inliers)
    assert bool(a.ok) and int(a.num_inliers) == 60
    np.testing.assert_allclose(a.H.numpy()[:2, 2], [13.0, 7.0], atol=1e-2)


@pytest.mark.parametrize("gate", [False, True])
def test_pnp_ransac_matches_jax(gate):
    """Same draws fed to both: rotation within 0.1°, inlier Jaccard
    ≥ 0.95, ok equal; with and without the above-terrain up-gate."""
    rng = np.random.default_rng(31)
    n = 200
    obj = np.concatenate([rng.uniform(-500, 500, (n, 2)),
                          rng.uniform(-20, 20, (n, 1))], 1).astype(np.float32)
    rv = np.array([0.1, -0.05, 0.02], np.float32)
    R = np.asarray(jrod.rodrigues_to_matrix(rv))
    t = np.array([10.0, -20.0, 2000.0], np.float32)
    K = np.array([[800, 0, 256], [0, 800, 256], [0, 0, 1]], np.float32)
    dist = np.array([0.02, 0, 0, 0, 0], np.float32)
    cam = obj @ R.T + t
    xy = np.asarray(jcam.distort_normalized(cam[:, :2] / cam[:, 2:], dist))
    pix = (xy * 800 + 256).astype(np.float32)
    pix += rng.normal(0, 0.3, pix.shape).astype(np.float32)
    out = rng.random(n) < 0.25
    pix[out] = rng.uniform(0, 512, (out.sum(), 2))
    valid = rng.random(n) > 0.05
    up = np.array([0.0, 0.0, -1.0], np.float32) if gate else None
    cfg_j, cfg_t = JPnPConfig(num_hypotheses=64), PnPConfig(num_hypotheses=64)

    ref = jpnp.solve_pnp_ransac(
        JCorr(obj_points=jnp.asarray(obj), img_points=jnp.asarray(pix),
              valid=jnp.asarray(valid)),
        JCameraModel(K=jnp.asarray(K), dist=jnp.asarray(dist)), cfg_j,
        up=None if up is None else jnp.asarray(up))
    r = jax.random.randint(jax.random.PRNGKey(cfg_j.seed),
                           (cfg_j.num_hypotheses, cfg_j.sample_size), 0,
                           max(int(valid.sum()), 1))
    got = tpnp.solve_pnp_ransac(
        Correspondences(obj_points=_t(obj), img_points=_t(pix),
                        valid=torch.from_numpy(valid)),
        convert.camera_from({"K": K, "dist": dist}, device="cpu"), cfg_t,
        up=None if up is None else _t(up), r=torch.from_numpy(np.array(r)))
    assert bool(got.ok) == bool(ref.ok)
    Rg = trod.rodrigues_to_matrix(got.rvec).numpy()
    Rr = np.asarray(jrod.rodrigues_to_matrix(ref.rvec))
    assert _angle_deg(Rg, Rr) <= 0.1
    assert _angle_deg(Rg, R) <= 0.5
    assert _jaccard(got.inliers.numpy(), ref.inliers) >= 0.95
