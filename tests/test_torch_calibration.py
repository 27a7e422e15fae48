"""The port's calibration slice against the JAX package on the CPU: the
homography DLT and the LMedS / RHO robust fits (ops/geometry/
homography.py), the public pose solvers (planar.ortho_pose,
epnp.epnp_rvec_tvec, pnp.solve_pnp), chessboard corner detection
(ops/geometry/chessboard.py), Zhang + LM calibration (ops/geometry/
calibration.py) and the pipeline's refusals (pipelines/calibrate.py).

The same seeded numpy inputs go through both packages; each test states
its tolerance. JAX compiles find_chessboard_corners and calibrate_camera
per shape, so every board here is 240×320 and every calibration 12 views
under one CalibConfig.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubesat_apds_tpu.core.config import CalibConfig as JCalibConfig
from cubesat_apds_tpu.core.config import RansacConfig as JRansacConfig
from cubesat_apds_tpu.core.types import CameraModel as JCameraModel
from cubesat_apds_tpu.core.types import Correspondences as JCorr
from cubesat_apds_tpu.ops.geometry import calibration as jcal
from cubesat_apds_tpu.ops.geometry import chessboard as jcb
from cubesat_apds_tpu.ops.geometry import epnp as jepnp
from cubesat_apds_tpu.ops.geometry import homography as jhom
from cubesat_apds_tpu.ops.geometry import planar as jplanar
from cubesat_apds_tpu.ops.geometry import pnp as jpnp
from cubesat_apds_tpu.ops.geometry.rodrigues import matrix_to_rodrigues
from cubesat_apds_tpu.ops.geometry.rodrigues import (
    rodrigues_to_matrix as jrodrigues)
from cubesat_apds_tpu.pipelines import calibrate as jpipe
from cubesat_apds_tpu_torch.core.config import CalibConfig, RansacConfig
from cubesat_apds_tpu_torch.core.types import CameraModel, Correspondences
from cubesat_apds_tpu_torch.ops.geometry import calibration as tcal
from cubesat_apds_tpu_torch.ops.geometry import chessboard as tcb
from cubesat_apds_tpu_torch.ops.geometry import epnp as tepnp
from cubesat_apds_tpu_torch.ops.geometry import homography as thom
from cubesat_apds_tpu_torch.ops.geometry import planar as tplanar
from cubesat_apds_tpu_torch.ops.geometry import pnp as tpnp
from cubesat_apds_tpu_torch.pipelines import calibrate as tpipe
from test_calibration import K_TRUE, NX, NY, _render_board, _synth_views

torch.set_num_threads(2)

T = torch.from_numpy


def _rot_deg(rv_a, rv_b):
    Ra = np.asarray(jrodrigues(np.asarray(rv_a, np.float64)))
    Rb = np.asarray(jrodrigues(np.asarray(rv_b, np.float64)))
    c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def _apply(H, pts):
    q = np.c_[pts, np.ones(len(pts))] @ np.asarray(H, np.float64).T
    return q[:, :2] / q[:, 2:]


# ---- homography ------------------------------------------------------------

H_GT = np.array([[1.1, 0.05, 10.0], [-0.02, 0.95, -5.0], [1e-4, 2e-4, 1.0]])


def _correspondences(rng, n, noise, outliers=0.0):
    src = rng.uniform(0, 500, (n, 2)).astype(np.float32)
    dst = _apply(H_GT, src) + rng.normal(0, noise, (n, 2))
    out = rng.random(n) < outliers
    dst[out] = rng.uniform(0, 500, (int(out.sum()), 2))
    return src, dst.astype(np.float32), out


def test_dlt_homography_matches_jax():
    """Batched, weighted (masked points included): within 1e-4 of the
    largest entry (the float32 9×9 eigenvector differs in its last bits
    between the packages)."""
    rng = np.random.default_rng(0)
    src = rng.uniform(0, 300, (5, 12, 2)).astype(np.float32)
    dst = np.stack([_apply(H_GT, s) for s in src]).astype(np.float32) \
        + rng.normal(0, 0.3, src.shape).astype(np.float32)
    w = (rng.random((5, 12)) > 0.2).astype(np.float32)
    for weights in (None, w):
        want = np.asarray(jhom.dlt_homography(
            jnp.asarray(src), jnp.asarray(dst),
            None if weights is None else jnp.asarray(weights)))
        got = thom.dlt_homography(T(src), T(dst),
                                  None if weights is None else T(weights))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("method", ["ransac", "lmeds", "rho"])
def test_robust_homography_methods_match_jax(method):
    """JAX's draws fed in (randint for ransac and lmeds, the uniform u of
    the PROSAC pools for rho, ranked by a quality with many ties): the
    same inlier mask and ok flag, H within 1e-3 px at the corners of the
    500² field; and the fit recovers H_GT."""
    rng = np.random.default_rng(1)
    src, dst, _ = _correspondences(rng, 200, 0.5, outliers=0.35)
    valid = rng.random(200) > 0.1
    quality = rng.integers(0, 60, 200).astype(np.float32)
    nh = 64
    key = jax.random.PRNGKey(JRansacConfig().seed)
    ref = jhom.find_homography_ransac(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid),
        JRansacConfig(num_hypotheses=nh), method=method,
        quality=jnp.asarray(quality))
    if method == "rho":
        r = np.array(jax.random.uniform(key, (nh, 4)), np.float32)
    else:
        r = np.array(jax.random.randint(key, (nh, 4), 0,
                                          max(int(valid.sum()), 1)))
    got = thom.find_homography_ransac(
        T(src), T(dst), T(valid), RansacConfig(num_hypotheses=nh), r=T(r),
        method=method, quality=T(quality))
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(ref.inliers))
    assert bool(got.ok) == bool(ref.ok) is True
    corners = np.array([[0, 0], [500, 0], [0, 500], [500, 500]], np.float64)
    np.testing.assert_allclose(_apply(got.H.numpy(), corners),
                               _apply(ref.H, corners), rtol=0, atol=1e-3)
    np.testing.assert_allclose(_apply(got.H.numpy(), corners),
                               _apply(H_GT, corners), rtol=0, atol=2.0)


def test_rho_without_quality_is_ransac_and_default_unchanged():
    """rho without a quality is ransac, bit for bit; an unknown method
    raises."""
    rng = np.random.default_rng(2)
    src, dst, _ = _correspondences(rng, 120, 0.5, outliers=0.2)
    cfg = RansacConfig(num_hypotheses=32)
    a = thom.find_homography_ransac(T(src), T(dst), config=cfg)
    b = thom.find_homography_ransac(T(src), T(dst), config=cfg, method="rho")
    assert torch.equal(a.H, b.H) and torch.equal(a.inliers, b.inliers)
    with pytest.raises(ValueError, match="unknown homography method"):
        thom.find_homography_ransac(T(src), T(dst), config=cfg,
                                    method="magsac")


# ---- the public pose solvers ----------------------------------------------


def _pnp_scene(rng, n=40, relief=2.0, noise=0.5):
    """A ground patch seen from 1500 m, 15° off nadir, focal 800 px."""
    pts = np.zeros((n, 3))
    pts[:, :2] = rng.uniform(-400, 400, (n, 2))
    pts[:, 2] = rng.uniform(-relief, relief, n)
    a = np.deg2rad(15.0)
    C = np.array([1500 * np.sin(a), 0.0, 1500 * np.cos(a)])
    z = -C / np.linalg.norm(C)
    x = np.array([1.0, 0, 0]) - z[0] * z
    x /= np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z])
    cam = (pts - C) @ R.T
    K = np.array([[800.0, 0, 320], [0, 800, 240], [0, 0, 1]])
    pix = cam[:, :2] / cam[:, 2:] * 800.0 + [320, 240]
    pix = pix + rng.normal(0, noise, pix.shape)
    uv_n = (pix - [320, 240]) / 800.0
    return pts, pix, uv_n, K, R


def test_ortho_and_epnp_match_jax():
    """ortho_pose (its ok ANDs both mirror candidates, as the reference's)
    and epnp_rvec_tvec on a near-planar patch, in a zero-centred unit-RMS
    frame (the solvers' working frame): rotations within 0.1°, ok flags
    equal, translations within 1e-3 of the scene scale. EPnP is held on
    a 3-D box of points (0.3 px of noise)."""
    rng = np.random.default_rng(3)
    pts, _, uv_n, _, _ = _pnp_scene(rng)
    obj = (pts - pts.mean(0)) / np.sqrt(((pts - pts.mean(0)) ** 2).sum(1)
                                        .mean())
    obj = obj.astype(np.float32)
    uv = uv_n.astype(np.float32)
    w = (rng.random(len(obj)) > 0.1).astype(np.float32)
    Rj, tj, okj = jax.jit(jplanar.ortho_pose)(
        jnp.asarray(obj), jnp.asarray(uv), jnp.asarray(w))
    Rt, tt, okt = tplanar.ortho_pose(T(obj), T(uv), T(w))
    assert bool(okt) == bool(okj)
    assert _rot_deg(np.asarray(matrix_to_rodrigues(jnp.asarray(Rt.numpy()))),
                    np.asarray(matrix_to_rodrigues(Rj))) <= 0.1
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0,
                               atol=1e-3 * np.abs(np.asarray(tj)).max())
    # EPnP on a box of points 4 box-widths away: on the ground patch its
    # answer is ill-conditioned (float32 rounding alone moves it by
    # degrees), which is why the planar and POS solvers exist.
    obj = rng.uniform(-1.0, 1.0, (40, 3))
    R = np.asarray(jrodrigues(np.array([0.3, -0.5, 0.2])))
    cam = obj @ R.T + [0.2, -0.1, 4.0]
    uv = (cam[:, :2] / cam[:, 2:]
          + rng.normal(0, 0.3 / 800.0, (40, 2))).astype(np.float32)
    obj = obj.astype(np.float32)
    rj, tj, okj = jax.jit(jepnp.epnp_rvec_tvec)(
        jnp.asarray(obj), jnp.asarray(uv), jnp.asarray(w))
    rt, tt, okt = tepnp.epnp_rvec_tvec(T(obj), T(uv), T(w))
    assert bool(okt) == bool(okj)
    assert _rot_deg(rt.numpy(), rj) <= 0.1
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0,
                               atol=1e-3 * np.abs(np.asarray(tj)).max())


def test_solve_pnp_matches_jax():
    """Non-robust PnP, a masked point included: rotations within 0.1° of
    each other (and within 0.5° of the truth, at 0.5 px of noise), ok
    flags and inlier counts equal, camera centres within 1 m of each
    other."""
    rng = np.random.default_rng(4)
    pts, pix, _, K, R_true = _pnp_scene(rng, relief=20.0)
    valid = np.ones(len(pts), bool)
    valid[5] = False
    pix[5] += 300.0                         # masked outlier
    ref = jax.jit(jpnp.solve_pnp)(
        JCorr(obj_points=jnp.asarray(pts, jnp.float32),
              img_points=jnp.asarray(pix, jnp.float32),
              valid=jnp.asarray(valid)),
        JCameraModel(K=jnp.asarray(K, jnp.float32),
                     dist=jnp.zeros(5, jnp.float32)))
    got = tpnp.solve_pnp(
        Correspondences(obj_points=T(pts.astype(np.float32)),
                        img_points=T(pix.astype(np.float32)), valid=T(valid)),
        CameraModel(K=T(K.astype(np.float32)), dist=torch.zeros(5)))
    assert bool(got.ok) == bool(ref.ok) is True
    assert int(got.num_inliers) == int(ref.num_inliers) == len(pts) - 1
    assert _rot_deg(got.rvec.numpy(), ref.rvec) <= 0.1
    assert _rot_deg(got.rvec.numpy(),
                    np.asarray(matrix_to_rodrigues(jnp.asarray(R_true)))) \
        <= 0.5

    def centre(rv, tv):
        Rm = np.asarray(jrodrigues(np.asarray(rv, np.float64)))
        return -Rm.T @ np.asarray(tv, np.float64)

    assert np.linalg.norm(centre(got.rvec.numpy(), got.tvec.numpy())
                          - centre(ref.rvec, ref.tvec)) < 1.0


# ---- chessboard ------------------------------------------------------------


def _warped_board(rng):
    """_render_board under a random perspective (PIL, as
    tests/test_calibration.py's warped boards), 240×320."""
    from PIL import Image

    base = _render_board(H=240, W=320, cell=22, bx=50, by=30)
    jitter = rng.uniform(-0.08, 0.08, (4, 2)) * [320, 240]
    dst = np.array([[0, 0], [320, 0], [320, 240], [0, 240]], np.float64)
    src = dst + jitter
    A, b = [], []
    for (x, y), (u, v) in zip(dst, src):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        b.append(u)
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b.append(v)
    coeffs = np.linalg.solve(np.array(A), np.array(b))
    warped = Image.fromarray((base * 255).astype(np.uint8)).transform(
        (320, 240), Image.PERSPECTIVE, coeffs, Image.BICUBIC,
        fillcolor=int(0.9 * 255))
    return np.asarray(warped, np.float32) / 255.0


@pytest.fixture(scope="module")
def boards():
    """An axis-aligned board (tie-rich: its saddle responses repeat bit
    for bit), two perspective-warped ones, one with noise, and a blank."""
    rng = np.random.default_rng(5)
    aligned = _render_board()
    noisy = np.clip(_warped_board(rng) + rng.normal(0, 0.03, (240, 320)),
                    0, 1).astype(np.float32)
    return {"aligned": aligned, "warped0": _warped_board(rng),
            "warped1": _warped_board(rng), "noisy": noisy,
            "blank": np.full((240, 320), 0.5, np.float32)}


@pytest.mark.parametrize("name", ["aligned", "warped0", "warped1", "noisy",
                                  "blank"])
def test_chessboard_corners_match_jax(boards, name):
    """Found flags equal; where found, every corner within 0.05 px; the
    saddle response within 1e-5 of its largest value."""
    img = boards[name]
    cj, fj = jcb.find_chessboard_corners(jnp.asarray(img), NX, NY)
    ct, ft = tcb.find_chessboard_corners(T(img), NX, NY)
    assert bool(ft) == bool(fj)
    assert bool(ft) == (name != "blank")
    if bool(fj):
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0,
                                   atol=0.05)
    rj = np.asarray(jcb.saddle_response(jnp.asarray(img)))
    rt = tcb.saddle_response(T(img)).numpy()
    np.testing.assert_allclose(rt, rj, rtol=0,
                               atol=1e-5 * max(np.abs(rj).max(), 1e-12))


def test_nms_candidates_keep_the_lower_index_on_ties(boards):
    """The aligned board's candidates: the same positions, values and
    order as JAX's lax.top_k (lower index first among equal values)."""
    resp = np.asarray(jcb.saddle_response(jnp.asarray(boards["aligned"])))
    xj, vj, okj = jcb._nms_candidates(jnp.asarray(resp), 256)
    xt, vt, okt = tcb._nms_candidates(T(resp), 256)
    n = int(np.asarray(okj).sum())
    assert int(okt.sum()) == n > NX * NY
    np.testing.assert_array_equal(xt.numpy()[:n], np.asarray(xj)[:n])
    np.testing.assert_array_equal(vt.numpy()[:n], np.asarray(vj)[:n])


# ---- calibration -----------------------------------------------------------

CFG = dict(lm_iters=60)


@pytest.fixture(scope="module")
def views():
    """tests/test_calibration.py's _synth_views: 12 views, ideal and with
    distortion (k1 0.08, k2 −0.02), and the ideal set with view 3 garbage
    and masked."""
    rng = np.random.default_rng(1234)
    obj, ideal, _ = _synth_views(rng, 12)
    _, dist, _ = _synth_views(rng, 12, dist=np.array([0.08, -0.02, 0, 0, 0]))
    bad = ideal.copy()
    bad[3] = rng.uniform(0, 640, ideal[3].shape)
    vv = np.ones(12, bool)
    vv[3] = False
    return obj, {"ideal": (ideal, None), "distorted": (dist, None),
                 "masked": (bad, vv)}


@pytest.mark.parametrize("case", ["ideal", "distorted", "masked"])
def test_calibrate_camera_matches_jax(views, case):
    """K within 1e-3 relative, distortion within 1e-3, RMS within 1e-3 px,
    ok equal; K within test_calibration.py's bounds of the truth."""
    obj, sets = views
    pts, vv = sets[case]
    ref = jcal.calibrate_camera(
        jnp.asarray(obj), jnp.asarray(pts),
        view_valid=None if vv is None else jnp.asarray(vv),
        config=JCalibConfig(**CFG))
    got = tcal.calibrate_camera(
        tcal.planar_grid(NX, NY), T(pts),
        view_valid=None if vv is None else T(vv), config=CalibConfig(**CFG))
    assert bool(got.ok) == bool(ref.ok) is True
    Kj = np.asarray(ref.camera.K)
    Kt = got.camera.K.numpy()
    np.testing.assert_allclose(Kt, Kj, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.camera.dist.numpy(),
                               np.asarray(ref.camera.dist), rtol=0, atol=1e-3)
    assert abs(float(got.rms) - float(ref.rms)) <= 1e-3
    assert Kt[0, 0] == pytest.approx(K_TRUE[0, 0], rel=0.02)
    assert Kt[0, 2] == pytest.approx(K_TRUE[0, 2], abs=3.0)


def test_planar_grid_matches_jax():
    np.testing.assert_array_equal(tcal.planar_grid(NX, NY, 2.5).numpy(),
                                  np.asarray(jcal.planar_grid(NX, NY, 2.5)))


def test_calibrate_from_images_refusals_match_jax(boards):
    """Fewer than min_images, and views without a grid: ValueError with
    JAX's messages; format_report prints the same lines."""
    few = [boards["aligned"]] * 3
    msgs = []
    for pipe, kw in ((jpipe, {}), (tpipe, {"device": "cpu"})):
        with pytest.raises(ValueError) as e:
            pipe.calibrate_from_images(few, (NX, NY), **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "needs >= 10" in msgs[0]
    blanks = [boards["blank"]] * 12
    msgs = []
    for pipe, kw in ((jpipe, {}), (tpipe, {"device": "cpu"})):
        with pytest.raises(ValueError) as e:
            pipe.calibrate_from_images(blanks, (NX, NY), **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "detectable" in msgs[0]
    res = tcal.CalibrationResult(
        camera=CameraModel(K=T(K_TRUE.astype(np.float32)),
                           dist=torch.zeros(5)),
        rvecs=torch.zeros(1, 3), tvecs=torch.zeros(1, 3),
        rms=torch.tensor(0.125), ok=torch.tensor(True))
    jres = jcal.CalibrationResult(
        camera=JCameraModel(K=jnp.asarray(K_TRUE, jnp.float32),
                            dist=jnp.zeros(5, jnp.float32)),
        rvecs=jnp.zeros((1, 3)), tvecs=jnp.zeros((1, 3)),
        rms=jnp.float32(0.125), ok=jnp.bool_(True))
    assert tpipe.format_report(res) == jpipe.format_report(jres)


def test_entry_points_default_to_the_card(boards):
    """Without a card, calibrate_from_images and the undistortion of host
    frames raise rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    from cubesat_apds_tpu_torch.ops.warp import undistort_frames

    with pytest.raises((AssertionError, RuntimeError)):
        tpipe.calibrate_from_images([boards["aligned"]] * 10, (NX, NY))
    with pytest.raises((AssertionError, RuntimeError)):
        undistort_frames(np.zeros((2, 24, 32), np.float32),
                         CameraModel.ideal(30.0, 30.0, 16.0, 12.0))
