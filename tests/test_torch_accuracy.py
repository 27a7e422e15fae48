"""The port's mission metric against the JAX package on the CPU: the
warp and camera functions (ops/warp.py, core/camera.py), the attitude
outputs (core/attitude.py), the known-pose scene synthesis
(utils/synthetic.py), the accuracy runner (utils/accuracy.py), and the
whole slice — a rendered frame through both packages' localize_frame
against one store — on a planar and a 60 m-relief terrain scene.

The same seeded numpy inputs go through both packages; each test states
its tolerance. The scenes are cut to a 512² mosaic and 256² frames at
750 m altitude and focal 750 px (1 m GSD, the reference runner's field of
view) so that they fit the test budget; the full-size runs (1024²/512²)
are chip_smoke.py's accuracy phase.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubesat_apds_tpu.core import attitude as jatt
from cubesat_apds_tpu.core import camera as jcam
from cubesat_apds_tpu.core.config import AkazeConfig as JAkazeConfig
from cubesat_apds_tpu.core.config import MatchConfig as JMatchConfig
from cubesat_apds_tpu.core.config import PipelineConfig as JPipelineConfig
from cubesat_apds_tpu.core.config import PnPConfig as JPnPConfig
from cubesat_apds_tpu.core.config import RansacConfig as JRansacConfig
from cubesat_apds_tpu.core.types import CameraModel as JCameraModel
from cubesat_apds_tpu.ops import warp as jwarp
from cubesat_apds_tpu.ops.geometry.rodrigues import (
    rodrigues_to_matrix as jrodrigues)
from cubesat_apds_tpu.pipelines.localize import localize_frame as jlocalize
from cubesat_apds_tpu.utils import synthetic as JS
from cubesat_apds_tpu_torch.core import attitude as tatt
from cubesat_apds_tpu_torch.core import camera as tcam
from cubesat_apds_tpu_torch.core.config import (
    AkazeConfig, MatchConfig, PipelineConfig, PnPConfig, RansacConfig)
from cubesat_apds_tpu_torch.core.types import CameraModel
from cubesat_apds_tpu_torch.ops import warp as twarp
from cubesat_apds_tpu_torch.pipelines.localize import (
    localize_frame as tlocalize)
from cubesat_apds_tpu_torch.pipelines.preprocess import preprocess
from cubesat_apds_tpu_torch.utils import accuracy as A
from cubesat_apds_tpu_torch.utils import synthetic as TS

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
K = np.array([[120.0, 0.5, 41.0], [0.0, 118.0, 29.0], [0.0, 0.0, 1.0]],
             np.float32)
DIST = np.array([0.08, -0.02, 0.001, -0.002, 0.01], np.float32)


def _cams():
    return (JCameraModel(K=jnp.asarray(K), dist=jnp.asarray(DIST)),
            CameraModel(K=torch.from_numpy(K), dist=torch.from_numpy(DIST)))


def _render(h=60, w=80, seed=0):
    """Rectangles over a gradient: sharp edges and smooth ramps."""
    rng = np.random.default_rng(seed)
    img = np.add.outer(np.linspace(0, 0.3, h), np.linspace(0, 0.2, w))
    for _ in range(20):
        y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
        img[y:y + 8, x:x + 8] = rng.uniform(0.3, 1.0)
    return img.astype(np.float32)


# ---- warp and camera -------------------------------------------------------


@pytest.mark.parametrize("channels", [None, 3])
def test_bilinear_sample_matches_jax(channels):
    """Bit-equal (tolerance 1e-5 stated, 0 measured), out-of-bounds taps
    (negative coordinates included) taking fill_value."""
    rng = np.random.default_rng(1)
    img = _render()
    if channels:
        img = np.stack([img, img[::-1], 1 - img], -1)
    co = rng.uniform(-5.0, 85.0, (30, 40, 2)).astype(np.float32)
    want = np.asarray(jwarp.bilinear_sample(jnp.asarray(img),
                                            jnp.asarray(co), 0.3))
    got = twarp.bilinear_sample(torch.from_numpy(img), torch.from_numpy(co),
                                0.3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[(co[..., 0] < -1) | (co[..., 1] < -1)],
                               0.3, rtol=0, atol=1e-6)


def test_warp_perspective_matches_jax():
    """An out-of-bounds border included. With a perspective H whose float32
    inverse is exact, the two packages sample the same points: within
    1e-5. With general H, JAX's float32 inverse (XLA's triangular solve)
    and torch's (LAPACK) differ by ~1 ulp, which moves a sampling point
    by ~1e-5 px: within 1e-4 at the image's sharp edges (gradient ≤ 1
    a px), the mean within 1e-6."""
    img = _render()
    exact = np.array([[2.0, 0.0, -8.0], [0.0, 0.5, 4.0],
                      [2.0 ** -10, 0.0, 1.0]], np.float32)
    want = np.asarray(jwarp.warp_perspective(jnp.asarray(img),
                                             jnp.asarray(exact), (70, 90),
                                             0.25))
    got = twarp.warp_perspective(torch.from_numpy(img),
                                 torch.from_numpy(exact), (70, 90),
                                 0.25).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got == 0.25).any() and (got != 0.25).any()
    rng = np.random.default_rng(2)
    for _ in range(4):
        H = (np.array([[1.02, 0.05, -7.3], [-0.03, 0.97, 4.1],
                       [1e-4, -2e-4, 1.0]])
             + rng.normal(0, 0.01, (3, 3)) * [[1, 1, 100], [1, 1, 100],
                                             [1e-3, 1e-3, 0]])
        H = H.astype(np.float32)
        want = np.asarray(jwarp.warp_perspective(jnp.asarray(img),
                                                 jnp.asarray(H), (70, 90)))
        got = twarp.warp_perspective(torch.from_numpy(img),
                                     torch.from_numpy(H), (70, 90)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        assert np.abs(got - want).mean() < 1e-6


def test_undistort_grid_image_and_frames_match_jax():
    """undistort_image_grid, undistort_image (with and without a given
    grid) and the batched undistort_frames, [B, H, W] and [B, H, W, C]:
    within 1e-5 (bit-equal measured)."""
    jc, tc = _cams()
    want = np.asarray(jcam.undistort_image_grid((60, 80), jc))
    grid = tcam.undistort_image_grid((60, 80), tc)
    np.testing.assert_allclose(grid.numpy(), want, rtol=0, atol=1e-5)
    img = _render()
    np.testing.assert_allclose(
        twarp.undistort_image(torch.from_numpy(img), tc).numpy(),
        np.asarray(jwarp.undistort_image(jnp.asarray(img), jc)),
        rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        twarp.undistort_image(torch.from_numpy(img), tc, grid).numpy(),
        np.asarray(jwarp.undistort_image(jnp.asarray(img), jc)),
        rtol=0, atol=1e-5)
    frames = np.stack([_render(seed=s) for s in range(4)])
    for f in (frames, np.stack([frames, 1 - frames], -1)):
        got = twarp.undistort_frames(torch.from_numpy(f), tc).numpy()
        want = np.asarray(jwarp.undistort_frames(jnp.asarray(f), jc))
        assert got.shape == want.shape == f.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_project_points_matches_jax():
    """Batched views, with and without distortion: pixels within 1e-5
    relative (the Rodrigues matrices differ by ≤ 1 float32 ulp), depths
    within 1e-5."""
    rng = np.random.default_rng(3)
    obj = (rng.normal(0, 1, (2, 20, 3)) + [0, 0, 8]).astype(np.float32)
    rv = rng.normal(0, 0.3, (2, 3)).astype(np.float32)
    tv = rng.normal(0, 1, (2, 3)).astype(np.float32)
    for dist in (None, DIST):
        pj, zj = jcam.project_points(
            jnp.asarray(obj), jnp.asarray(rv), jnp.asarray(tv),
            jnp.asarray(K), None if dist is None else jnp.asarray(dist))
        pt, zt = tcam.project_points(
            torch.from_numpy(obj), torch.from_numpy(rv), torch.from_numpy(tv),
            torch.from_numpy(K), None if dist is None else torch.from_numpy(dist))
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0,
                                   atol=1e-5)


# ---- attitude --------------------------------------------------------------


def test_attitude_matches_jax():
    """The numpy functions give the same numbers (1e-12). pose_to_attitude
    goes through each package's float32 Rodrigues, which differ by ≤ 1
    ulp: quaternion within 1e-6, Euler angles within 1e-4°, position
    within 2e-7 of |t| (ECEF-sized here)."""
    rng = np.random.default_rng(4)
    rv = rng.normal(0, 1, (50, 3))
    R = np.asarray(jrodrigues(jnp.asarray(rv)), np.float64)
    for fn in ("rotation_to_quaternion", "matrix_to_euler_zyx"):
        np.testing.assert_allclose(getattr(tatt, fn)(R),
                                   getattr(jatt, fn)(R), rtol=0, atol=1e-12)
    q = jatt.rotation_to_quaternion(R)
    np.testing.assert_allclose(tatt.quaternion_to_matrix(q),
                               jatt.quaternion_to_matrix(q), rtol=0,
                               atol=1e-12)
    tv = rng.normal(0, 1e6, (50, 3))
    want = jatt.pose_to_attitude(rv, tv)
    got = tatt.pose_to_attitude(rv, tv)
    np.testing.assert_allclose(got["quat_wxyz"], want["quat_wxyz"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got["euler_zyx_deg"], want["euler_zyx_deg"],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        got["position"], want["position"], rtol=0,
        atol=2e-7 * np.abs(tv).max() * 3)


# ---- synthetic scenes ------------------------------------------------------


@pytest.fixture(scope="module")
def planar_world():
    """One 512² rects world, made by each package's copy from one seed."""
    out = []
    for S in (JS, TS):
        rng = np.random.default_rng(7)
        plane = S.PlaneDem(h0=120.0, gu=0.02, gv=-0.01)
        mosaic = S.make_mosaic(rng, size=512)
        out.append((mosaic, plane, S.make_dem(plane, 512)))
    return out


def test_scene_synthesis_is_the_same_numpy(planar_world):
    """make_mosaic, make_dem, make_fractal_dem, make_camera and
    true_homography: the same numbers (host float64 numpy in both)."""
    (jm, jp, jd), (tm, tp, td) = planar_world
    np.testing.assert_array_equal(tm.bands, jm.bands)
    np.testing.assert_array_equal(td.bands, jd.bands)
    np.testing.assert_array_equal(tm.geotransform, jm.geotransform)
    for tex in ("natural",):
        a = JS.make_mosaic(np.random.default_rng(3), 128, texture=tex)
        b = TS.make_mosaic(np.random.default_rng(3), 128, texture=tex)
        np.testing.assert_array_equal(a.bands, b.bands)
    a = JS.make_fractal_dem(np.random.default_rng(5), 512, relief_m=60.0)
    b = TS.make_fractal_dem(np.random.default_rng(5), 512, relief_m=60.0)
    np.testing.assert_array_equal(a.heights, b.heights)
    kw = dict(target_px=(250.0, 270.0), altitude_m=750.0, focal_px=750.0,
              frame=256, off_nadir_deg=12.0, yaw_deg=25.0)
    cj = JS.make_camera(jm.geotransform, jp, **kw)
    ct = TS.make_camera(tm.geotransform, tp, **kw)
    np.testing.assert_array_equal(ct.R, cj.R)
    np.testing.assert_array_equal(ct.C, cj.C)
    np.testing.assert_array_equal(
        TS.true_homography(tm.geotransform, tp, ct, 512),
        JS.true_homography(jm.geotransform, jp, cj, 512))


def test_render_frame_matches_jax(planar_world):
    """The planar render through each package's warp_perspective, with
    noise, gain and gamma: H_true the same numbers; frames within 1e-4
    at the mosaic's sharp edges and 1e-6 on average (the ~1-ulp float32
    inverse of H, test_warp_perspective_matches_jax); bit-equal
    photometric steps."""
    (jm, jp, _), (tm, tp, _) = planar_world
    kw = dict(target_px=(250.0, 270.0), altitude_m=750.0, focal_px=750.0,
              frame=256, off_nadir_deg=12.0, yaw_deg=25.0)
    cj = JS.make_camera(jm.geotransform, jp, **kw)
    ct = TS.make_camera(tm.geotransform, tp, **kw)
    rend = dict(noise_sigma=0.02, gain=0.85, gamma=1.3)
    fj, Hj = JS.render_frame(jm.bands[0] / 255.0, jm.geotransform, jp, cj,
                             rng=np.random.default_rng(9), **rend)
    ft, Ht = TS.render_frame(tm.bands[0] / 255.0, tm.geotransform, tp, ct,
                             rng=np.random.default_rng(9), device="cpu",
                             **rend)
    np.testing.assert_array_equal(Ht, Hj)
    assert ft.dtype == fj.dtype == np.float32 and ft.shape == (256, 256)
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-4)
    assert np.abs(ft - fj).mean() < 1e-6


def test_render_terrain_and_error_metrics_are_the_same_numpy():
    """render_frame_terrain (host float64 ray–DEM intersection) and every
    error metric give identical numbers; pose_errors goes through each
    package's float32 Rodrigues (≤ 1 ulp apart): 1e-4° and 1e-6 of the
    camera distance."""
    rng = np.random.default_rng(17)
    mosaic = TS.make_mosaic(rng, size=256, texture="natural")
    dem_j = JS.make_fractal_dem(np.random.default_rng(18), 256, relief_m=60.0)
    dem_t = TS.make_fractal_dem(np.random.default_rng(18), 256, relief_m=60.0)
    kw = dict(target_px=(128.0, 120.0), altitude_m=750.0, focal_px=750.0,
              frame=96, off_nadir_deg=20.0, azimuth_deg=-60.0)
    cj = JS.make_camera(mosaic.geotransform, dem_j, **kw)
    ct = TS.make_camera(mosaic.geotransform, dem_t, **kw)
    gray = mosaic.bands[0] / 255.0
    fj = JS.render_frame_terrain(gray, mosaic.geotransform, dem_j, cj,
                                 noise_sigma=0.01, gamma=1.2,
                                 rng=np.random.default_rng(1))
    ft = TS.render_frame_terrain(gray, mosaic.geotransform, dem_t, ct,
                                 noise_sigma=0.01, gamma=1.2,
                                 rng=np.random.default_rng(1))
    np.testing.assert_array_equal(ft, fj)
    H = np.array([[1.0, 0.01, 3.0], [0.02, 0.99, -2.0], [1e-5, 0.0, 1.0]])
    assert TS.footprint_error_terrain_m(H, ct, mosaic.geotransform, dem_t) \
        == JS.footprint_error_terrain_m(H, cj, mosaic.geotransform, dem_j)
    assert TS.footprint_error_m(H, np.linalg.inv(H) @ H, ct) \
        == JS.footprint_error_m(H, np.linalg.inv(H) @ H, cj)
    assert TS.attitude_error_deg(ct.R.T, cj.R) \
        == JS.attitude_error_deg(cj.R.T, cj.R)
    assert TS.position_error_m(ct.C, cj.C + 1.0) \
        == JS.position_error_m(cj.C, cj.C + 1.0)
    rv = np.array([0.1, -0.2, 0.3])
    tv = -cj.R @ cj.C
    att_t, pos_t = TS.pose_errors(rv, tv, ct)
    att_j, pos_j = JS.pose_errors(rv, tv, cj)
    assert abs(att_t - att_j) < 1e-4
    assert abs(pos_t - pos_j) < 1e-6 * np.linalg.norm(cj.C)


# ---- the accuracy runner ---------------------------------------------------


def _jax_runner():
    spec = importlib.util.spec_from_file_location(
        "bench_accuracy", REPO / "benchmarks" / "bench_accuracy.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# The summary keys the JAX runner builds (benchmarks/bench_accuracy.py:
# run's agg at :151-163, run_terrain's at :253-269).
RUN_KEYS = {"ok_rate", "att_med", "att_p90", "pos_med", "pos_p90", "fp_med",
            "inl_med"}
TERRAIN_KEYS = RUN_KEYS - {"inl_med"} | {"pnp_inl_med"}


def test_accuracy_runner_keys_and_conditions():
    """The port's runner at a small size (512² mosaic, 256² frames,
    capacity 512; one scene per condition, one relief): the JAX runner's
    conditions, constants, mode configs and result keys; every frame
    localized; the fast and hybrid modes run too, each with its own DB."""
    ref = _jax_runner()
    assert A.CONDITIONS == ref.CONDITIONS
    assert A.TERRAIN_CONDITIONS == ref.TERRAIN_CONDITIONS
    assert A.TERRAIN_RELIEFS == ref.TERRAIN_RELIEFS
    assert (A.ALTITUDE, A.MOSAIC, A.FRAME) == (ref.ALTITUDE, ref.MOSAIC,
                                               ref.FRAME)
    for cond in ("nominal", "oblique20"):
        assert (A._cond_rng(2026, cond, 60).random(3)
                == ref._cond_rng(2026, cond, 60).random(3)).all()
    small = dict(device="cpu", mosaic_size=512, frame_size=256, capacity=512,
                 progress=lambda s: None)
    for mode in ("exact", "fast", "hybrid"):
        got_cfg, ref_cfg = A.mode_config(mode), ref.mode_config(mode)
        assert got_cfg.akaze.descriptor_tag == ref_cfg.akaze.descriptor_tag
        assert got_cfg.akaze.orientation_mode == \
            ref_cfg.akaze.orientation_mode
    res = A.run(1, modes=("exact", "fast", "hybrid"), **small)
    assert set(res) == {"exact", "fast", "hybrid"}
    for mode in res:
        assert set(res[mode]) == set(ref.CONDITIONS)
        for agg in res[mode].values():
            assert set(agg) == RUN_KEYS
            assert agg["ok_rate"] == 1.0 and agg["inl_med"] > 20
    ter = A.run_terrain(1, reliefs=(60.0,), **small)
    assert set(ter) == {"relief60"}
    assert set(ter["relief60"]["exact"]) == set(ref.TERRAIN_CONDITIONS)
    for agg in ter["relief60"]["exact"].values():
        assert set(agg) == TERRAIN_KEYS
    with pytest.raises(ValueError, match="unknown descriptor mode"):
        A.run(1, modes=("exact", "approx"), **small)


# ---- the slice: a rendered frame through both packages ---------------------

CAP = 512
JCFG = JPipelineConfig(akaze=JAkazeConfig(capacity=CAP, detect_topk="exact"),
                       match=JMatchConfig(ratio=0.75),
                       ransac=JRansacConfig(num_hypotheses=128),
                       pnp=JPnPConfig(num_hypotheses=64))
TCFG = PipelineConfig(akaze=AkazeConfig(capacity=CAP),
                      match=MatchConfig(ratio=0.75),
                      ransac=RansacConfig(num_hypotheses=128),
                      pnp=PnPConfig(num_hypotheses=64))
SCENE = dict(altitude_m=750.0, focal_px=750.0, frame=256)


def _localize_both(frame, store, cam):
    Kf = cam.K.astype(np.float32)
    got = tlocalize(frame, store,
                    CameraModel(K=torch.from_numpy(Kf), dist=torch.zeros(5)),
                    config=TCFG, solve_pose=True, device="cpu")
    ref = jlocalize(frame, store,
                    JCameraModel(K=jnp.asarray(Kf),
                                 dist=jnp.zeros(5, jnp.float32)),
                    config=JCFG, solve_pose=True)
    return got, ref


@pytest.fixture(scope="module")
def slice_runs():
    """Per scene: the port's and JAX's localize_frame on one frame against
    one store (built once per world by the port's preprocess on the CPU).
    Planar: a 512² rects world, three nadir scenes. Terrain: a 512²
    natural-texture world over 60 m of fractal relief, two nadir scenes
    and one 20° oblique (tests/test_accuracy.py's scene mix)."""
    runs = {"planar": [], "terrain": []}
    mosaic, plane, ds = A.build_world(7, "rects", device="cpu",
                                      mosaic_size=512)
    store, _ = preprocess(ds, config=TCFG, amount_lod=1)
    gray = mosaic.bands[0] / 255.0
    for target in ((256.0, 256.0), (220.0, 290.0), (290.0, 215.0)):
        cam = TS.make_camera(mosaic.geotransform, plane, target_px=target,
                             **SCENE)
        frame, H_true = TS.render_frame(gray, mosaic.geotransform, plane, cam,
                                        device="cpu")
        got, ref = _localize_both(frame, store, cam)
        fp = [TS.footprint_error_m(np.asarray(r.homography.H, np.float64),
                                   H_true, cam) for r in (got, ref)]
        runs["planar"].append((got, ref, cam, fp))
    mosaic, dem, ds = A.build_terrain_world(17, 60.0, "natural", device="cpu",
                                            mosaic_size=512)
    store, _ = preprocess(ds, config=TCFG, amount_lod=1)
    gray = mosaic.bands[0] / 255.0
    for target, off in (((256.0, 256.0), 0.0), ((220.0, 290.0), 0.0),
                        ((256.0, 256.0), 20.0)):
        cam = TS.make_camera(mosaic.geotransform, dem, target_px=target,
                             off_nadir_deg=off, azimuth_deg=-60.0, **SCENE)
        frame = TS.render_frame_terrain(gray, mosaic.geotransform, dem, cam)
        got, ref = _localize_both(frame, store, cam)
        fp = [TS.footprint_error_terrain_m(
            np.asarray(r.homography.H, np.float64), cam, mosaic.geotransform,
            dem) for r in (got, ref)]
        runs["terrain"].append((got, ref, cam, fp))
    return runs


def _rot_deg(rv_a, rv_b):
    Ra = np.asarray(jrodrigues(np.asarray(rv_a, np.float64)))
    Rb = np.asarray(jrodrigues(np.asarray(rv_b, np.float64)))
    c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


@pytest.mark.parametrize("world,bounds", [
    ("planar", dict(att=1.0, pos=25.0, fp=3.0)),
    ("terrain", dict(att=1.5, pos=35.0, fp_max_above=0.3)),
])
def test_slice_accuracy_matches_jax(slice_runs, world, bounds):
    """Both packages localize every scene (ok flags equal), their
    rotations agree within 0.5° (they draw different RANSAC hypotheses;
    tests/test_torch_localize.py's rule), and both meet
    tests/test_accuracy.py's bounds on the medians: planar attitude
    < 1.0°, position < 25 m, footprint < 3 m; terrain attitude < 1.5°,
    position < 35 m, and the planar homography's largest footprint error
    > 0.3 m (parallax makes it wrong)."""
    errs = {"port": [], "jax": []}
    for got, ref, cam, fp in slice_runs[world]:
        assert bool(got.pose.ok) == bool(ref.pose.ok)
        assert bool(got.pose.ok) and bool(got.homography.ok)
        assert _rot_deg(got.pose.rvec.numpy(), ref.pose.rvec) <= 0.5
        for key, res, f in (("port", got, fp[0]), ("jax", ref, fp[1])):
            att, pos = TS.pose_errors(np.asarray(res.pose.rvec),
                                      np.asarray(res.pose.tvec), cam)
            errs[key].append((att, pos, f))
    for key, e in errs.items():
        att, pos, fp = np.array(e).T
        assert np.median(att) < bounds["att"], (key, att)
        assert np.median(pos) < bounds["pos"], (key, pos)
        if "fp" in bounds:
            assert np.median(fp) < bounds["fp"], (key, fp)
        else:
            assert fp.max() > bounds["fp_max_above"], (key, fp)


def test_entry_points_default_to_the_card():
    """Without a card, the renders and the runner raise rather than fall
    back to the CPU (callers name device="cpu", as these tests do)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    mosaic = TS.make_mosaic(np.random.default_rng(0), size=128)
    plane = TS.PlaneDem()
    cam = TS.make_camera(mosaic.geotransform, plane, target_px=(64.0, 64.0),
                         altitude_m=750.0, focal_px=750.0, frame=32)
    with pytest.raises((AssertionError, RuntimeError)):
        TS.render_frame(mosaic.bands[0] / 255.0, mosaic.geotransform, plane,
                        cam)
    with pytest.raises((AssertionError, RuntimeError)):
        A.run(1, mosaic_size=256, frame_size=128, capacity=256,
              progress=lambda s: None)
