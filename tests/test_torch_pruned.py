"""The port's spatially pruned serving path against the JAX package, on the
256² scene of tests/test_pruned.py with its DB made with numpy, so that both
packages get the same bytes. Both back halves take the same features (the
port's, of the rolled frame): the row table, the cell index and the window's
rows are compared bit for bit, the fine result within stated tolerances
(the packages draw different RANSAC hypotheses).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubesat_apds_tpu.core.config import MatchConfig as JMatchConfig
from cubesat_apds_tpu.core.config import PipelineConfig as JPipelineConfig
from cubesat_apds_tpu.core.config import PnPConfig as JPnPConfig
from cubesat_apds_tpu.core.config import RansacConfig as JRansacConfig
from cubesat_apds_tpu.core.types import CameraModel as JCameraModel
from cubesat_apds_tpu.core.types import Features as JFeatures
from cubesat_apds_tpu.core.types import Keypoints as JKeypoints
from cubesat_apds_tpu.pipelines import localize as jloc
from cubesat_apds_tpu_torch import convert
from cubesat_apds_tpu_torch.core.config import (
    AkazeConfig, MatchConfig, PipelineConfig, PnPConfig, RansacConfig)
from cubesat_apds_tpu_torch.core.types import CameraModel
from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute
from cubesat_apds_tpu_torch.pipelines import localize as tloc

torch.set_num_threads(2)

N, CAP, M = 256, 512, 4096
CAM = (200.0, 200.0, 128.0, 128.0)
TCFG = PipelineConfig(akaze=AkazeConfig(capacity=CAP),
                      match=MatchConfig(ratio=0.75),
                      ransac=RansacConfig(num_hypotheses=64),
                      pnp=PnPConfig(num_hypotheses=32))
JCFG = JPipelineConfig(match=JMatchConfig(ratio=0.75),
                       ransac=JRansacConfig(num_hypotheses=64),
                       pnp=JPnPConfig(num_hypotheses=32))
MARGIN = 0.25


@pytest.fixture(scope="module")
def scene():
    """tests/test_pruned.py's scene: a 256² frame rolled by (4, 7) and a
    4,096-row DB whose first 512 rows are the features of the unrolled
    image (the port's, exact mode), the rest uniform random bytes at xy
    uniform over [0, 2048)²; obj = (0.1·xy, 0); coarse DB = every 4th
    row. Also the port's features of the frame, the query side of both
    packages' back halves."""
    rng = np.random.default_rng(3)
    img = np.zeros((N, N), np.float32)
    for _ in range(60):
        cy, cx = rng.integers(6, N - 30, 2)
        s = int(rng.integers(6, 24))
        img[cy:cy + s, cx:cx + s] = rng.uniform(0.2, 1.0)
    frame = np.roll(img, (4, 7), axis=(0, 1))
    db_feats = detect_and_compute(torch.from_numpy(img), TCFG.akaze)
    desc = rng.integers(0, 256, (M, 61), dtype=np.uint8)
    xy = rng.uniform(0.0, 2048.0, (M, 2)).astype(np.float32)
    valid = np.ones(M, bool)
    desc[:CAP] = db_feats.descriptors.numpy()
    xy[:CAP] = db_feats.keypoints.xy.numpy()
    valid[:CAP] = db_feats.keypoints.valid.numpy()
    obj = np.concatenate([xy * 0.1, np.zeros((M, 1))], 1).astype(np.float32)
    db = {"descriptors": desc, "xy": xy, "valid": valid, "obj_points": obj,
          "has_world": True, "world_frame": "local"}
    coarse = {k: (v[::4] if isinstance(v, np.ndarray) else v)
              for k, v in db.items()}
    feats = detect_and_compute(torch.from_numpy(frame), TCFG.akaze)
    return frame, db, coarse, feats


def _tdb(d):
    return convert.device_db_from(d, device="cpu")


def _jdb(d):
    return jloc.DeviceDb(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                                else v) for k, v in d.items()})


def _jfeats(feats):
    kp = convert.to_numpy(feats.keypoints)
    return JFeatures(keypoints=JKeypoints(**{k: jnp.asarray(v)
                                             for k, v in kp.items()}),
                     descriptors=jnp.asarray(feats.descriptors.numpy()))


@pytest.fixture(scope="module")
def pruned(scene):
    """Both packages' pruned DBs (capacity 1024) and back-half results
    (the port's with PnP; JAX's without, which its eager PnP would take
    half a minute to trace)."""
    frame, db, coarse, feats = scene
    tp = tloc.make_pruned_db(_tdb(db), _tdb(coarse), window_capacity=1024)
    jp = jloc.make_pruned_db(_jdb(db), _jdb(coarse), window_capacity=1024)
    tres = tloc._pruned_back_half(feats, (N, N), tp, CameraModel.ideal(*CAM),
                                  TCFG, True, MARGIN)
    jres = jloc._pruned_back_half(_jfeats(feats), (N, N), jp,
                                  JCameraModel.ideal(*CAM), JCFG, False,
                                  MARGIN)
    return tp, jp, tres, jres


def _inlier_ids(res, sel=None):
    """Global row ids of the homography inliers among valid matches."""
    m = np.asarray(res.matches.valid) & np.asarray(res.homography.inliers)
    ids = np.asarray(res.matches.train_idx)[m]
    return set((np.asarray(sel)[ids] if sel is not None else ids).tolist())


def _jaccard(a, b):
    return len(a & b) / max(len(a | b), 1)


def test_row_packing_round_trip_and_jax(scene):
    """[M, 22] int32 rows: bit-exact with the JAX package's table, and
    unpacking gives back the descriptors, xy and obj bit for bit."""
    _, db, _, _ = scene
    t = _tdb(db)
    rows = tloc._pack_prune_rows(t.descriptors, t.xy, t.obj_points)
    jrows = jloc._pack_prune_rows(jnp.asarray(db["descriptors"]),
                                  jnp.asarray(db["xy"]),
                                  jnp.asarray(db["obj_points"]))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    for got, want in zip(tloc._unpack_prune_rows(rows),
                         (db["descriptors"], db["xy"], db["obj_points"])):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("field", ["rows", "order", "starts", "grid"])
def test_prune_index_matches_jax(pruned, field):
    """_build_prune_index: cell sort, CSR offsets and grid bit-exact."""
    tp, jp, _, _ = pruned
    np.testing.assert_array_equal(getattr(tp, field).numpy(),
                                  np.asarray(getattr(jp, field)))


def test_prune_index_all_invalid():
    """No valid row: the grid falls back to origin 0 and unit extent, and
    every row sorts to the sentinel cell, as in JAX."""
    rng = np.random.default_rng(0)
    desc = rng.integers(0, 256, (64, 61), dtype=np.uint8)
    xy = rng.uniform(0, 100, (64, 2)).astype(np.float32)
    obj = np.zeros((64, 3), np.float32)
    valid = np.zeros(64, bool)
    got = tloc._build_prune_index(torch.from_numpy(desc), torch.from_numpy(xy),
                                  torch.from_numpy(obj), torch.from_numpy(valid))
    ref = jloc._build_prune_index(desc, xy, obj, valid)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int(got[2][0]) == 0 and int(got[2][-2]) == 0


@pytest.mark.parametrize("capacity", [1024, 64])
def test_window_rows_match_jax(scene, capacity):
    """Fed JAX's own window, the port's window → rows step gives the same
    sel, n_window and overflow, bit for bit (capacity 64 overflows)."""
    _, db, coarse, feats = scene
    jp = jloc.make_pruned_db(_jdb(db), _jdb(coarse), window_capacity=capacity)
    jres = jloc._pruned_back_half(_jfeats(feats), (N, N), jp,
                                  JCameraModel.ideal(*CAM), JCFG, False,
                                  MARGIN)
    tp = tloc.make_pruned_db(_tdb(db), _tdb(coarse),
                             window_capacity=capacity)
    win = tloc.window_rows(tp, torch.from_numpy(np.array(jres.window)))
    np.testing.assert_array_equal(win.sel.numpy(), np.asarray(jres.sel))
    assert int(win.n_window) == int(jres.n_window)
    assert bool(win.overflow) == bool(jres.overflow) == (capacity == 64)
    ok = win.valid.numpy()
    assert (win.sel.numpy()[ok] < M).all() and (win.sel.numpy()[~ok] == M).all()
    np.testing.assert_array_equal(win.xy.numpy()[ok],
                                  db["xy"][win.sel.numpy()[ok]])


def test_pruned_matches_jax(pruned):
    """The port's pruned back half against JAX's on the same features:
    both coarse fixes ok, no overflow, H within 0.5 px, homography-inlier
    Jaccard by global row id ≥ 0.95."""
    _, _, t, j = pruned
    assert bool(t.coarse_ok) and bool(j.coarse_ok)
    assert not bool(t.overflow) and not bool(j.overflow)
    assert 0 < int(t.n_window) <= 1024
    np.testing.assert_allclose(t.result.homography.H.numpy(),
                               np.asarray(j.result.homography.H), atol=0.5)
    a = _inlier_ids(t.result, t.sel.numpy())
    b = _inlier_ids(j.result, np.asarray(j.sel))
    assert len(a) > 20 and _jaccard(a, b) >= 0.95


def test_pruned_matches_full_db(scene, pruned):
    """Pruning must not change the answer: against the port's full-DB step
    on the same features, H within 0.5 px, inlier Jaccard by global row
    id ≥ 0.95, rotation vectors within 0.05."""
    _, db, _, feats = scene
    _, _, t, _ = pruned
    full = tloc.localize_from_features(feats, _tdb(db), CameraModel.ideal(*CAM),
                                       TCFG, solve_pose=True)
    np.testing.assert_allclose(t.result.homography.H.numpy(),
                               full.homography.H.numpy(), atol=0.5)
    assert _jaccard(_inlier_ids(t.result, t.sel.numpy()),
                    _inlier_ids(full)) >= 0.95
    assert bool(t.result.pose.ok) and bool(full.pose.ok)
    np.testing.assert_allclose(t.result.pose.rvec.numpy(),
                               full.pose.rvec.numpy(), atol=5e-2)


def test_localize_frame_pruned_entry_point(scene, pruned):
    """localize_frame_pruned detects on the frame itself and gives the
    back half's result on those features (CPU runs are deterministic)."""
    frame, _, _, _ = scene
    tp, _, t, _ = pruned
    got = tloc.localize_frame_pruned(torch.from_numpy(frame), tp,
                                     CameraModel.ideal(*CAM), TCFG,
                                     solve_pose=True, margin=MARGIN)
    assert torch.equal(got.sel, t.sel) and torch.equal(got.window, t.window)
    assert torch.equal(got.result.homography.H, t.result.homography.H)


def test_pruned_overflow_flag(scene):
    """A window capacity far below the window's rows sets `overflow`;
    n_window counts in-window rows among the 64 selected slots."""
    _, db, coarse, feats = scene
    tp = tloc.make_pruned_db(_tdb(db), _tdb(coarse), window_capacity=64)
    res = tloc._pruned_back_half(feats, (N, N), tp, CameraModel.ideal(*CAM),
                                 TCFG, False, MARGIN)
    assert bool(res.overflow) and int(res.n_window) <= 64


def test_pruned_coarse_failure_is_reported(scene):
    """A coarse DB with no valid rows → coarse_ok False."""
    _, db, _, feats = scene
    bad = {"descriptors": np.zeros((256, 61), np.uint8),
           "xy": np.zeros((256, 2), np.float32), "valid": np.zeros(256, bool),
           "obj_points": np.zeros((256, 3), np.float32), "has_world": True,
           "world_frame": "local"}
    tp = tloc.make_pruned_db(_tdb(db), _tdb(bad), window_capacity=1024)
    res = tloc._pruned_back_half(feats, (N, N), tp, CameraModel.ideal(*CAM),
                                 TCFG, False, MARGIN)
    assert not bool(res.coarse_ok)


def test_pruned_fallback_equals_full_db(scene, pruned):
    """The row-table fallback rebuilds the full DB (in cell order) and
    gives the full-DB step's answer: the same number of matches, the same
    inlier rows by global id, H within 0.5 px."""
    frame, db, _, feats = scene
    tp, _, _, _ = pruned
    fb = tloc.localize_frame_pruned_fallback(torch.from_numpy(frame), tp,
                                             CameraModel.ideal(*CAM), TCFG,
                                             solve_pose=True)
    full = tloc.localize_from_features(feats, _tdb(db), CameraModel.ideal(*CAM),
                                       TCFG, solve_pose=True)
    assert bool(fb.homography.ok) and bool(full.homography.ok)
    assert int(fb.num_matches) == int(full.num_matches)
    np.testing.assert_allclose(fb.homography.H.numpy(),
                               full.homography.H.numpy(), atol=0.5)
    assert _inlier_ids(fb, tp.order.numpy()) == _inlier_ids(full)


def test_localizer_defaults_to_the_card(scene):
    """Localizer without a device puts the DB on the card: on a host with
    no card that raises instead of carrying on on the CPU."""
    _, db, _, _ = scene
    small = {k: (v[:64] if isinstance(v, np.ndarray) else v)
             for k, v in db.items()}
    tdb = _tdb(small)
    if torch.cuda.is_available():
        loc = tloc.Localizer(tdb, CameraModel.ideal(*CAM), TCFG)
        assert loc.db.descriptors.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tloc.Localizer(tdb, CameraModel.ideal(*CAM), TCFG)
        with pytest.raises((RuntimeError, AssertionError)):
            convert.device_db_from(small)
