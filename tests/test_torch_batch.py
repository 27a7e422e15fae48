"""The port's back half over a batch of frames: match, RANSAC homography
and PnP-RANSAC of B frames as single passes, against the JAX package's
vmapped batch steps (`_make_local_batch_step`, `_make_pruned_batch_step`,
`jax.vmap` of the RANSAC functions) and against the port's own B = 1 calls
(every row bit for bit).

The scene and DB are tests/test_torch_stream.py's (128² frames, capacity
256). Against JAX the features are in common: the JAX steps are handed
the port's features, and the RANSAC tests feed both packages JAX's draws.
The homography refits run one round here (the JAX package compiles each
round into the step; the port's rounds are the same code), so the file's
JAX compiles stay within its time budget.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubesat_apds_tpu.core.config import AkazeConfig as JAkazeConfig
from cubesat_apds_tpu.core.config import MatchConfig as JMatchConfig
from cubesat_apds_tpu.core.config import PipelineConfig as JPipelineConfig
from cubesat_apds_tpu.core.config import PnPConfig as JPnPConfig
from cubesat_apds_tpu.core.config import RansacConfig as JRansacConfig
from cubesat_apds_tpu.core.types import CameraModel as JCameraModel
from cubesat_apds_tpu.core.types import Features as JFeatures
from cubesat_apds_tpu.core.types import Keypoints as JKeypoints
from cubesat_apds_tpu.ops.features import akaze as jakaze
from cubesat_apds_tpu.ops.geometry import homography as jhom
from cubesat_apds_tpu.pipelines import localize as jloc
from cubesat_apds_tpu.pipelines import stream as jstream
from cubesat_apds_tpu_torch import convert
from cubesat_apds_tpu_torch.core.config import (
    AkazeConfig, MatchConfig, PipelineConfig, PnPConfig, RansacConfig)
from cubesat_apds_tpu_torch.core.types import (
    CameraModel, Correspondences, select)
from cubesat_apds_tpu_torch.ops import match as tmatch
from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute_batch
from cubesat_apds_tpu_torch.ops.geometry import homography as thom
from cubesat_apds_tpu_torch.ops.geometry import pnp as tpnp
from cubesat_apds_tpu_torch.ops.geometry import rodrigues as trod
from cubesat_apds_tpu_torch.pipelines import localize as tloc
from cubesat_apds_tpu_torch.pipelines.stream import _pack_outputs
from test_torch_stream import CAM, _frames, db  # noqa: F401 (fixture)

torch.set_num_threads(2)

MARGIN = 0.25
CFG = PipelineConfig(akaze=AkazeConfig(capacity=256),
                     match=MatchConfig(ratio=0.75),
                     ransac=RansacConfig(num_hypotheses=64, refine_iters=1),
                     pnp=PnPConfig(num_hypotheses=32))
JCFG = JPipelineConfig(akaze=JAkazeConfig(capacity=256, detect_topk="exact"),
                       match=JMatchConfig(ratio=0.75),
                       ransac=JRansacConfig(num_hypotheses=64, refine_iters=1),
                       pnp=JPnPConfig(num_hypotheses=32))
JCAM = JCameraModel.ideal(100.0, 100.0, 64.0, 64.0)


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


def _bits(t):
    """A tensor as its raw bits (float NaNs compare equal to themselves)."""
    if t.is_floating_point():
        return t.contiguous().view({2: torch.int16, 4: torch.int32,
                                    8: torch.int64}[t.element_size()])
    return t


def _equal(a, b, path=""):
    """Every tensor of two result dataclasses equal bit for bit; the
    first differing field's path, or None."""
    if isinstance(a, torch.Tensor):
        same = a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
        return None if same else path
    if a is None or b is None:
        return None if a is b else path
    for f in a.__dataclass_fields__:
        bad = _equal(getattr(a, f), getattr(b, f), f"{path}.{f}")
        if bad:
            return bad
    return None


@pytest.fixture(scope="module")
def batch(db):
    """Three frames — one rolled by 1 px, a blank frame, one rolled by
    2 px — their port features, and the DB as numpy for JAX."""
    fr = _frames(3)
    frames = np.stack([fr[1], np.zeros_like(fr[0]), fr[2]])
    feats = detect_and_compute_batch(torch.from_numpy(frames).float() / 255.0,
                                     CFG.akaze)
    jdb = jloc.DeviceDb(descriptors=jnp.asarray(db.descriptors.numpy()),
                        xy=jnp.asarray(db.xy.numpy()),
                        valid=jnp.asarray(db.valid.numpy()),
                        obj_points=jnp.asarray(db.obj_points.numpy()),
                        has_world=True, world_frame="local")
    return frames, feats, jdb


def _jfeats(feats):
    kp = convert.to_numpy(feats.keypoints)
    return JFeatures(keypoints=JKeypoints(**{k: jnp.asarray(v)
                                             for k, v in kp.items()}),
                     descriptors=jnp.asarray(feats.descriptors.numpy()))


def _run_jax_step(monkeypatch, make_step, frames, feats):
    """A JAX batch step run on the port's features (its extraction
    replaced by them), each packed row extended by the homography inlier
    mask: [B, 21 + N (+ 2 when pruned)]."""
    orig = jstream._pack_outputs
    monkeypatch.setattr(jakaze, "detect_and_compute_batch",
                        lambda frames, config: _jfeats(feats))
    monkeypatch.setattr(jstream, "_pack_outputs", lambda h, nm, nk, pose:
                        jnp.concatenate([orig(h, nm, nk, pose),
                                         h.inliers.astype(jnp.float32)]))
    return np.asarray(make_step()(jnp.asarray(frames)))


def _check_rows(packed, jpacked, res, n):
    """The port's batched result (packed [B, 21+], LocalizationResult)
    against the JAX step's rows: match and keypoint counts equal, ok flags
    equal, homography-inlier Jaccard by query slot ≥ 0.95 and H within
    0.5 px at the frame's corners where both are ok; the blank row (1)
    failed closed."""
    corners = np.array([[0, 0, 1], [128, 0, 1], [0, 128, 1], [128, 128, 1]],
                       np.float64)
    for b in range(3):
        np.testing.assert_array_equal(packed[b, 11:13], jpacked[b, 11:13])
        assert packed[b, 9] == jpacked[b, 9], b
        if b == 1:
            assert packed[b, 9] == 0 and packed[b, 11] == 0 \
                and not res.homography.inliers[b].any()
            continue
        assert packed[b, 9] == 1
        inl = res.homography.inliers[b].numpy()
        assert inl.sum() > 20
        assert _jaccard(inl, jpacked[b, 21:21 + n] > 0) >= 0.95
        pa = corners @ packed[b, :9].reshape(3, 3).T.astype(np.float64)
        pb = corners @ jpacked[b, :9].reshape(3, 3).T.astype(np.float64)
        assert np.abs(pa[:, :2] / pa[:, 2:] - pb[:, :2] / pb[:, 2:]).max() \
            <= 0.5


# --- (a) the batched back half against the JAX package's batch steps -------

def test_local_batch_step_matches_jax(monkeypatch, db, batch):
    """localize_from_features on B = 3 (a blank frame in the middle)
    against `_make_local_batch_step` on the same features; the blank row
    fails closed and the other two rows equal a B = 2 batch without it,
    bit for bit."""
    frames, feats, jdb = batch
    res = tloc.localize_from_features(feats, db, CAM, CFG, solve_pose=False)
    packed = _pack_outputs(res.homography, res.num_matches,
                           res.num_keypoints, None).numpy()
    jpacked = _run_jax_step(
        monkeypatch,
        lambda: jstream._make_local_batch_step(jdb, JCAM, JCFG, False),
        frames, feats)
    _check_rows(packed, jpacked, res, feats.keypoints.capacity)
    two = tloc.localize_from_features(
        select(feats, torch.tensor([0, 2])), db, CAM, CFG, solve_pose=False)
    for i, b in enumerate((0, 2)):
        assert _equal(select(two, i), select(res, b)) is None


def test_pruned_batch_step_matches_jax(monkeypatch, db, batch):
    """_pruned_back_half on B = 3 against `_make_pruned_batch_step` on the
    same features (the DB as its own coarse DB, window capacity 512):
    coarse fixes, no overflow, the rows as in the local step; the blank
    row's coarse fix fails."""
    frames, feats, jdb = batch
    pdb = tloc.make_pruned_db(db, db, window_capacity=512)
    jpdb = jloc.make_pruned_db(jdb, jdb, window_capacity=512)
    pr = tloc._pruned_back_half(feats, (128, 128), pdb, CAM, CFG, False,
                                MARGIN)
    r = pr.result
    packed = _pack_outputs(r.homography, r.num_matches, r.num_keypoints,
                           None).numpy()
    jpacked = _run_jax_step(
        monkeypatch,
        lambda: jstream._make_pruned_batch_step(jpdb, JCAM, JCFG, False,
                                                MARGIN),
        frames, feats)
    np.testing.assert_array_equal(pr.coarse_ok.numpy(), [True, False, True])
    np.testing.assert_array_equal(jpacked[:, -2], [1.0, 0.0, 1.0])
    assert not pr.overflow.any() and not jpacked[:, -1].any()
    _check_rows(packed, jpacked[:, :-2], r, feats.keypoints.capacity)


# --- (b) batched RANSAC and PnP with JAX's draws ---------------------------

def _homography_batch(rng):
    """Three frames of 200 correspondences: two with 30% outliers, one
    with only 3 valid entries (fails closed)."""
    n = 200
    H_true = np.array([[1.02, 0.03, 12.0], [-0.02, 0.99, 7.0],
                       [1e-5, -2e-5, 1.0]], np.float32)
    src = rng.uniform(0, 512, (3, n, 2)).astype(np.float32)
    ph = np.concatenate([src, np.ones((3, n, 1), np.float32)], -1) @ H_true.T
    dst = (ph[..., :2] / ph[..., 2:]).astype(np.float32)
    dst += rng.normal(0, 0.3, dst.shape).astype(np.float32)
    out = rng.random((3, n)) < 0.3
    dst[out] = rng.uniform(0, 512, (int(out.sum()), 2))
    valid = rng.random((3, n)) > 0.05
    valid[2, 3:] = False
    quality = rng.integers(0, 100, (3, n)).astype(np.float32)
    quality[~out] -= 50.0                          # inliers rank better
    return src, dst, valid, quality


METHODS = ("ransac", "lmeds", "rho")


@pytest.fixture(scope="module")
def homography_refs():
    """The batch of _homography_batch, JAX's draws for it, and jax.vmap of
    the JAX function under each method — the three in one program."""
    src, dst, valid, quality = _homography_batch(np.random.default_rng(21))
    cfg = JRansacConfig(num_hypotheses=64, refine_iters=1)
    key = jax.random.PRNGKey(cfg.seed)
    draws = {"rho": np.asarray(jax.random.uniform(key, (64, 4)))}
    draws["ransac"] = draws["lmeds"] = np.stack([np.asarray(
        jax.random.randint(key, (64, 4), 0, max(int(v.sum()), 1)))
        for v in valid])

    @jax.jit
    def refs(s, d, v, q):
        def one(s, d, v, q, m):
            return jhom.find_homography_ransac(s, d, v, config=cfg, method=m,
                                               quality=q)

        return {m: jax.vmap(lambda s, d, v, q, m=m: one(s, d, v, q, m))(
            s, d, v, q) for m in METHODS}

    out = refs(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid),
               jnp.asarray(quality))
    return (src, dst, valid, quality), draws, out


@pytest.mark.parametrize("method", METHODS)
def test_homography_batch_matches_vmapped_jax(homography_refs, method):
    """find_homography_ransac on [3, N] with JAX's draws fed in, against
    jax.vmap of the JAX function: ok equal, inlier Jaccard ≥ 0.95 and H
    within 1e-3 of its largest entry where ok (the winner's refit sums in
    another order)."""
    (src, dst, valid, quality), draws, refs = homography_refs
    ref = refs[method]
    got = thom.find_homography_ransac(
        _t(src), _t(dst), _t(valid, torch.bool),
        config=RansacConfig(num_hypotheses=64, refine_iters=1),
        r=torch.from_numpy(draws[method]), method=method,
        quality=_t(quality))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    np.testing.assert_array_equal(got.ok.numpy(), [True, True, False])
    assert not got.inliers[2].any()
    for b in range(2):
        assert _jaccard(got.inliers[b].numpy(), ref.inliers[b]) >= 0.95
        Hr = np.asarray(ref.H[b])
        np.testing.assert_allclose(got.H[b].numpy(), Hr,
                                   atol=1e-3 * np.abs(Hr).max())


def test_pnp_batch_with_jax_draws_equals_single_calls():
    """solve_pnp_ransac on [3, N] with the up-gate and JAX's per-frame
    draws fed in ([3, H, S]): every row equals the lone call fed that
    frame's draws bit for bit, the rotation within 0.5° of the truth where
    ok, and a frame with 3 valid points fails closed. The lone call fed
    JAX's draws is held to the JAX function (rotation within 0.1°, inlier
    Jaccard ≥ 0.95) by test_torch_match_geometry.py::
    test_pnp_ransac_matches_jax; compiling the JAX function here again
    would take 19-25 s of this file's 40 s budget (per frame or vmapped)."""
    rng = np.random.default_rng(31)
    n = 120
    K = np.array([[800, 0, 256], [0, 800, 256], [0, 0, 1]], np.float32)
    dist = np.array([0.02, 0, 0, 0, 0], np.float32)
    objs, pixs, rots = [], [], []
    for rv in ([0.1, -0.05, 0.02], [-0.08, 0.12, 0.3], [0.0, 0.05, -0.1]):
        obj = np.concatenate([rng.uniform(-500, 500, (n, 2)),
                              rng.uniform(-20, 20, (n, 1))], 1)
        R = trod.rodrigues_to_matrix(_t(rv)).numpy()
        cam = obj @ R.T + np.array([10.0, -20.0, 2000.0])
        xy = cam[:, :2] / cam[:, 2:]
        r2 = (xy ** 2).sum(1, keepdims=True)
        pix = xy * (1 + dist[0] * r2) * 800 + 256
        pix += rng.normal(0, 0.3, pix.shape)
        out = rng.random(n) < 0.25
        pix[out] = rng.uniform(0, 512, (int(out.sum()), 2))
        objs.append(obj)
        pixs.append(pix)
        rots.append(R)
    obj = np.stack(objs).astype(np.float32)
    pix = np.stack(pixs).astype(np.float32)
    valid = rng.random((3, n)) > 0.05
    valid[1, 3:] = False
    up = np.array([0.0, 0.0, -1.0], np.float32)
    cfg_j, cfg_t = JPnPConfig(num_hypotheses=32), PnPConfig(num_hypotheses=32)
    key = jax.random.PRNGKey(cfg_j.seed)
    r = np.stack([np.asarray(jax.random.randint(
        key, (32, cfg_j.sample_size), 0, max(int(v.sum()), 1)))
        for v in valid])
    camera = convert.camera_from({"K": K, "dist": dist}, device="cpu")

    def run(sl):
        return tpnp.solve_pnp_ransac(
            Correspondences(obj_points=_t(obj[sl]), img_points=_t(pix[sl]),
                            valid=_t(valid[sl], torch.bool)),
            camera, cfg_t, up=_t(up), r=torch.from_numpy(r[sl]))

    got = run(slice(None))
    np.testing.assert_array_equal(got.ok.numpy(), [True, False, True])
    for b in range(3):
        bad = _equal(select(got, b), run(b))
        assert bad is None, (b, bad)
    for b in (0, 2):
        Rg = trod.rodrigues_to_matrix(got.rvec[b]).numpy()
        assert _angle_deg(Rg, rots[b]) <= 0.5


# --- (c) every row of a batch equals its B = 1 call, bit for bit -----------

def _sparse_batch(feats):
    """The batch with a fourth row: frame 0's features with all but three
    keypoints masked (fewer than 4 matches)."""
    extra = select(feats, 0)
    kp = extra.keypoints
    keep = torch.arange(kp.capacity) < 3
    extra.keypoints = type(kp)(**{**kp.__dict__, "valid": kp.valid & keep})
    return type(feats)(
        keypoints=type(kp)(**{k: torch.cat([getattr(feats.keypoints, k),
                                            getattr(extra.keypoints, k)[None]])
                              for k in kp.__dict__}),
        descriptors=torch.cat([feats.descriptors, extra.descriptors[None]]))


def _geometry_problems(rng, b=4, n=300):
    """Random correspondence batches with one short row (3 valid)."""
    src = rng.uniform(0, 256, (b, n, 2)).astype(np.float32)
    dst = src + rng.normal(0, 0.3, src.shape).astype(np.float32) + 9.0
    out = rng.random((b, n)) < 0.3
    dst[out] = rng.uniform(0, 256, (int(out.sum()), 2))
    valid = rng.random((b, n)) > 0.1
    valid[1, 3:] = False
    obj = np.concatenate([src * 4.0, rng.uniform(-5, 5, (b, n, 1))], -1)
    return src, dst, valid, obj.astype(np.float32)


@pytest.mark.parametrize("path", ["full", "full_pose", "pruned"])
def test_batch_rows_equal_single_calls(db, batch, path):
    """The back half on B = 4 (the blank frame, and a row with fewer than
    4 matches): every field of every row equals the same call on that
    row alone, bit for bit."""
    _, feats, _ = batch
    feats = _sparse_batch(feats)
    pose = path != "full"
    if path == "pruned":
        pdb = tloc.make_pruned_db(db, db, window_capacity=512)

        def run(f):
            return tloc._pruned_back_half(f, (128, 128), pdb, CAM, CFG, pose,
                                          MARGIN)
    else:
        def run(f):
            return tloc.localize_from_features(f, db, CAM, CFG, pose)

    res = run(feats)
    ok = res.result.homography.ok if path == "pruned" else res.homography.ok
    np.testing.assert_array_equal(ok.numpy(), [True, False, True, False])
    matches = res.result.matches if path == "pruned" else res.matches
    assert int(matches.count()[3]) < 4
    for b in range(4):
        bad = _equal(select(res, b), run(select(feats, b)))
        assert bad is None, (b, bad)


@pytest.mark.parametrize("method", ["ransac", "lmeds", "rho", "pnp"])
def test_geometry_rows_equal_single_calls(method):
    """find_homography_ransac (each method) and solve_pnp_ransac on
    B = 4 with their own seeded draws: every row equals the lone call bit
    for bit, the short row (3 valid) failing closed."""
    src, dst, valid, obj = _geometry_problems(np.random.default_rng(7))
    if method == "pnp":
        cam = CameraModel.ideal(300.0, 300.0, 128.0, 128.0)
        cfg = PnPConfig(num_hypotheses=32)

        def run(sl):
            return tpnp.solve_pnp_ransac(Correspondences(
                obj_points=_t(obj[sl]), img_points=_t(src[sl]),
                valid=_t(valid[sl], torch.bool)), cam, cfg,
                up=_t([0.0, 0.0, 1.0]))
    else:
        cfg = RansacConfig(num_hypotheses=64)
        quality = np.abs(dst - src - 9.0).sum(-1)

        def run(sl):
            return thom.find_homography_ransac(
                _t(src[sl]), _t(dst[sl]), _t(valid[sl], torch.bool), cfg,
                method=method, quality=_t(quality[sl]))

    res = run(slice(None))
    assert not bool(res.ok[1])
    for b in range(4):
        bad = _equal(select(res, b), run(b))
        assert bad is None, (b, bad)


# --- (d) knn_match over [B, Q] ----------------------------------------------

@pytest.mark.parametrize("route", ["dense", "fused", "scan"])
def test_knn_match_batch_equals_per_frame(route):
    """knn_match of [3, Q] queries against one DB equals the per-frame
    calls bit for bit: the dense route (one product of all 3·Q rows), and
    the big-DB route with db_block below the DB (kernel 4's plain twin,
    one call with 3·Q queries; and the scan)."""
    rng = np.random.default_rng(4)
    q = rng.integers(0, 256, (3, 96, 61), dtype=np.uint8)
    dbd = rng.integers(0, 256, (700, 61), dtype=np.uint8)
    dbd[rng.integers(0, 700, 80)] = q[:, :80:3].reshape(-1, 61)[:80] ^ (
        rng.integers(0, 256, (80, 61), dtype=np.uint8)
        & rng.integers(0, 256, (80, 61), dtype=np.uint8)
        & rng.integers(0, 256, (80, 61), dtype=np.uint8))
    q_valid = rng.random((3, 96)) > 0.1
    db_valid = rng.random(700) > 0.05
    kw = dict(ratio=0.8, db_valid=torch.from_numpy(db_valid),
              block=None if route == "dense" else 256,
              kernel="scan" if route == "scan" else "auto")
    got = tmatch.knn_match(torch.from_numpy(q), torch.from_numpy(dbd),
                           q_valid=torch.from_numpy(q_valid), **kw)
    assert int(got.valid.sum()) > 20
    for b in range(3):
        want = tmatch.knn_match(torch.from_numpy(q[b]), torch.from_numpy(dbd),
                                q_valid=torch.from_numpy(q_valid[b]), **kw)
        assert _equal(select(got, b), want) is None, b
