"""Parity of the port's offline DB build with the JAX package: the tiled
extraction (ops/features/akaze.py: `_tiled_merge`, `_own_and_shift`,
`detect_and_compute_tiled`), `preprocess` (pipelines/preprocess.py) and
the binary store's write side (store/binary_store.py: append, compact,
delete, the write lock).

The same seeded numpy inputs go through both packages on the CPU. The
merge is held bit-exact on the same candidates. Extraction and store
rows are held bit-exact where the two scale spaces agree, and to the
feature stack's stated tolerances where the FED rounding noise flips a
detection (tests/test_torch_features.py). The binary store's mutations
are held against an in-RAM union, as the JAX package's own tests hold
its store: no test here calls the JAX package's native libraries or
binary store.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubesat_apds_tpu.core.config import AkazeConfig as JAkazeConfig
from cubesat_apds_tpu.core.config import PipelineConfig as JPipelineConfig
from cubesat_apds_tpu.io.mosaic import MosaicDataset as JMosaic
from cubesat_apds_tpu.io.tiff import GeoRaster as JGeoRaster
from cubesat_apds_tpu.ops.features import akaze as jakaze
from cubesat_apds_tpu.pipelines.preprocess import preprocess as jpreprocess
from cubesat_apds_tpu_torch.core.config import AkazeConfig, PipelineConfig
from cubesat_apds_tpu_torch.io.mosaic import MosaicDataset
from cubesat_apds_tpu_torch.io.tiff import GeoRaster, write_geotiff
from cubesat_apds_tpu_torch.ops.features import akaze as takaze
from cubesat_apds_tpu_torch.pipelines import preprocess as tpp
from cubesat_apds_tpu_torch.store.binary_store import (
    BinaryFeatureStore, append_binary_store, compact_binary_store,
    store_write_lock, write_binary_store)
from cubesat_apds_tpu_torch.store.feature_store import FeatureStore

torch.set_num_threads(2)

CAP = 512
# adaptive_buckets=1: one capacity rung, the same bits as the ladder
# (JAX's own test_batched_ladder_equals_single), and one compile.
JCFG = JPipelineConfig(akaze=JAkazeConfig(capacity=CAP, detect_topk="exact",
                                          adaptive_buckets=1))
TCFG = PipelineConfig(akaze=AkazeConfig(capacity=CAP))
GT = np.array([10.0, 0.001, 0.0, 56.0, 0.0, -0.001])


def _scene(rng, h, w=None):
    """Corner-rich synthetic scene (tests/test_pipelines.py's)."""
    w = w or h
    img = np.zeros((h, w), np.float32)
    for _ in range(60 * h * w // (256 * 256)):
        cy = rng.integers(10, h - 40)
        cx = rng.integers(10, w - 40)
        s = int(rng.integers(8, 24))
        img[cy:cy + s, cx:cx + s] = rng.uniform(0.3, 1.0)
    return img


def _rasters(img):
    """One in-memory RGB raster of `img` for each package."""
    kw = dict(bands=np.stack([img * 255.0] * 3).astype(np.float32),
              geotransform=GT, epsg=None, nodata=None, path="mem")
    return GeoRaster(**kw), JGeoRaster(**kw)


def _feat_arrays(f):
    kp = f.keypoints
    return {k: np.asarray(getattr(kp, k)) for k in (
        "xy", "size", "angle", "response", "octave", "class_id",
        "valid")} | {"desc": np.asarray(f.descriptors)}


def _seam_invariants(f, h, w, capacity):
    """Count within capacity, response-sorted valid prefix, coordinates in
    the image, and no surviving pair within 0.5 px and ≤ 1 level."""
    a = _feat_arrays(f)
    v = a["valid"]
    n = int(v.sum())
    assert 0 < n <= capacity and v[:n].all() and not v[n:].any()
    r = a["response"][:n]
    assert (np.diff(r) <= 0).all()
    xy, cls = a["xy"][:n], a["class_id"][:n]
    assert (xy >= -1).all() and (xy[:, 0] < w + 1).all() \
        and (xy[:, 1] < h + 1).all()
    d2 = ((xy[:, None] - xy[None]) ** 2).sum(-1)
    near = (d2 < 0.25) & (np.abs(cls[:, None] - cls[None]) <= 1)
    np.fill_diagonal(near, False)
    assert not near.any()


# --- _tiled_merge: the global top-K and the seam dedup ----------------------

def _merge_both(xy, size, angle, resp, octave, cls, desc, valid, h, w, cap):
    t = takaze._tiled_merge(*(torch.from_numpy(np.asarray(a)) for a in (
        xy, size, angle, resp, octave, cls, desc, valid)), h, w, cap)
    j = jakaze._tiled_merge(*(jnp.asarray(a) for a in (
        xy, size, angle, resp, octave, cls, desc, valid)), img_h=h, img_w=w,
        capacity=cap)
    return t, j


def _assert_same_features(t, j):
    ta, ja = _feat_arrays(t), _feat_arrays(j)
    for k in ta:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)


def test_tiled_merge_seam_dedup_is_greedy():
    """test_akaze.py's chain A>B>C>D, neighbours within 0.5 px: greedy
    keeps {A, C}, descriptors follow their keypoints, and every output
    array equals JAX's."""
    n = 4
    xy = np.array([[10.0, 10.0], [10.4, 10.0], [10.8, 10.0], [11.2, 10.0]],
                  np.float32)
    zf, zi = np.zeros(n, np.float32), np.zeros(n, np.int32)
    desc = np.tile(np.arange(n, dtype=np.uint8)[:, None], (1, 61))
    t, j = _merge_both(xy, zf + 4.8, zf, np.float32([4, 3, 2, 1]), zi, zi,
                       desc, np.ones(n, bool), 32, 32, 4)
    kp = t.keypoints
    np.testing.assert_allclose(sorted(kp.xy[kp.valid, 0].tolist()),
                               [10.0, 10.8], atol=1e-5)
    assert sorted(t.descriptors[kp.valid, 0].tolist()) == [0, 2]
    _assert_same_features(t, j)


def test_tiled_merge_matches_greedy_and_jax():
    """test_akaze.py's seam-shaped scenes (isolated points, sub-0.5-px
    clusters across adjacent levels, 4-chains at 0.4 px): the port keeps
    exactly brute-force greedy rank-order suppression's set, and its
    output equals JAX's, array by array."""
    rng = np.random.default_rng(0)
    H = W = 256
    pts, cls = [], []
    for _ in range(40):
        pts.append(rng.uniform(2, W - 2, 2))
        cls.append(int(rng.integers(0, 12)))
    for _ in range(25):
        c = rng.uniform(2, W - 2, 2)
        lv = int(rng.integers(1, 11))
        for _j in range(int(rng.integers(2, 4))):
            pts.append(c + rng.uniform(-0.15, 0.15, 2))
            cls.append(lv + int(rng.integers(-1, 2)))
    for _ in range(10):
        c = rng.uniform(4, W - 4, 2)
        d = rng.uniform(-1, 1, 2)
        d = 0.4 * d / np.linalg.norm(d)
        lv = int(rng.integers(1, 11))
        for k in range(4):
            pts.append(c + k * d)
            cls.append(lv)
    n = len(pts)
    xy = np.asarray(pts, np.float32)
    cls_a = np.asarray(cls, np.int32)
    resp = (rng.permutation(n) + 1.0).astype(np.float32)
    valid = rng.uniform(size=n) < 0.9
    kept: list = []
    for i in np.argsort(-resp, kind="stable"):
        if valid[i] and not any(np.sum((xy[i] - xy[k]) ** 2) < 0.25
                                and abs(int(cls_a[i]) - int(cls_a[k])) <= 1
                                for k in kept):
            kept.append(i)
    desc = np.tile((np.arange(n) % 256).astype(np.uint8)[:, None], (1, 61))
    zf = np.zeros(n, np.float32)
    t, j = _merge_both(xy, zf, zf, resp, cls_a, cls_a, desc, valid, H, W, n)
    got = t.keypoints.xy[t.keypoints.valid].numpy()
    assert sorted(map(tuple, got.round(3))) == \
        sorted(map(tuple, xy[kept].round(3)))
    _assert_same_features(t, j)


def test_tiled_merge_refuses_past_the_int32_cell_grid():
    """As the JAX package: a 50,000² image is refused, not deduplicated on
    a wrapped cell grid."""
    zf, zi = np.zeros(4, np.float32), np.zeros(4, np.int32)
    args = (np.zeros((4, 2), np.float32), zf, zf, zf, zi, zi,
            np.zeros((4, 61), np.uint8), np.ones(4, bool))
    with pytest.raises(ValueError, match="int32 seam-dedup"):
        takaze._tiled_merge(*(torch.from_numpy(a) for a in args), 50000,
                            50000, 4)
    with pytest.raises(ValueError, match="int32 seam-dedup"):
        jakaze._tiled_merge(*(jnp.asarray(a) for a in args), 50000, 50000, 4)


# --- detect_and_compute_tiled ----------------------------------------------

@pytest.fixture(scope="module")
def tiled():
    """A 384² scene through both packages' tiled extraction (tile 256,
    overlap 32: 4 tiles), and the port's run at tile_batch 3 (a padded
    tail batch)."""
    img = _scene(np.random.default_rng(1), 384)
    kw = dict(capacity=CAP, tile=256, overlap=32)
    j = jakaze.detect_and_compute_tiled(img, JCFG.akaze, **kw)
    t = takaze.detect_and_compute_tiled(img, TCFG.akaze, device="cpu", **kw)
    t3 = takaze.detect_and_compute_tiled(img, TCFG.akaze, device="cpu",
                                         tile_batch=3, **kw)
    return img, _feat_arrays(t), _feat_arrays(j), t, t3


def test_tiled_extraction_matches_jax(tiled):
    """Counts within 1%; every JAX keypoint has a port keypoint on its
    level within 0.06 px, ≥ 96% within 1e-3 px, and ≥ 98% of those pairs
    have equal descriptors (measured: 96.5% and 98.6%; the rest are
    sub-pixel refinements of symmetric square corners that an ulp moves
    by ~0.04 px); the port's output keeps the seam invariants."""
    img, t, j, tf, _ = tiled
    nt, nj = int(t["valid"].sum()), int(j["valid"].sum())
    assert nj > 50 and abs(nt - nj) <= max(1, 0.01 * nj)
    d = np.abs(j["xy"][:nj, None] - t["xy"][None, :nt]).max(-1)
    level = j["class_id"][:nj, None] == t["class_id"][None, :nt]
    assert ((d <= 0.06) & level).any(1).all()
    same = (d <= 1e-3) & level
    hit = same.any(1)
    assert hit.mean() >= 0.96
    desc_eq = (j["desc"][:nj][hit] == t["desc"][:nt][same.argmax(1)[hit]])
    assert desc_eq.all(1).mean() >= 0.98
    _seam_invariants(tf, *img.shape, CAP)


def test_tiled_extraction_is_independent_of_the_tile_batch(tiled):
    """tile_batch 3 (one full batch, one padded) gives the bits of
    tile_batch 1: padded tiles own nothing."""
    _, t, _, _, t3 = tiled
    for k, v in _feat_arrays(t3).items():
        np.testing.assert_array_equal(v, t[k], err_msg=k)


def test_detection_on_jax_scale_space_equals_jax_op_by_op():
    """Where the ~0.04 px keypoint gap above starts. JAX's own scale space
    (Lt, Lsmooth, kcontrast) of the tie-rich 256² scene goes through the
    port's detect_keypoints and through JAX's detect_keypoints run op by
    op: keypoint count, class_id, xy and response are equal bit for bit,
    and the det-Hessian maps too (but for values below 1e-37, which
    XLA:CPU flushes to zero). JAX's jitted detection of the same scale
    space is the reference that differs: XLA's fused det-Hessian moves
    values by a few float32 ulps, which flips detections (measured: 423
    keypoints against 422 op by op; 0.47% of the jitted keypoints have no
    port twin on their level within 1e-3 px, and the largest offset to a
    twin is 0.0237 px, against 2.36% and 0.0439 px when the port builds
    its own scale space). Both steps are the reference's rounding, not a
    formula of the port; the share and the offset are held at 1% and
    0.03 px, below the port's own-scale-space figures of the same run."""
    from cubesat_apds_tpu.ops.features import scale_space as jss
    from cubesat_apds_tpu.ops.features.detect import (
        det_hessian_response as jdet_hessian, detect_keypoints as jdetect)
    from cubesat_apds_tpu_torch.ops.features import scale_space as tss
    from cubesat_apds_tpu_torch.ops.features.detect import (
        det_hessian_response, detect_keypoints)

    img = _scene(np.random.default_rng(3), 256)
    jcfg = JCFG.akaze

    @jax.jit
    def front(x):
        ss = jss.build_scale_space(x, jcfg)
        return ss.Lt, ss.Lsmooth, ss.kcontrast, jdetect(ss, jcfg, CAP)[0]

    lt, ls, k, jit_kps = jax.device_get(front(jnp.asarray(img)))
    meta = jss.evolution_metadata(jcfg)
    eager_kps = jdetect(jss.ScaleSpace(
        Lt=[jnp.asarray(a) for a in lt], Lsmooth=[jnp.asarray(a) for a in ls],
        meta=meta, kcontrast=jnp.asarray(k)), jcfg, CAP)[0]
    t_ss = tss.ScaleSpace(
        Lt=[torch.from_numpy(np.array(a)) for a in lt],
        Lsmooth=[torch.from_numpy(np.array(a)) for a in ls],
        meta=tss.evolution_metadata(TCFG.akaze),
        kcontrast=torch.from_numpy(np.array(k)))
    t_kps = detect_keypoints(t_ss, TCFG.akaze, CAP)[0]

    def fields(kp):
        return {f: np.asarray(getattr(kp, f)) for f in (
            "valid", "class_id", "xy", "response")}

    t, e, j = fields(t_kps), fields(eager_kps), fields(jit_kps)
    for f in t:
        np.testing.assert_array_equal(t[f], e[f], err_msg=f)
    for i, m in enumerate(meta):
        got = det_hessian_response(torch.from_numpy(np.array(ls[i])),
                                   m.sigma_size)[0].numpy()
        ref = np.asarray(jdet_hessian(jnp.asarray(ls[i]), m.sigma_size)[0])
        differ = got != ref
        assert np.abs(got[differ]).max(initial=0.0) < 1e-37, i
        assert not ref[differ].any(), i
    nt, nj = int(t["valid"].sum()), int(j["valid"].sum())
    d = np.abs(j["xy"][:nj, None] - t["xy"][None, :nt]).max(-1)
    def twin_gap(kps):
        """(count, share of jitted JAX keypoints with no twin in `kps` on
        their level within 1e-3 px, largest offset to a twin)."""
        n = int(kps["valid"].sum())
        d = np.abs(j["xy"][:nj, None] - kps["xy"][None, :n]).max(-1)
        level = j["class_id"][:nj, None] == kps["class_id"][None, :n]
        near = np.where(level, d, np.inf).min(1)
        return n, float((near > 1e-3).mean()), float(near.max())

    own = fields(detect_keypoints(tss.build_scale_space(
        torch.from_numpy(img), TCFG.akaze), TCFG.akaze, CAP)[0])
    (_, lone, far), (n_own, lone_own, far_own) = twin_gap(t), twin_gap(own)
    print(f"JAX jitted: {nj} keypoints. Port on JAX's scale space (= JAX op "
          f"by op): {nt}, {lone:.4%} without a twin within 1e-3 px, largest "
          f"offset {far:.4g} px. Port on its own: {n_own}, {lone_own:.4%}, "
          f"{far_own:.4g} px")
    assert nj > 300 and abs(nt - nj) <= max(1, 0.01 * nj)
    assert lone <= 0.01 and far <= 0.03
    assert lone < lone_own and far < far_own


def test_tiled_extraction_small_image_is_one_call():
    """An image within one tile takes the untiled path."""
    img = _scene(np.random.default_rng(2), 128)
    a = takaze.detect_and_compute_tiled(img, TCFG.akaze, capacity=256,
                                        device="cpu")
    b = takaze.detect_and_compute(torch.from_numpy(img), TCFG.akaze, 256)
    for k, v in _feat_arrays(a).items():
        np.testing.assert_array_equal(v, _feat_arrays(b)[k], err_msg=k)


# --- preprocess ------------------------------------------------------------

@pytest.fixture(scope="module")
def built():
    """preprocess of one 256² in-memory mosaic (amount_lod=2: 4 tiles of
    128² at LoD 0, 1 at LoD 1) by both packages; the port at tile_batch
    4, JAX at 1 (one compile)."""
    img = _scene(np.random.default_rng(3), 256)
    t_r, j_r = _rasters(img)
    js, jstats = jpreprocess(JMosaic([j_r]), config=JCFG, amount_lod=2,
                             tile_batch=1)
    ts, tstats = tpp.preprocess(MosaicDataset([t_r], device="cpu"),
                                config=TCFG, amount_lod=2, tile_batch=4)
    return img, js, jstats, ts, tstats


def test_preprocess_rows_match_jax(built):
    """Tile records equal; per LoD, where the counts agree the rows are
    equal — integers and descriptors bit-exact, x and y within 1e-4 px,
    angle within 1e-5 rad, response within 2e-6 relative (the scale
    space's float32 spread) — and where a flip moved a count, within 1%,
    with every JAX row matched on its level within 0.06 px, ≥ 97% within
    1e-3 px and ≥ 97% of those with equal descriptors (measured at LoD 0:
    97.8% and 98.0%; LoD 1 equal row for row)."""
    _, js, jstats, ts, tstats = built
    assert (tstats.lods, tstats.tiles) == (jstats.lods, jstats.tiles) == (2, 5)
    assert abs(tstats.keypoints - jstats.keypoints) <= 0.01 * jstats.keypoints
    assert [dataclasses.astuple(r) for r in ts._images.values()] == \
        [dataclasses.astuple(r) for r in js._images.values()]
    assert ts.descriptor_mode == js.descriptor_mode == "exact"
    np.testing.assert_array_equal(ts._geotransforms[1], js._geotransforms[1])
    equal_lods = 0
    for lod in (0, 1):
        (tc, td), (jc, jd) = (ts.read_keypoints_from_lod(lod),
                              js.read_keypoints_from_lod(lod))
        if len(td) == len(jd):
            equal_lods += 1
            for c in ("size", "octave", "class_id", "image_id"):
                np.testing.assert_array_equal(tc[c], jc[c], err_msg=c)
            np.testing.assert_array_equal(td, jd)
            for c, tol in (("x", 1e-4), ("y", 1e-4), ("angle", 1e-5)):
                np.testing.assert_allclose(tc[c], jc[c], rtol=0, atol=tol)
            np.testing.assert_allclose(tc["response"], jc["response"],
                                       rtol=2e-6)
            continue
        assert abs(len(td) - len(jd)) <= 0.01 * len(jd)
        txy = np.stack([tc["x"], tc["y"]], -1)
        jxy = np.stack([jc["x"], jc["y"]], -1)
        d = np.abs(jxy[:, None] - txy[None]).max(-1)
        level = jc["class_id"][:, None] == tc["class_id"][None]
        assert ((d <= 0.06) & level).any(1).all()
        same = (d <= 1e-3) & level
        hit = same.any(1)
        assert hit.mean() >= 0.97
        assert (td[same.argmax(1)[hit]] == jd[hit]).all(1).mean() >= 0.97
    assert equal_lods >= 1


def test_preprocess_checkpoint_resume(built, tmp_path, monkeypatch):
    """A crashed build resumes from its checkpoint to the store of an
    uninterrupted run; a cursor of other run parameters is refused; the
    checkpoint is removed on success; a build over a dp=2 mesh of CPU
    slots gives the same store bit for bit."""
    img, _, _, ref, ref_stats = built
    t_r, _ = _rasters(img)

    def ds():
        return MosaicDataset([t_r], device="cpu")

    ck = str(tmp_path / "ckpt")
    orig = tpp.detect_and_compute_batch
    calls = {"n": 0}

    def flaky(batch, cfg):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected crash")
        return orig(batch, cfg)

    monkeypatch.setattr(tpp, "detect_and_compute_batch", flaky)
    with pytest.raises(RuntimeError, match="injected crash"):
        tpp.preprocess(ds(), config=TCFG, amount_lod=2, tile_batch=1,
                       checkpoint_dir=ck, checkpoint_every=1)
    monkeypatch.setattr(tpp, "detect_and_compute_batch", orig)
    with open(os.path.join(ck, "cursor.json")) as f:
        cursor = json.load(f)
    assert (cursor["lod"], cursor["start"]) == (0, 1)
    with pytest.raises(ValueError, match="different run"):
        tpp.preprocess(ds(), config=TCFG, amount_lod=1, tile_batch=1,
                       checkpoint_dir=ck, resume=True)
    store, stats = tpp.preprocess(ds(), config=TCFG, amount_lod=2,
                                  tile_batch=1, checkpoint_dir=ck,
                                  resume=True)
    assert not os.path.exists(ck)
    assert (stats.keypoints, stats.tiles) == (ref_stats.keypoints,
                                             ref_stats.tiles)
    for iid in ref._images:
        (a, da), (b, db) = (ref.read_keypoints_from_image_id(iid),
                            store.read_keypoints_from_image_id(iid))
        for c in a:
            np.testing.assert_array_equal(a[c], b[c], err_msg=c)
        np.testing.assert_array_equal(da, db)
    from cubesat_apds_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dp=2, tp=1, devices=["cpu", "cpu"])
    dp_store, dp_stats = tpp.preprocess(ds(), config=TCFG, amount_lod=2,
                                        tile_batch=1, mesh=mesh)
    assert (dp_stats.keypoints, dp_stats.tiles) == (ref_stats.keypoints,
                                                   ref_stats.tiles)
    for k in ref._kp:
        np.testing.assert_array_equal(ref._kp[k], dp_store._kp[k],
                                      err_msg=k)
    np.testing.assert_array_equal(ref._desc, dp_store._desc)


def test_preprocess_ragged_grid_stores_no_duplicates(tmp_path):
    """A 256×201 mosaic read from a GeoTIFF folder: amount_lod=2 gives
    edge-shifted columns (offsets 0, 100, 101; at LoD 1, 0 and 1). Each
    keypoint is stored by the one tile that owns it: no two rows of
    different tiles share a position and a descriptor, and every row lies
    inside its tile's window. (One tile may hold two rows 0.06 px apart
    with one descriptor: the two tied maxima of a symmetric square
    corner, as in the JAX package.)"""
    from scipy.spatial import cKDTree

    img = _scene(np.random.default_rng(4), 256)[:, :201]
    write_geotiff(str(tmp_path / "r.tif"),
                  (np.stack([img] * 3, -1) * 255).astype(np.uint8), GT)
    ds = MosaicDataset.from_folder(str(tmp_path), device="cpu")
    store, stats = tpp.preprocess(ds, config=TCFG, amount_lod=2)
    assert stats.tiles == 3 * 2 + 2 * 1
    cols, desc = store.read_keypoints_from_lod(0)
    assert len(desc) > 20
    xy = np.stack([cols["x"], cols["y"]], -1)
    d, idx = cKDTree(xy).query(xy, k=2)
    twins = np.flatnonzero(d[:, 1] < 0.25)
    other = idx[twins, 1]
    dup = (desc[twins] == desc[other]).all(1)
    assert (cols["image_id"][twins][dup] == cols["image_id"][other][dup]).all()
    for iid, rec in store._images.items():
        c, _ = store.read_keypoints_from_image_id(iid)
        assert ((c["x"] >= rec.x_start) & (c["x"] < rec.x_end)).all()


def test_tile_gray_matches_jax_bit_exact(built):
    """A build tile's gray image (to_rgb, then BT.601 luma) equals JAX's
    bit for bit, at LoD 0 (no resample) and LoD 1 (Lanczos ÷2)."""
    from cubesat_apds_tpu.ops.image import rgb_to_gray as jgray

    img = built[0]
    t_r, j_r = _rasters(img)
    ds, jds = MosaicDataset([t_r], device="cpu"), JMosaic([j_r])
    for win, size in (((128, 0), (128, 128)), ((0, 0), (256, 256))):
        got = tpp.tile_gray(ds, *win, *size, 128, 128).numpy()
        rgba = jds.to_rgb(win, size, (128, 128))
        ref = np.asarray(jgray(jnp.asarray(rgba[..., :3])))
        if size[0] == 128:
            np.testing.assert_array_equal(got, ref)
        else:
            # The Lanczos product may round a pixel to the neighbouring
            # uint8 (test_torch_io.py); the luma is exact on equal pixels.
            assert (got == ref).mean() >= 0.99


# --- the binary store's write side -----------------------------------------

def _store(rng, n_imgs=3, n_per=50, lod_of=lambda k: k % 2):
    s = FeatureStore()
    for k in range(n_imgs):
        iid = s.create_image(0, 0, 1000, 1000, lod_of(k))
        s.add_keypoints(
            iid, rng.uniform(0, 1000, n_per).astype(np.float32),
            rng.uniform(0, 1000, n_per).astype(np.float32),
            size=np.full(n_per, 4.8, np.float32),
            angle=rng.uniform(0, 6.28, n_per).astype(np.float32),
            response=rng.uniform(0, 1, n_per).astype(np.float32),
            octave=np.zeros(n_per, np.int32),
            class_id=np.zeros(n_per, np.int32),
            descriptors=rng.integers(0, 256, (n_per, 61), dtype=np.uint8))
    return s


def _union(stores):
    """The in-RAM store the appends must equal: every image re-inserted
    in order, so the serial ids continue."""
    u = FeatureStore()
    for s in stores:
        for r in sorted(s._images.values(), key=lambda r: r.id):
            new = u.create_image(r.x_start, r.y_start, r.x_end, r.y_end,
                                 r.level_of_detail)
            sel = s._kp["image_id"] == r.id
            u.add_keypoints(new, *(s._kp[c][sel] for c in (
                "x", "y", "size", "angle", "response", "octave",
                "class_id")), s._desc[sel])
    return u


def _same_queries(b, ref, lods=(0, 1)):
    for lod in lods:
        (bc, bd), (rc, rd) = (b.read_keypoints_from_lod(lod),
                              ref.read_keypoints_from_lod(lod))
        np.testing.assert_array_equal(bd, rd)
        for c in rc:
            np.testing.assert_array_equal(bc[c], rc[c], err_msg=c)
    (_, bd), (_, rd) = (b.read_keypoints_from_coordinates(100, 700, 50, 800,
                                                          0),
                        ref.read_keypoints_from_coordinates(100, 700, 50, 800,
                                                            0))
    np.testing.assert_array_equal(bd, rd)


def test_append_delete_compact_equal_the_union(tmp_path):
    """append_binary_store adds a segment with remapped image ids, equal
    to an in-RAM union of the two builds; delete_image drops a tile and
    its rows; compact_binary_store rewrites the live rows into one
    segment with every query unchanged, and appends continue the ids."""
    rng = np.random.default_rng(5)
    p = str(tmp_path / "bin")
    s1, s2 = _store(rng), _store(rng, n_imgs=2)
    write_binary_store(s1, p)
    append_binary_store(p, s2)
    b = BinaryFeatureStore(p)
    u = _union([s1, s2])
    assert len(b.manifest["segments"]) == 2 and len(b) == len(u) == 250
    assert sorted(b.images) == sorted(u._images) == [1, 2, 3, 4, 5]
    _same_queries(b, u)

    b.delete_image(2)
    u.delete_image(2)
    b = BinaryFeatureStore(p)
    assert len(b) == len(u) == 200 and 2 not in b.images
    _same_queries(b, u)

    assert compact_binary_store(p) == (200, 50)
    c = BinaryFeatureStore(p)
    assert len(c.segments) == 1 and c.alive.all() and c.n == 200
    assert not any(d.startswith("seg") for d in os.listdir(p))
    _same_queries(c, u)
    append_binary_store(p, _store(rng, n_imgs=1))
    assert sorted(BinaryFeatureStore(p).images) == [1, 3, 4, 5, 6]


def test_append_refuses_another_frame_and_adopts_elevation(tmp_path):
    rng = np.random.default_rng(6)
    p = str(tmp_path / "bin")
    s1 = _store(rng, n_imgs=1)
    s1.set_geotransform(1, GT)
    write_binary_store(s1, p)
    s2 = _store(rng, n_imgs=1)
    dem = rng.uniform(0, 100, (8, 8)).astype(np.float32)
    s2.set_geotransform(1, GT)
    s2.set_elevation(dem, [10.0, 0.01, 0, 56.0, 0, -0.01])
    append_binary_store(p, s2)
    b = BinaryFeatureStore(p)
    assert b.manifest["has_elevation"]
    np.testing.assert_array_equal(b._elevation, dem)
    s3 = _store(rng, n_imgs=1)
    s3.set_geotransform(1, GT + 1.0)
    with pytest.raises(ValueError, match="geotransform mismatch"):
        append_binary_store(p, s3)
    s4 = _store(rng, n_imgs=1)
    s4.descriptor_mode = "fast"
    b.manifest["descriptor_mode"] = "exact"
    with open(os.path.join(p, "manifest.json"), "w") as f:
        json.dump(b.manifest, f)
    with pytest.raises(ValueError, match="descriptor_mode mismatch"):
        append_binary_store(p, s4)


def test_write_lock_and_stale_handle(tmp_path):
    """A held write lock times a second writer out; a handle opened before
    another writer's commit refuses to delete."""
    rng = np.random.default_rng(7)
    p = str(tmp_path / "bin")
    write_binary_store(_store(rng), p)
    with store_write_lock(p):
        with pytest.raises(TimeoutError):
            append_binary_store(p, _store(rng, n_imgs=1), lock_timeout=0.2)
    stale = BinaryFeatureStore(p)
    append_binary_store(p, _store(rng, n_imgs=1))
    with pytest.raises(RuntimeError, match="reopen"):
        stale.delete_image(1)
    BinaryFeatureStore(p).delete_image(1)
    assert 1 not in BinaryFeatureStore(p).images


_APPEND = r"""
import sys
import numpy as np
sys.path.insert(0, sys.argv[3])
from cubesat_apds_tpu_torch.store.binary_store import append_binary_store
from cubesat_apds_tpu_torch.store.feature_store import FeatureStore

tag = int(sys.argv[2])
rng = np.random.default_rng(tag)
s = FeatureStore()
iid = s.create_image(0, 0, 1000, 1000, tag)
n = 40
s.add_keypoints(iid, rng.uniform(0, 1000, n).astype(np.float32),
                rng.uniform(0, 1000, n).astype(np.float32),
                size=np.full(n, 4.8, np.float32),
                angle=np.zeros(n, np.float32),
                response=rng.uniform(0, 1, n).astype(np.float32),
                octave=np.zeros(n, np.int32), class_id=np.zeros(n, np.int32),
                descriptors=rng.integers(0, 256, (n, 61), dtype=np.uint8))
append_binary_store(sys.argv[1], s, lock_timeout=60.0)
"""


def test_two_process_concurrent_append(tmp_path):
    """Two processes appending at once: the lock serializes them, each
    re-reads the manifest, and both land with unique serial ids."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = str(tmp_path / "bin")
    write_binary_store(_store(np.random.default_rng(8)), p)
    procs = [subprocess.Popen([sys.executable, "-c", _APPEND, p, str(tag),
                               repo], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for tag in (7, 9)]
    for pr in procs:
        _, err = pr.communicate(timeout=120)
        assert pr.returncode == 0, err.decode()
    b = BinaryFeatureStore(p)
    assert len(b.manifest["segments"]) == 3 and len(b) == 3 * 50 + 2 * 40
    assert sorted(b.images) == list(range(1, 6))
    for tag in (7, 9):
        assert len(b.read_keypoints_from_lod(tag)[1]) == 40
