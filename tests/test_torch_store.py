"""The port's stores and store loading against the JAX package.

Stores are small and made from numpy seeds. The JAX package's npz
FeatureStore (numpy only) is the reference; its native store library and
binary store are never called here (their build shares one temporary file
name between processes). The port's binary store is held to the npz
store's answers, its native engine and its numpy twin alike.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubesat_apds_tpu.core.config import MatchConfig as JMatchConfig
from cubesat_apds_tpu.core.config import PipelineConfig as JPipelineConfig
from cubesat_apds_tpu.core.config import AkazeConfig as JAkazeConfig
from cubesat_apds_tpu.core.config import RansacConfig as JRansacConfig
from cubesat_apds_tpu.core.types import CameraModel as JCameraModel
from cubesat_apds_tpu.core.types import Features as JFeatures
from cubesat_apds_tpu.core.types import Keypoints as JKeypoints
from cubesat_apds_tpu.pipelines import localize as jloc
from cubesat_apds_tpu.store.feature_store import FeatureStore as JFeatureStore
from cubesat_apds_tpu_torch import convert
from cubesat_apds_tpu_torch.core.config import (
    AkazeConfig, MatchConfig, PipelineConfig, RansacConfig)
from cubesat_apds_tpu_torch.core.types import CameraModel
from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute
from cubesat_apds_tpu_torch.pipelines import localize as tloc
from cubesat_apds_tpu_torch.store import open_store
from cubesat_apds_tpu_torch.store.binary_store import (
    BinaryFeatureStore, write_binary_store)
from cubesat_apds_tpu_torch.store.feature_store import FeatureStore

torch.set_num_threads(2)

GT = [10.0, 1e-4, 0.0, 56.0, 0.0, -1e-4]     # mosaic px → lon/lat (deg)
EL_GT = [10.0, 0.02, 0.0, 56.0, 0.0, -0.02]  # elevation px → lon/lat


def _fill(store, rng, n_imgs=3, n_per=700, extent=1000.0, desc=None,
          xy=None):
    """Images of alternating LoD 0/1 over [0, extent)², seeded keypoints,
    a mosaic geotransform and an elevation raster."""
    for k in range(n_imgs):
        iid = store.create_image(0, 0, int(extent), int(extent), k % 2)
        store.add_keypoints(
            iid,
            rng.uniform(0, extent, n_per).astype(np.float32)
            if xy is None else xy[:, 0],
            rng.uniform(0, extent, n_per).astype(np.float32)
            if xy is None else xy[:, 1],
            size=np.full(n_per, 4.8, np.float32),
            angle=rng.uniform(0, 6.28, n_per).astype(np.float32),
            response=rng.uniform(0, 1, n_per).astype(np.float32),
            octave=np.zeros(n_per, np.int32),
            class_id=np.zeros(n_per, np.int32),
            descriptors=rng.integers(0, 256, (n_per, 61), dtype=np.uint8)
            if desc is None else desc)
    store.set_geotransform(1, GT)
    store.set_elevation(rng.uniform(100.0, 140.0, (8, 8)).astype(np.float32),
                        EL_GT)
    store.descriptor_mode = "exact"
    return store


@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory):
    """An npz store built and saved by the JAX package."""
    path = str(tmp_path_factory.mktemp("jax_npz"))
    js = _fill(JFeatureStore(), np.random.default_rng(11))
    js.save(path)
    return path, JFeatureStore.load(path)


def _assert_same_answer(got, want):
    (gc, gd), (wc, wd) = got, want
    np.testing.assert_array_equal(gd, wd)
    assert sorted(gc) == sorted(wc)
    for k in wc:
        np.testing.assert_array_equal(gc[k], wc[k], err_msg=k)


QUERIES = {
    "lod0": lambda s: s.read_keypoints_from_lod(0),
    "lod1": lambda s: s.read_keypoints_from_lod(1),
    "window": lambda s: s.read_keypoints_from_coordinates(100, 400, 200,
                                                          600, 0),
    "limit": lambda s: s.read_keypoints_from_lod(0, limit=50),
    "image": lambda s: s.read_keypoints_from_image_id(2),
}


def test_jax_saved_npz_store_loads_in_port(jax_saved):
    """The port's FeatureStore.load reads the JAX-saved directory: every
    query, the device block and the world coordinates are equal."""
    path, ref = jax_saved
    got = FeatureStore.load(path)
    assert len(got) == len(ref) and got.descriptor_mode == "exact"
    for q in QUERIES.values():
        _assert_same_answer(q(got), q(ref))
    for a, b in zip(got.export_device_block(0, 512),
                    ref.export_device_block(0, 512)):
        np.testing.assert_array_equal(a, b)
    px, py = np.meshgrid(np.linspace(0, 999, 7), np.linspace(0, 999, 5))
    np.testing.assert_array_equal(got.get_world_coordinates(1, px, py),
                                  ref.get_world_coordinates(1, px, py))
    assert got.world_dataset_id() == ref.world_dataset_id() == 1


def test_port_saved_npz_store_loads_in_jax(tmp_path):
    """A store the port saves loads in the JAX package with the same
    answers."""
    ts = _fill(FeatureStore(), np.random.default_rng(12))
    ts.save(str(tmp_path))
    back = JFeatureStore.load(str(tmp_path))
    for q in QUERIES.values():
        _assert_same_answer(q(back), q(ts))
    assert back.descriptor_mode == "exact"
    np.testing.assert_array_equal(back._elevation, ts._elevation)


@pytest.fixture(scope="module")
def binary(tmp_path_factory, jax_saved):
    """The JAX-saved store's rows written by the port as a binary store."""
    path, _ = jax_saved
    out = str(tmp_path_factory.mktemp("bin"))
    write_binary_store(FeatureStore.load(path), out)
    return out


@pytest.mark.parametrize("engine", ["native", "numpy"])
@pytest.mark.parametrize("query", sorted(QUERIES))
def test_binary_store_answers_as_npz(jax_saved, binary, query, engine):
    """The port's BinaryFeatureStore answers as the JAX npz store on the
    same data, through its native engine and through its numpy twin."""
    _, ref = jax_saved
    b = BinaryFeatureStore(binary)
    if engine == "numpy":
        b._lib = None
    _assert_same_answer(QUERIES[query](b), QUERIES[query](ref))


def test_binary_store_export_and_world(jax_saved, binary):
    """Device block (with the row cap lifted, too) and world coordinates
    of the binary store equal the npz store's."""
    _, ref = jax_saved
    b = BinaryFeatureStore(binary)
    assert len(b) == len(ref) and b.descriptor_mode == "exact"
    for a, r in zip(b.export_device_block(0, 512),
                    ref.export_device_block(0, 512)):
        np.testing.assert_array_equal(a, r)
    got = b.export_device_block(1, 128, limit=100)
    assert got[0].shape == (128, 61) and int(got[2].sum()) == 100
    np.testing.assert_array_equal(got[0][:100],
                                  ref.read_keypoints_from_lod(1, 100)[1])
    xy = np.random.default_rng(0).uniform(0, 999, (50, 2))
    np.testing.assert_array_equal(
        b.get_world_coordinates(1, xy[:, 0], xy[:, 1]),
        ref.get_world_coordinates(1, xy[:, 0], xy[:, 1]))


def test_open_store_picks_the_backend(jax_saved, binary, tmp_path):
    path, _ = jax_saved
    assert isinstance(open_store(path), FeatureStore)
    assert isinstance(open_store(binary), BinaryFeatureStore)
    with pytest.raises(FileNotFoundError):
        open_store(str(tmp_path / "none"))


def test_native_build_uses_a_private_temp_name():
    """The native library builds under build/store/ through a file named
    by the process id, so concurrent first uses never share one."""
    from cubesat_apds_tpu_torch.store import native

    assert native.get_lib() is not None
    so = native.library_path()
    assert so.is_file() and so.parent.name == "store"
    assert not list(so.parent.glob(f"{so.name}.{os.getpid()}.tmp"))


@pytest.mark.parametrize("backend", ["npz", "binary"])
def test_load_device_db_matches_jax(jax_saved, binary, backend):
    """load_device_db of the same store: descriptors, xy and valid
    bit-exact against the JAX package's, ECEF obj_points equal (the same
    float64 numpy chain), has_world and world_frame equal."""
    path, ref = jax_saved
    want = jloc.load_device_db(ref, 0, pad_multiple=512)
    store = FeatureStore.load(path) if backend == "npz" else \
        BinaryFeatureStore(binary)
    got = tloc.load_device_db(store, 0, pad_multiple=512, device="cpu")
    for f in ("descriptors", "xy", "valid", "obj_points"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert got.has_world and want.has_world
    assert got.world_frame == want.world_frame == "ecef"
    assert got.match_layout is None and got.device.type == "cpu"
    r = np.linalg.norm(got.obj_points.numpy()[got.valid.numpy()], axis=1)
    assert (r > 6.3e6).all()


def test_check_descriptor_mode_raises(jax_saved):
    path, _ = jax_saved
    store = FeatureStore.load(path)
    tloc.check_descriptor_mode(store, PipelineConfig())
    store.descriptor_mode = "fast"
    with pytest.raises(ValueError, match="descriptor_mode"):
        tloc.check_descriptor_mode(store, PipelineConfig())
    with pytest.raises(ValueError, match="descriptor_mode"):
        tloc.Localizer(store, CameraModel.ideal(1.0, 1.0, 0.0, 0.0),
                       device="cpu")


# ---- pruned loading and coarse-to-fine on a real scene --------------------

N, CAP = 256, 512
CAM = (300.0, 300.0, 128.0, 128.0)
TCFG = PipelineConfig(akaze=AkazeConfig(capacity=CAP),
                      match=MatchConfig(ratio=0.75),
                      ransac=RansacConfig(num_hypotheses=64))
JCFG = JPipelineConfig(akaze=JAkazeConfig(capacity=CAP, detect_topk="exact"),
                       match=JMatchConfig(ratio=0.75),
                       ransac=JRansacConfig(num_hypotheses=64))


def _frame(rng, n):
    img = np.zeros((n, n), np.float32)
    for _ in range(60):
        cy, cx = rng.integers(10, n - 50, 2)
        s = int(rng.integers(8, 40))
        img[cy:cy + s, cx:cx + s] = rng.uniform(0.2, 1.0)
    return img


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 256² frame and an npz store saved by the JAX package: LoD 0 holds
    the port's features of the frame rolled by (7, 13) and 1,200 random
    rows spread over [0, 2048)²; LoD 1 holds every 2nd real row.
    Responses fall with the row index, so the LoD query keeps this order.
    Geotransform and elevation as above."""
    rng = np.random.default_rng(5)
    frame = _frame(rng, N)
    f = detect_and_compute(torch.from_numpy(np.roll(frame, (7, 13), (0, 1))),
                           TCFG.akaze)
    v = f.keypoints.valid.numpy()
    desc = np.concatenate([f.descriptors.numpy()[v],
                           rng.integers(0, 256, (1200, 61), dtype=np.uint8)])
    xy = np.concatenate([f.keypoints.xy.numpy()[v],
                         rng.uniform(0, 2048, (1200, 2))]).astype(np.float32)
    m = len(desc)
    js = JFeatureStore()
    for lod, sel in ((0, slice(None)), (1, slice(0, int(v.sum()), 2))):
        iid = js.create_image(0, 0, 2048, 2048, lod)
        k = len(desc[sel])
        js.add_keypoints(iid, xy[sel, 0], xy[sel, 1],
                         np.full(k, 4.8, np.float32), np.zeros(k, np.float32),
                         np.linspace(1.0, 0.5, m, dtype=np.float32)[sel],
                         np.zeros(k, np.int32), np.zeros(k, np.int32),
                         desc[sel])
    js.set_geotransform(1, GT)
    js.set_elevation(rng.uniform(100.0, 140.0, (8, 8)).astype(np.float32),
                     EL_GT)
    js.descriptor_mode = "exact"
    path = str(tmp_path_factory.mktemp("scene"))
    js.save(path)
    feats = detect_and_compute(torch.from_numpy(frame), TCFG.akaze)
    return frame, path, feats


def _jfeats(feats):
    kp = convert.to_numpy(feats.keypoints)
    return JFeatures(keypoints=JKeypoints(**{k: jnp.asarray(v)
                                             for k, v in kp.items()}),
                     descriptors=jnp.asarray(feats.descriptors.numpy()))


def test_load_pruned_device_db_matches_jax(scene):
    """load_pruned_device_db of the same store: the cell index bit-exact
    against JAX's, the coarse DB its coarsest LoD, and — fed JAX's own
    window — the window's rows (sel) bit-exact."""
    _, path, feats = scene
    jp = jloc.load_pruned_device_db(JFeatureStore.load(path),
                                    window_capacity=1024, pad_multiple=512)
    tp = tloc.load_pruned_device_db(open_store(path), window_capacity=1024,
                                    pad_multiple=512, device="cpu")
    for f in ("rows", "order", "starts", "grid"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    np.testing.assert_array_equal(tp.coarse.descriptors.numpy(),
                                  np.asarray(jp.coarse.descriptors))
    assert tp.has_world and tp.world_frame == jp.world_frame == "ecef"
    jres = jloc._pruned_back_half(_jfeats(feats), (N, N), jp,
                                  JCameraModel.ideal(*CAM), JCFG, False, 0.25)
    win = tloc.window_rows(tp, torch.from_numpy(np.array(jres.window)))
    np.testing.assert_array_equal(win.sel.numpy(), np.asarray(jres.sel))
    assert int(win.n_window) == int(jres.n_window) > 0


def test_localize_coarse_to_fine_matches_jax(scene):
    """Two-stage localization through the store at 256²: the window
    within 1 px of JAX's, the fine homography inliers at Jaccard ≥ 0.95
    with JAX's (paired by query keypoint within 0.01 px: the two windows
    may hold the rows in other slots), and the port's fine H recovering
    the (13, 7) px shift within 0.5 px."""
    frame, path, _ = scene
    jfine, _, jwin = jloc.localize_coarse_to_fine(
        jnp.asarray(frame), JFeatureStore.load(path),
        JCameraModel.ideal(*CAM), JCFG, pad_multiple=2048, solve_pose=False)
    fine, coarse, win = tloc.localize_coarse_to_fine(
        torch.from_numpy(frame), open_store(path), CameraModel.ideal(*CAM),
        TCFG, pad_multiple=2048, solve_pose=False, device="cpu")
    assert bool(coarse.homography.ok) and win is not None and jwin is not None
    np.testing.assert_allclose(win, jwin, atol=1.0)
    assert bool(fine.homography.ok) and bool(jfine.homography.ok)

    def inlier_xy(r):
        m = np.asarray(r.matches.valid) & np.asarray(r.homography.inliers)
        return np.asarray(r.keypoints.xy)[np.asarray(r.matches.query_idx)[m]]

    a, b = inlier_xy(fine), inlier_xy(jfine)
    hits = int((np.abs(a[:, None] - b[None]).max(-1) <= 1e-2).any(1).sum())
    assert len(a) > 30 and hits / (len(a) + len(b) - hits) >= 0.95
    np.testing.assert_allclose(fine.homography.H.numpy()[:2, 2], [13.0, 7.0],
                               atol=0.5)
