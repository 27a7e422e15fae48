"""The port's device mesh (cubesat_apds_tpu_torch/parallel) against the JAX
package's, on the CPU: the cases of tests/test_parallel.py.

The JAX side runs on the conftest's 8 virtual CPU devices; the port's
meshes are 1–8 `cpu` slots (PyTorch has no virtual devices, so one
device fills several slots). The sharded kNN-2 is held bit for bit
against JAX's sharded step and against one kNN-2 over the whole DB; the
serve step against JAX's per-frame localize_frame_jit (counts and ok
flags equal, H within tests/test_distributed.py's 2e-2) and against the
port's own lone step (bit for bit); preprocess(mesh=) against the port's
single-device build (bit for bit). The 1M-row case runs here at 65,536
rows; chip_smoke.py's mesh phase runs 1,048,576 on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubesat_apds_tpu.core.config import AkazeConfig as JAkazeConfig
from cubesat_apds_tpu.core.config import MatchConfig as JMatchConfig
from cubesat_apds_tpu.core.config import PipelineConfig as JPipelineConfig
from cubesat_apds_tpu.core.config import RansacConfig as JRansacConfig
from cubesat_apds_tpu.core.types import CameraModel as JCameraModel
from cubesat_apds_tpu.ops import match as JM
from cubesat_apds_tpu.parallel import mesh as jmesh
from cubesat_apds_tpu.parallel import sharded_match as jsm
from cubesat_apds_tpu_torch.core.config import (
    DESC_BYTES, AkazeConfig, MatchConfig, PipelineConfig, RansacConfig)
from cubesat_apds_tpu_torch.core.types import CameraModel
from cubesat_apds_tpu_torch.ops import match as TM
from cubesat_apds_tpu_torch.ops.kernels.match_kernel import VPOP_INVALID
from cubesat_apds_tpu_torch.parallel import sharded_match as tsm
from cubesat_apds_tpu_torch.parallel.mesh import (
    make_mesh, replicate, shard_db)
from cubesat_apds_tpu_torch.parallel.serve import (
    make_batch_localizer, shard_device_db)
from cubesat_apds_tpu_torch.pipelines.localize import (
    DeviceDb, localize_frame_jit)

torch.set_num_threads(2)


def _rand_desc(rng, n):
    return rng.integers(0, 256, size=(n, DESC_BYTES), dtype=np.uint8)


def _cpu_mesh(dp, tp):
    return make_mesh(dp=dp, tp=tp, devices=["cpu"] * (dp * tp))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, ref):
    for name, g, r in zip(("d0", "d1", "i0"), got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r),
                                      err_msg=name)


def test_mesh_shapes(monkeypatch):
    """JAX's defaults (dp = 1, tp = every slot) and shapes; one device in
    several slots; a slot count that does not factor is refused; with no
    card visible the default mesh is refused, not put on the CPU."""
    mesh = _cpu_mesh(1, 8)
    assert mesh.devices.size == 8 and mesh.shape == {"dp": 1, "tp": 8}
    assert make_mesh(devices=["cpu"] * 8).shape == {"dp": 1, "tp": 8}
    mesh2 = make_mesh(dp=2, devices=["cpu"] * 8)
    assert mesh2.shape == {"dp": 2, "tp": 4}
    assert mesh2.shape == jmesh.make_mesh(dp=2, tp=4).shape
    assert all(d == torch.device("cpu") for d in mesh2.devices.ravel())
    assert not mesh2.multiprocess and mesh2.home == torch.device("cpu")
    with pytest.raises(ValueError, match="slots"):
        make_mesh(dp=3, tp=3, devices=["cpu"] * 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_sharded_knn2_matches_single_device(rng, monkeypatch, tp):
    """The dense sharded step at tp ∈ {1, 2, 4, 8} equals JAX's sharded
    step on its 8-device mesh and one kNN-2 over the whole DB, bit for
    bit; also when it cuts the queries into chunks."""
    q = _rand_desc(rng, 64)
    db = _rand_desc(rng, 512)
    qb, dbb = JM.unpack_bits(q), JM.unpack_bits(db)
    ref = jsm.make_sharded_knn2(jmesh.make_mesh(dp=1, tp=8))(
        qb, dbb, jnp.ones(512, bool))
    _eq(ref, JM.knn2(qb, dbb))
    got = tsm.make_sharded_knn2(_cpu_mesh(1, tp))(
        TM.unpack_bits(_t(q)), TM.unpack_bits(_t(db)),
        torch.ones(512, dtype=torch.bool))
    _eq(got, ref)
    q2 = TM.unpack_bits(_t(_rand_desc(rng, 300)))
    monkeypatch.setattr(tsm, "_DENSE_TILE", 128 * (512 // tp))  # 128 rows
    _eq(tsm.make_sharded_knn2(_cpu_mesh(1, tp))(
        q2, TM.unpack_bits(_t(db))), TM.knn2(q2, TM.unpack_bits(_t(db))))


def test_sharded_knn2_tie_break_matches(rng):
    """Exact duplicates in every shard: the lowest global index wins and
    the duplicate is the second-best, as in JAX and one device."""
    q = _rand_desc(rng, 16)
    db = np.tile(q, (8, 1))
    qb, dbb = JM.unpack_bits(q), JM.unpack_bits(db)
    ref = jsm.make_sharded_knn2(jmesh.make_mesh(dp=1, tp=8))(
        qb, dbb, jnp.ones(len(db), bool))
    got = tsm.make_sharded_knn2(_cpu_mesh(1, 8))(
        TM.unpack_bits(_t(q)), TM.unpack_bits(_t(db)))
    _eq(got, ref)
    np.testing.assert_array_equal(got[2].numpy(), np.arange(16))
    assert (got[0].numpy() == 0).all() and (got[1].numpy() == 0).all()


def test_sharded_knn_match_semantics(rng):
    """sharded_knn_match equals JAX's (and the single-device knn_match):
    the same valid flags and train indices."""
    q = _rand_desc(rng, 32)
    db = np.concatenate([q, _rand_desc(rng, 32)])
    ref = jsm.sharded_knn_match(jmesh.make_mesh(dp=1, tp=8), q, db,
                                ratio=0.5)
    m = tsm.sharded_knn_match(_cpu_mesh(2, 4), q, db, ratio=0.5)
    np.testing.assert_array_equal(m.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(m.train_idx.numpy(),
                                  np.asarray(ref.train_idx))
    one = TM.knn_match(_t(q), _t(db), ratio=0.5)
    np.testing.assert_array_equal(m.train_idx.numpy(),
                                  one.train_idx.numpy())


def test_sharded_respects_db_valid(rng):
    """Query copies in the last shard, masked out: never matched; the
    result equals JAX's."""
    q = _rand_desc(rng, 8)
    db = np.concatenate([_rand_desc(rng, 56), q])
    db_valid = np.zeros(64, bool)
    db_valid[:56] = True
    ref = jsm.sharded_knn_match(jmesh.make_mesh(dp=1, tp=8), q, db,
                                ratio=1.1, db_valid=jnp.asarray(db_valid))
    m = tsm.sharded_knn_match(_cpu_mesh(1, 8), q, db, ratio=1.1,
                              db_valid=_t(db_valid))
    assert (m.train_idx.numpy() < 56).all()
    assert (m.distance.numpy() > 0).all()
    np.testing.assert_array_equal(m.train_idx.numpy(),
                                  np.asarray(ref.train_idx))
    np.testing.assert_array_equal(m.distance.numpy(),
                                  np.asarray(ref.distance))


def test_explicit_device_placement(rng):
    """shard_db gives every slot its own tp shard (replicated over dp);
    replicate gives every slot the whole tensor; a DB that does not divide
    over tp is refused."""
    mesh = _cpu_mesh(2, 4)
    db = _t(_rand_desc(rng, 128))
    sharded = shard_db(mesh, db)
    assert len(sharded.parts) == 8 and not sharded.is_fully_replicated
    for (i, j), part in sharded.parts.items():
        assert torch.equal(part, db[j * 32:(j + 1) * 32])
        assert part.device == mesh.devices[i, j]
    rep = replicate(mesh, torch.ones(4))
    assert rep.is_fully_replicated
    assert all(torch.equal(p, torch.ones(4)) for p in rep.parts.values())
    with pytest.raises(ValueError, match="tp=4"):
        shard_db(mesh, db[:127])


def test_merge_refuses_past_int32_keys():
    """Past 513·m_total > 2^31 (~4.18M rows) the int32 merge keys would
    overflow: refused before any work, as the JAX package's assert (the
    DB here is a zero-stride view, no memory)."""
    mesh = _cpu_mesh(1, 4)
    q = torch.zeros((2, 512), dtype=torch.int8)
    big = torch.zeros((1, 61), dtype=torch.uint8).expand(4_186_128, 61)
    for maker in (tsm.make_sharded_knn2_blockwise,
                  tsm.make_sharded_knn2_fused):
        with pytest.raises(ValueError, match="4.18M"):
            maker(mesh)(q, big)
    tsm.check_merge_rows(4_186_127)          # 513·m ≤ 2^31 still runs
    with pytest.raises(ValueError, match="4.18M"):
        tsm._merge_partials(torch.zeros((4, 2)), torch.zeros((4, 2)),
                            torch.zeros((4, 2), dtype=torch.int32),
                            4_186_128)


# ---- the big-DB makers ------------------------------------------------------


def _big_db(rng, m_total, q):
    """Exact query copies deep in shards (the lower global index must win)
    and masked holes, as tests/test_parallel.py plants them."""
    db = rng.integers(0, 256, (m_total, DESC_BYTES), dtype=np.uint8)
    a, b, c = m_total * 2 // 5, m_total * 9 // 10, m_total * 3 // 4 + 3
    db[a] = q[0]
    db[b] = q[0]
    db[c] = q[1]
    valid = np.ones(m_total, bool)
    valid[::97] = False
    valid[[a, b, c]] = True
    return db, valid, (a, c)


@pytest.mark.parametrize("tp", [2, 8])
def test_sharded_blockwise_packed_matches_single_device(rng, tp):
    """65,536 PACKED rows sharded over tp, blockwise inside each shard:
    equal to JAX's single-device packed blockwise pass and to its sharded
    one at tp = 8, bit for bit (distances, winners, tie-breaks)."""
    m_total = 1 << 16
    q = _rand_desc(rng, 32)
    db, valid, (a, c) = _big_db(rng, m_total, q)
    qb = JM.unpack_bits(q)
    ref = JM.knn2_blockwise(qb, jnp.asarray(db), 8192, jnp.asarray(valid))
    if tp == 8:
        _eq(jsm.make_sharded_knn2_blockwise(jmesh.make_mesh(dp=1, tp=8),
                                            block=4096)(
            qb, jnp.asarray(db), jnp.asarray(valid)), ref)
    got = tsm.make_sharded_knn2_blockwise(_cpu_mesh(1, tp), block=4096)(
        TM.unpack_bits(_t(q)), _t(db), _t(valid))
    _eq(got, ref)
    assert got[0][0] == 0 and got[2][0] == a
    assert got[0][1] == 0 and got[2][1] == c


@pytest.mark.parametrize("dp,tp", [(1, 8), (2, 4), (1, 1)])
def test_sharded_fused_kernel_matches_blockwise(rng, dp, tp):
    """make_sharded_knn2_fused (the kernel's plain twin on CPU slots, its
    layout made once at .place) equals JAX's sharded fused step (its
    Pallas kernel in interpret mode) and the sharded blockwise scan, bit
    for bit, with a cross-shard tie and validity holes."""
    m_total = 8 * 1024
    q = _rand_desc(rng, 32)
    db = rng.integers(0, 256, (m_total, DESC_BYTES), dtype=np.uint8)
    db[1_500] = q[0]
    db[6_900] = q[0]
    valid = np.ones(m_total, bool)
    valid[::13] = False
    valid[[1_500, 6_900]] = True
    qb = JM.unpack_bits(q)
    ref = JM.knn2(qb, JM.unpack_bits(db), db_valid=jnp.asarray(valid))
    if (dp, tp) == (1, 8):
        _eq(jsm.make_sharded_knn2_fused(jmesh.make_mesh(dp=1, tp=8),
                                        db_block=256)(
            qb, jnp.asarray(db), jnp.asarray(valid)), ref)
    mesh = _cpu_mesh(dp, tp)
    fn = tsm.make_sharded_knn2_fused(mesh, db_block=256)
    placed = fn.place(_t(db), _t(valid))
    tqb = TM.unpack_bits(_t(q))
    got = fn(tqb, placed)
    _eq(got, ref)
    assert got[0][0] == 0 and got[2][0] == 1_500
    _eq(tsm.make_sharded_knn2_blockwise(mesh, block=512)(
        tqb, _t(db), _t(valid)), got)


# ---- the serve step ----------------------------------------------------------


CAM = (100.0, 100.0, 64.0, 64.0)


def _scene(seed=11):
    """tests/test_distributed.py's scene: a 128² base of rectangles and
    four frames rolled by 0–3 px."""
    rng = np.random.default_rng(seed)
    base = np.zeros((128, 128), np.float32)
    for _ in range(25):
        cy, cx = rng.integers(5, 100, 2)
        s = int(rng.integers(8, 20))
        base[cy:cy + s, cx:cx + s] = rng.uniform(0.3, 1.0)
    frames = np.stack([np.roll(base, i, axis=1) for i in range(4)])
    return base, frames


def _scene_db(base, m=1000, seed=12):
    """1000 rows (not a tp multiple): the port's own features of the base
    frame, then seeded random filler."""
    from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute

    feats = detect_and_compute(_t(base), AkazeConfig(capacity=256))
    rng = np.random.default_rng(seed)
    desc = rng.integers(0, 256, (m, 61), dtype=np.uint8)
    xy = rng.uniform(0, 128, (m, 2)).astype(np.float32)
    valid = np.ones(m, bool)
    desc[:256] = feats.descriptors.numpy()
    xy[:256] = feats.keypoints.xy.numpy()
    valid[:256] = feats.keypoints.valid.numpy()
    return desc, xy, valid


def _tcfg(kernel="auto"):
    return PipelineConfig(akaze=AkazeConfig(capacity=256),
                          match=MatchConfig(ratio=0.75, kernel=kernel,
                                            db_block=256),
                          ransac=RansacConfig(num_hypotheses=64))


@pytest.fixture(scope="module")
def serve_scene():
    base, frames = _scene()
    desc, xy, valid = _scene_db(base)
    db = DeviceDb(descriptors=_t(desc), xy=_t(xy), valid=_t(valid),
                  obj_points=torch.zeros((len(desc), 3)), has_world=False)
    return frames, db, (desc, xy, valid)


def _lone(frames, db, cfg):
    cam = CameraModel.ideal(*CAM)
    return [localize_frame_jit(_t(f), db, cam, cfg, solve_pose=False)
            for f in frames]


@pytest.mark.parametrize("kernel", ["scan", "fused"])
def test_batch_localizer_matches_single_device(serve_scene, kernel):
    """The dp=2 × tp=4 serve step (a 1000-row DB, 250 rows a shard) equals
    the port's lone localize_frame_jit per frame bit for bit (H, inliers,
    counts, ok), with the dense per-shard match ("scan") and with the
    kernel's twin per shard ("fused", db_block 256 so the lone step takes
    its big-DB branch too); and JAX's localize_frame_jit on the same DB
    gives equal keypoint and match counts and ok flags, H within 2e-2
    (tests/test_distributed.py's tolerance)."""
    from cubesat_apds_tpu.pipelines.localize import DeviceDb as JDeviceDb
    from cubesat_apds_tpu.pipelines.localize import (
        localize_frame_jit as jlocalize)

    frames, db, (desc, xy, valid) = serve_scene
    cfg = _tcfg(kernel)
    mesh = _cpu_mesh(2, 4)
    db_sh = shard_device_db(mesh, db, match_config=cfg.match)
    assert db_sh.rows % 4 == 0 and db_sh.rows == 1000
    step = make_batch_localizer(mesh, CameraModel.ideal(*CAM), cfg,
                                solve_pose=False)
    homog, pose, n_match, n_kp = step(_t(frames), db_sh)
    assert pose is None
    jcfg = JPipelineConfig(akaze=JAkazeConfig(capacity=256,
                                              detect_topk="exact"),
                           match=JMatchConfig(ratio=0.75),
                           ransac=JRansacConfig(num_hypotheses=64))
    jdb = JDeviceDb(descriptors=jnp.asarray(desc), xy=jnp.asarray(xy),
                    valid=jnp.asarray(valid),
                    obj_points=jnp.zeros((len(desc), 3), jnp.float32),
                    has_world=False)
    any_ok = False
    for i, lone in enumerate(_lone(frames, db, cfg)):
        for k in ("H", "inliers", "num_inliers", "ok"):
            assert torch.equal(getattr(homog, k)[i],
                               getattr(lone.homography, k)), (i, k)
        assert int(n_match[i]) == int(lone.num_matches)
        assert int(n_kp[i]) == int(lone.num_keypoints)
        ref = jlocalize(jnp.asarray(frames[i]), jdb,
                        JCameraModel.ideal(*CAM), jcfg, solve_pose=False)
        assert int(n_kp[i]) == int(ref.num_keypoints)
        assert int(n_match[i]) == int(ref.num_matches)
        assert bool(homog.ok[i]) == bool(ref.homography.ok)
        if bool(ref.homography.ok):
            any_ok = True
            np.testing.assert_allclose(homog.H[i].numpy(),
                                       np.asarray(ref.homography.H),
                                       atol=2e-2)
    assert any_ok


def test_batch_localizer_fused_matches_scan(serve_scene):
    """The serve step with the kernel's twin per shard equals the dense
    per-shard path bit for bit at dp=2 × tp=4, dp=4 × tp=2 and on a
    ragged dp=1 × tp=3 mesh (1000 rows padded with 2 invalid ones), pose
    included (world points from the DB's xy)."""
    frames, db, _ = serve_scene
    db = DeviceDb(descriptors=db.descriptors, xy=db.xy, valid=db.valid,
                  obj_points=torch.cat([db.xy, torch.zeros(len(db.xy), 1)],
                                       1),
                  has_world=True)
    outs = []
    for (dp, tp), kernel in (((2, 4), "scan"), ((2, 4), "fused"),
                             ((4, 2), "fused"), ((1, 3), "fused")):
        cfg = _tcfg(kernel)
        mesh = _cpu_mesh(dp, tp)
        step = make_batch_localizer(mesh, CameraModel.ideal(*CAM), cfg)
        db_sh = shard_device_db(mesh, db, match_config=cfg.match)
        if tp == 3:
            assert db_sh.rows == 1002
            vpop = db_sh.shards.parts[(0, 2)][1]    # kernel 4's layout
            assert db_sh.fused and (vpop[-2:] == VPOP_INVALID).all()
        outs.append(step(_t(frames), db_sh))
    for homog, pose, n_match, n_kp in outs[1:]:
        ref = outs[0]
        assert torch.equal(homog.H, ref[0].H)
        assert torch.equal(homog.ok, ref[0].ok)
        assert torch.equal(pose.rvec, ref[1].rvec)
        assert torch.equal(pose.ok, ref[1].ok)
        assert torch.equal(n_match, ref[2]) and torch.equal(n_kp, ref[3])


# ---- preprocess over a mesh --------------------------------------------------


def test_mesh_parallel_preprocess_matches_single_device(tmp_path, rng):
    """preprocess with each tile batch split over dp gives the SAME store
    as the single-device build, bit for bit (tests/test_parallel.py's
    two-member 256² mosaic, amount_lod 2, tile batch 4 rounded to a dp
    multiple)."""
    from PIL import Image

    from cubesat_apds_tpu_torch.io.mosaic import MosaicDataset
    from cubesat_apds_tpu_torch.pipelines.preprocess import preprocess

    img = np.zeros((256, 256), np.float32)
    for _ in range(60):
        cy, cx = rng.integers(10, 220, 2)
        s = int(rng.integers(6, 24))
        img[cy:cy + s, cx:cx + s] = rng.uniform(0.2, 1.0)
    rgb8 = (np.stack([img] * 3, -1) * 255).astype(np.uint8)
    for name, sl in (("a", np.s_[:, :128]), ("b", np.s_[:, 128:])):
        Image.fromarray(rgb8[sl]).save(
            str(tmp_path / f"{name}.tif"),
            tiffinfo={33550: (0.001, 0.001, 0.0),
                      33922: (0.0, 0.0, 0.0,
                              10.0 + (0.128 if name == "b" else 0.0),
                              56.0, 0.0)})
    ds = MosaicDataset.from_folder(str(tmp_path), device="cpu")
    cfg = PipelineConfig(akaze=AkazeConfig(capacity=256))
    store_ref, stats_ref = preprocess(ds, config=cfg, amount_lod=2,
                                      tile_batch=4)
    store_dp, stats_dp = preprocess(ds, config=cfg, amount_lod=2,
                                    tile_batch=3, mesh=_cpu_mesh(4, 2))
    assert stats_ref.keypoints == stats_dp.keypoints > 20
    assert stats_ref.tiles == stats_dp.tiles
    for k in store_ref._kp:
        np.testing.assert_array_equal(store_ref._kp[k], store_dp._kp[k],
                                      err_msg=k)
    np.testing.assert_array_equal(store_ref._desc, store_dp._desc)
