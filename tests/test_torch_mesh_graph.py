"""The mesh serve step and the sharded kNN-2 as CUDA graphs a dp row
(cubesat_apds_tpu_torch/parallel/{mesh,sharded_match,serve}.py): the
port's counterpart of the JAX package's jit of `make_batch_localizer`
and of the three sharded makers.

On the CPU (no graphs there, the functions run as they are): how a row is
routed (one graph of the whole back half when one process holds the row
on one device; else a graph of partials and merge a device group, then a
geometry graph on the row's first slot), the graph key (rows of one shape
on one device share it), the merge of merged groups against one merge of
every shard, and the row's back half against the single-device back half
on its frames, bit for bit. On the card (`cuda`-marked, skipped without a
GPU): the graphed mesh step against the eager composition at dp 2 × tp 2,
dp 1 × tp 4 and dp 4 × tp 1, dense and kernel 4, with and without pose;
rows sharing one graph, a held result, kernel 4's device count, a warmed
step under set_sync_debug_mode("error"), and the graphed sharded kNN-2
against one kernel-4 launch over the whole DB.

The scene is tests/test_torch_parallel.py's: a 128² base of rectangles,
four frames rolled by 0–3 px, and a 1,000-row DB of the port's features
of the base and seeded filler. This file imports torch and the port only,
so it also runs on a GPU host without jax:

    python -m pytest --noconftest tests/test_torch_mesh_graph.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from cubesat_apds_tpu_torch.core import step_graph
from cubesat_apds_tpu_torch.core.config import (
    DESC_BYTES, AkazeConfig, MatchConfig, PipelineConfig, RansacConfig)
from cubesat_apds_tpu_torch.core.types import CameraModel, Features, Keypoints
from cubesat_apds_tpu_torch.ops import match as TM
from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute_batch
from cubesat_apds_tpu_torch.parallel import mesh as tmesh
from cubesat_apds_tpu_torch.parallel import serve
from cubesat_apds_tpu_torch.parallel import sharded_match as tsm
from cubesat_apds_tpu_torch.parallel.mesh import Mesh, make_mesh
from cubesat_apds_tpu_torch.pipelines.localize import (
    DeviceDb, localize_from_features)

torch.set_num_threads(2)

CAM = (100.0, 100.0, 64.0, 64.0)


def _cfg(kernel="auto"):
    return PipelineConfig(akaze=AkazeConfig(capacity=256),
                          match=MatchConfig(ratio=0.75, kernel=kernel,
                                            db_block=256),
                          ransac=RansacConfig(num_hypotheses=64))


def _scene(seed=11, m=1000):
    """The four rolled 128² frames and a DeviceDb whose first 256 rows are
    the port's features of the base (world points from their xy)."""
    from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute

    rng = np.random.default_rng(seed)
    base = np.zeros((128, 128), np.float32)
    for _ in range(25):
        cy, cx = rng.integers(5, 100, 2)
        s = int(rng.integers(8, 20))
        base[cy:cy + s, cx:cx + s] = rng.uniform(0.3, 1.0)
    frames = np.stack([np.roll(base, i, axis=1) for i in range(4)])
    feats = detect_and_compute(torch.from_numpy(base),
                               AkazeConfig(capacity=256))
    rng = np.random.default_rng(seed + 1)
    desc = torch.from_numpy(rng.integers(0, 256, (m, DESC_BYTES),
                                         dtype=np.uint8))
    xy = torch.from_numpy(rng.uniform(0, 128, (m, 2)).astype(np.float32))
    valid = torch.ones(m, dtype=torch.bool)
    desc[:256] = feats.descriptors
    xy[:256] = feats.keypoints.xy
    valid[:256] = feats.keypoints.valid
    db = DeviceDb(descriptors=desc, xy=xy, valid=valid,
                  obj_points=torch.cat([xy, torch.zeros((m, 1))], 1),
                  has_world=True)
    return torch.from_numpy(frames), db


@pytest.fixture(scope="module")
def scene():
    return _scene()


def _flat(res):
    return tuple(serve._flat(res.homography, res.pose, res.num_matches,
                             res.num_keypoints))


def _equal(a, b):
    la, lb = step_graph.leaves(tuple(a)), step_graph.leaves(tuple(b))
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


# ---- the routing ------------------------------------------------------------


def test_row_routing_without_a_card():
    """A row that one process holds on one device is one graph of the
    whole back half; slots on several devices or in several processes
    split it into a graph of partials and merge a device group and a
    geometry graph on the row's first slot (meshes from torch.device
    lists, no card needed)."""
    c0, c1 = torch.device("cuda:0"), torch.device("cuda:1")
    one = make_mesh(dp=2, tp=2, devices=["cuda:0"] * 4)
    for i in range(2):
        assert one.row_groups(i) == [(c0, (0, 1))]
        assert one.row_device(i) == c0
    two = make_mesh(dp=2, tp=2, devices=["cuda:0", "cuda:1"] * 2)
    for i in range(2):
        assert two.row_groups(i) == [(c0, (0,)), (c1, (1,))]
        assert two.row_device(i) is None
    devs = np.empty((2, 2), dtype=object)
    devs[:] = [[c0, c0], [c0, c0]]
    for rank in range(2):
        ranks = Mesh(devices=devs, ranks=np.array([[0, 0], [1, 1]]),
                     rank=rank)
        assert ranks.row_groups(rank) == [(c0, (0, 1))]
        assert ranks.row_groups(1 - rank) == []
        assert ranks.row_device(0) is None and ranks.row_device(1) is None
    row = np.empty((1, 4), dtype=object)
    row[:] = [[c0, c0, c1, c1]]
    tp4 = Mesh(devices=row, ranks=np.array([[0, 0, 1, 1]]), rank=1)
    assert tp4.row_groups(0) == [(c1, (2, 3))] and not tp4.is_local(0, 0)


@pytest.mark.parametrize("devices", [["cpu"] * 4, ["cpu", "cpu:0"] * 2])
def test_step_runs_one_graph_a_row_or_the_split(scene, monkeypatch,
                                                devices):
    """The step's calls into the mesh's graph cache: `_row_back_half` once
    a row when each row sits on one device; `group_top2` once a device
    group and `_row_geometry` once a row when a row's slots are on two
    devices ("cpu" and "cpu:0" are two slots' devices here). Both give
    the same bits."""
    frames, db = scene
    cfg = _cfg("fused")
    mesh = make_mesh(dp=2, tp=2, devices=devices)
    calls = []

    def recorded(fn, *args):
        calls.append(fn.__name__)
        return fn(*args)

    monkeypatch.setattr(serve, "run_graph", recorded)
    monkeypatch.setattr(tsm, "run_graph", recorded)
    step = serve.make_batch_localizer(mesh, CameraModel.ideal(*CAM), cfg)
    got = step(frames, serve.shard_device_db(mesh, db, match_config=cfg.match))
    if devices[1] == "cpu":
        assert calls == ["_row_back_half"] * 2
    else:
        assert calls == ["group_top2", "group_top2", "_row_geometry"] * 2
    ref = [_flat(localize_from_features(detect_and_compute_batch(
        frames[2 * i:2 * i + 2], cfg.akaze), db, CameraModel.ideal(*CAM),
        cfg, True)) for i in range(2)]
    want = serve._unflat([torch.cat([r[k] for r in ref])
                          for k in range(len(ref[0]))], True)
    assert _equal(got, want)


# ---- the key ----------------------------------------------------------------


def _features(lb, cap, seed=0):
    g = torch.Generator().manual_seed(seed)
    shape = (lb, cap)
    kp = Keypoints(xy=torch.rand(shape + (2,), generator=g) * 128,
                   size=torch.ones(shape), angle=torch.zeros(shape),
                   response=torch.rand(shape, generator=g),
                   octave=torch.zeros(shape, dtype=torch.int32),
                   class_id=torch.zeros(shape, dtype=torch.int32),
                   valid=torch.ones(shape, dtype=torch.bool))
    return Features(keypoints=kp, descriptors=torch.randint(
        0, 256, shape + (DESC_BYTES,), generator=g, dtype=torch.uint8))


def test_row_key_shared_by_rows_and_what_changes_it(scene):
    """Rows 0 and 1 of a dp 2 × tp 2 mesh on one device pass the same
    shard, xy and world-point tensors and have one key (a graph each row
    replays); tp, the match route, solve_pose, the row's frames (lb), the
    capacity and the DB's rows each give another key."""
    _, db = scene
    cam = CameraModel.ideal(*CAM)

    def key(row=0, tp=2, kernel="fused", pose=True, lb=2, cap=256,
            rows=1000):
        mesh = make_mesh(dp=2, tp=tp, devices=["cpu"] * (2 * tp))
        cfg = _cfg(kernel)
        d = dataclasses.replace(
            db, **{k: getattr(db, k)[:rows] for k in
                   ("descriptors", "xy", "valid", "obj_points")})
        mdb = serve.shard_device_db(mesh, d, match_config=cfg.match)
        args = serve._row_args(mdb, row, _features(lb, cap, seed=row), cam,
                               cfg, pose)
        return step_graph.step_key(serve._row_back_half, args, 0), mdb, args

    k0, mdb, a0 = key(row=0)
    tail0 = step_graph.leaves(a0[1:])
    args1 = serve._row_args(mdb, 1, _features(2, 256, seed=1), a0[4],
                            a0[5], True)
    assert step_graph.step_key(serve._row_back_half, args1, 0) == k0
    assert all(x is y for x, y in zip(tail0, step_graph.leaves(args1[1:])))
    assert key(row=1)[0] == k0
    for change in (dict(tp=4), dict(kernel="scan"), dict(pose=False),
                   dict(lb=4), dict(cap=128), dict(rows=996)):
        assert key(**change)[0] != k0, change


# ---- merge associativity ----------------------------------------------------


def _merge_case(case, rng):
    """(queries [Q, 61], DB [M, 61], valid [M], tp) for a merge case."""
    q = rng.integers(0, 256, (48, DESC_BYTES), dtype=np.uint8)
    db = rng.integers(0, 256, (1000, DESC_BYTES), dtype=np.uint8)
    valid = np.ones(1000, bool)
    if case == "ties":                 # copies in every shard
        for s in range(4):
            db[s * 250 + 7:s * 250 + 23] = q[:16]
            db[s * 250 + 100:s * 250 + 116] = q[:16]
    elif case == "empty group":        # shards 2 and 3 hold no valid row
        db[600:616] = q[:16]
        valid[500:] = False
    else:                              # 1,001 rows, padded to 1,004
        db = np.concatenate([db, q[:1]])
        db[[3, 997]] = q[1]
        valid = np.ones(1001, bool)
    return q, db, valid, 4


@pytest.mark.parametrize("local", ["dense", "fused"])
@pytest.mark.parametrize("case", ["ties", "empty group", "ragged"])
def test_merge_of_group_merges_equals_one_merge(case, local):
    """merge_partials over the merged groups {0}, {1, 2, 3} and {0, 1},
    {2, 3} gives the bits of one merge of all four shards, which is one
    kNN-2 over the whole DB: ties at the lowest global index, a group with
    no valid row (its key int32-max, its second best no candidate) and a
    ragged last shard padded with invalid rows."""
    rng = np.random.default_rng(5)
    q, db, valid, tp = _merge_case(case, rng)
    pad = (-len(db)) % tp
    dbp = np.concatenate([db, np.zeros((pad, DESC_BYTES), np.uint8)])
    vp = np.concatenate([valid, np.zeros(pad, bool)])
    m_shard = len(dbp) // tp
    q_bits = TM.unpack_bits(torch.from_numpy(q))
    mesh = make_mesh(dp=1, tp=tp, devices=["cpu"] * tp)
    fn = (tsm.make_sharded_knn2(mesh) if local == "dense"
          else tsm.make_sharded_knn2_fused(mesh, db_block=64))
    placed = fn.place(TM.unpack_bits(torch.from_numpy(dbp))
                      if local == "dense" else torch.from_numpy(dbp),
                      torch.from_numpy(vp))
    _, _, inputs, offsets, m_total = fn.group_args(placed, 0, range(tp))
    parts = tsm.shard_partials(q_bits, fn.local, fn.block, inputs)
    one = tsm.merge_partials(parts, offsets, m_total)
    whole = TM.knn2(q_bits, TM.unpack_bits(torch.from_numpy(db)),
                    db_valid=torch.from_numpy(valid))
    assert _equal(one, whole)
    for groups in (((0,), (1, 2, 3)), ((0, 1), (2, 3))):
        tops = [tsm.group_top2(q_bits, fn.local, fn.block,
                               tuple(inputs[t] for t in g),
                               tuple(offsets[t] for t in g), m_total)
                for g in groups]
        assert _equal(tsm.merge_partials(tops, [0] * len(tops), m_total),
                      one), groups
    assert _equal(fn(q_bits, placed), one)
    if case == "ties":
        assert (one[2][:16] == torch.arange(7, 23)).all()
        assert (one[0][:16] == 0).all() and (one[1][:16] == 0).all()
    if case == "empty group":
        assert (one[2] < 500).all()


# ---- the row's back half ----------------------------------------------------


@pytest.mark.parametrize("pose", [False, True])
def test_row_back_half_equals_localize_from_features(scene, pose):
    """`_row_back_half` of each row of a dp 2 × tp 2 mesh (kernel 4's twin
    a shard) equals the single-device back half on that row's frames,
    `localize_from_features`, bit for bit."""
    frames, db = scene
    cfg = _cfg()
    cam = CameraModel.ideal(*CAM)
    mesh = make_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    mdb = serve.shard_device_db(mesh, db, match_config=cfg.match)
    assert mdb.fused
    for i in range(2):
        feats = detect_and_compute_batch(frames[2 * i:2 * i + 2], cfg.akaze)
        got = serve._row_back_half(*serve._row_args(mdb, i, feats, cam, cfg,
                                                    pose))
        want = _flat(localize_from_features(feats, db, cam, cfg, pose))
        assert len(got) == 6 + 5 * pose and _equal(got, want), i


# ---- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels and graphs have "
                    "no CPU mode")
    return torch.device("cuda")


def _eager_step(mesh, mdb, frames, cam, cfg, pose):
    """The mesh step's eager composition on one card: each row's features,
    then `_row_back_half` called directly, the rows concatenated."""
    dp = mesh.shape["dp"]
    lb = frames.shape[0] // dp
    rows = []
    for i in range(dp):
        feats = detect_and_compute_batch(frames[i * lb:(i + 1) * lb],
                                         cfg.akaze)
        rows.append(serve._row_back_half(*serve._row_args(
            mdb, i, feats, cam, cfg, pose)))
    return serve._unflat([torch.cat([r[k] for r in rows])
                          for k in range(len(rows[0]))], pose)


@pytest.mark.cuda
@pytest.mark.parametrize("pose", [False, True])
@pytest.mark.parametrize("kernel", ["scan", "fused"])
@pytest.mark.parametrize("dp,tp", [(2, 2), (1, 4), (4, 1)])
def test_graphed_mesh_step_equals_eager_on_card(cuda_device, scene, dp, tp,
                                                kernel, pose):
    """On one card every dp row is one graph of its back half: the step
    equals the eager composition bit for bit; the rows share one graph;
    kernel 4 counts one device launch a shard a row (none on the dense
    route); a held result survives the next call; a warmed step runs
    under set_sync_debug_mode("error")."""
    from cubesat_apds_tpu_torch.ops.kernels import match_kernel as tmk

    frames, db = scene
    frames = frames.to(cuda_device)
    cfg = _cfg(kernel)
    cam = CameraModel.ideal(*CAM, device=cuda_device)
    mesh = make_mesh(dp=dp, tp=tp, devices=[cuda_device] * (dp * tp))
    mdb = serve.shard_device_db(mesh, db, match_config=cfg.match)
    assert mdb.fused == (kernel == "fused")
    step = serve.make_batch_localizer(mesh, cam, cfg, solve_pose=pose)
    tmesh.clear_mesh_graphs()
    got = step(frames, mdb)
    assert len(tmesh.mesh_graphs()) == 1
    assert _equal(got, _eager_step(mesh, mdb, frames, cam, cfg, pose))
    held = [t.clone() for t in step_graph.leaves(got)]
    before = tmk.device_launches(cuda_device)
    other = step(torch.flip(frames, (2,)), mdb)
    assert tmk.device_launches(cuda_device) - before == (
        dp * tp if kernel == "fused" else 0)
    assert len(tmesh.mesh_graphs()) == 1
    assert all(torch.equal(a, b) for a, b in zip(held, step_graph.leaves(got)))
    assert _equal(other, _eager_step(mesh, mdb, torch.flip(frames, (2,)),
                                     cam, cfg, pose))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(frames, mdb)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    tmesh.clear_mesh_graphs()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [65536, 65533])
@pytest.mark.parametrize("tp", [2, 4])
def test_graphed_sharded_fused_equals_one_launch_on_card(cuda_device, tp, m):
    """make_sharded_knn2_fused on tp slots of one card (one graph: the
    shards' kernel-4 launches and their merge) equals one kernel-4 launch
    over the whole DB and the eager partials and merge, bit for bit, with
    near hits, ties across shards and invalid rows; tp device-counted
    launches a warmed call."""
    from cubesat_apds_tpu_torch.ops.kernels import match_kernel as tmk

    g = torch.Generator(device=cuda_device).manual_seed(7)
    q = torch.randint(0, 256, (2048, DESC_BYTES), generator=g,
                      device=cuda_device, dtype=torch.uint8)
    db = torch.randint(0, 256, (m, DESC_BYTES), generator=g,
                       device=cuda_device, dtype=torch.uint8)
    db[[100, m // 2 + 5, m - 3]] = q[:3]
    db[m - 7] = q[0]
    valid = torch.rand(m, generator=g, device=cuda_device) >= 0.05
    one = tmk.knn2_hamming_cuda(tmk.pack_words(q), *tmk.layout_db_blocks(
        tmk.pack_words(db), valid))
    pad = (-m) % tp
    mesh = make_mesh(dp=1, tp=tp, devices=[cuda_device] * tp)
    fn = tsm.make_sharded_knn2_fused(mesh, db_block=4096)
    placed = fn.place(torch.cat([db, db.new_zeros((pad, DESC_BYTES))]),
                      torch.cat([valid, valid.new_zeros(pad)]))
    q_bits = TM.unpack_bits(q)
    tmesh.clear_mesh_graphs()
    assert _equal(fn(q_bits, placed), one)
    before = tmk.device_launches(cuda_device)
    got = fn(q_bits, placed)
    assert tmk.device_launches(cuda_device) - before == tp
    assert len(tmesh.mesh_graphs()) == 1
    assert _equal(got, one)
    eager = tsm.merge_columns(tp, fn.partials(q_bits, placed),
                              placed.shape[0] // tp, 2048, cuda_device)
    assert _equal(eager, one)
    tmesh.clear_mesh_graphs()
