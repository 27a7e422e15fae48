"""The serving step's back half as one CUDA graph a key
(cubesat_apds_tpu_torch/pipelines/step_graph.py), the sync-free frame
upload and the refit's Procrustes kernel (csrc/procrustes3.cu).

On the CPU: the graph key (what the capture fixes, and what it does not:
a new DB of the same shapes keeps the key), the back half running as it
is, the upload helper, and the Procrustes dispatch to its plain twin.
On the card (`cuda`-marked, skipped without a GPU): the graphed back half
equal to the eager one bit for bit (full DB, kernel 4's big-DB branch,
pruned), a second DB of the same shapes through the same graph, a held
result unchanged by the next call, a warmed step under
set_sync_debug_mode("error"), and the Procrustes kernel against its twin.

This file imports torch and the port only, so it also runs on a GPU host
without jax:

    python -m pytest --noconftest tests/test_torch_step_graph.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from cubesat_apds_tpu_torch.core.config import (
    AkazeConfig, MatchConfig, PipelineConfig, PnPConfig, RansacConfig)
from cubesat_apds_tpu_torch.core.types import (
    CameraModel, Features, Keypoints, to_device, upload)
from cubesat_apds_tpu_torch.ops.kernels import procrustes as tproc
from cubesat_apds_tpu_torch.pipelines import localize as tloc
from cubesat_apds_tpu_torch.pipelines import step_graph

CFG = PipelineConfig(akaze=AkazeConfig(capacity=512),
                     match=MatchConfig(ratio=0.75),
                     ransac=RansacConfig(num_hypotheses=64),
                     pnp=PnPConfig(num_hypotheses=16))
CAM = (300.0, 300.0, 128.0, 128.0)


def _features(lead, cap, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    shape = tuple(lead) + (cap,)
    kp = Keypoints(xy=torch.rand(shape + (2,), generator=g) * 256,
                   size=torch.ones(shape), angle=torch.zeros(shape),
                   response=torch.rand(shape, generator=g),
                   octave=torch.zeros(shape, dtype=torch.int32),
                   class_id=torch.zeros(shape, dtype=torch.int32),
                   valid=torch.ones(shape, dtype=torch.bool))
    desc = torch.randint(0, 256, shape + (61,), generator=g,
                         dtype=torch.uint8)
    return to_device(Features(keypoints=kp, descriptors=desc), device)


def _db(rows, seed=1, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand((rows, 2), generator=g) * 256
    return tloc.DeviceDb(
        descriptors=torch.randint(0, 256, (rows, 61), generator=g,
                                  dtype=torch.uint8).to(device),
        xy=xy.to(device), valid=torch.ones(rows, dtype=torch.bool,
                                           device=device),
        obj_points=torch.cat([xy, torch.zeros((rows, 1))], 1).to(device),
        has_world=True)


def _key(feats=None, db=None, config=CFG, solve_pose=True, stream=7):
    feats = _features((), 512) if feats is None else feats
    db = _db(2048) if db is None else db
    cam = CameraModel.ideal(*CAM)
    return step_graph.step_key(tloc.localize_from_features,
                               (feats, db, cam, config, solve_pose), stream)


def test_step_key_separates_what_the_capture_fixes():
    """A new DB (and new features) of the same shapes keeps the key, as a
    jitted function keeps its executable for new arrays of one shape; the
    capacity, the batch, the DB's rows, `solve_pose`, the configuration,
    the kNN-2 layout's presence, the function or the stream give another
    key."""
    base = _key()
    assert _key(feats=_features((), 512, seed=5),
                db=_db(2048, seed=9)) == base
    assert hash(_key()) == hash(base)
    others = [
        _key(feats=_features((), 256)),                    # capacity
        _key(feats=_features((8,), 512)),                  # batch
        _key(db=_db(4096)),                                # DB rows
        _key(solve_pose=False),
        _key(config=dataclasses.replace(
            CFG, ransac=RansacConfig(num_hypotheses=128))),
        _key(db=dataclasses.replace(_db(2048), match_layout=(
            torch.zeros(2048, 16, dtype=torch.int32),
            torch.zeros(2048, dtype=torch.int32)))),
        _key(stream=8),
        step_graph.step_key(tloc._pruned_back_half, (_features((), 512),),
                            7),
    ]
    assert len({base, *others}) == len(others) + 1


def test_leaves_follow_the_structure():
    """`leaves` lists a nested argument's tensors in one fixed order, the
    order in which the static copies are made and filled; `spec` records
    the non-tensor fields as they are."""
    feats, db = _features((), 4), _db(8)
    got = step_graph.leaves((feats, db, True))
    want = [getattr(feats.keypoints, f.name)
            for f in dataclasses.fields(feats.keypoints)] \
        + [feats.descriptors, db.descriptors, db.xy, db.valid, db.obj_points]
    assert len(got) == len(want)
    assert all(a is b for a, b in zip(got, want))
    s = step_graph.spec(db)
    assert ("has_world", True) in s and ("world_frame", "local") in s


def test_back_half_runs_eagerly_on_the_cpu():
    """On the CPU the graphed entry points are the functions themselves:
    the same result bit for bit, and no graph is made."""
    feats, db = _features((2,), 256), _db(1024)
    cam = CameraModel.ideal(*CAM)
    n = len(step_graph.step_graphs())
    got = tloc.back_half(feats, db, cam, CFG, True)
    want = tloc.localize_from_features(feats, db, cam, CFG, True)
    for a, b in zip(step_graph.leaves(got), step_graph.leaves(want)):
        assert torch.equal(a, b)
    assert got.keypoints is feats.keypoints
    assert len(step_graph.step_graphs()) == n
    with pytest.raises(ValueError, match="neither CPU nor CUDA"):
        step_graph.run(tloc.localize_from_features,
                       _features((), 4, device="meta"))


def test_upload_keeps_device_tensors_and_converts_host_data():
    """A host array becomes a tensor of the asked dtype on the device; a
    tensor already there, of that dtype, is used as it is."""
    a = np.arange(12, dtype=np.uint8).reshape(3, 4)
    t = upload(a, "cpu", torch.float32)
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    assert torch.equal(t, torch.from_numpy(a).float())
    x = torch.rand(3, 4)
    assert upload(x, "cpu", torch.float32) is x
    assert upload(x, torch.device("cpu")) is x


def test_entry_point_takes_a_host_array():
    """localize_frame_jit on a numpy frame and on the same frame as a
    tensor: the same result bit for bit (the upload converts, nothing
    else changes)."""
    rng = np.random.default_rng(42)
    frame = np.zeros((128, 128), np.float32)
    for _ in range(40):
        cy, cx = rng.integers(4, 100, 2)
        s = int(rng.integers(4, 20))
        frame[cy:cy + s, cx:cx + s] = rng.uniform(0.2, 1.0)
    cfg = dataclasses.replace(CFG, akaze=AkazeConfig(capacity=256))
    db = _db(1024)
    cam = CameraModel.ideal(*CAM)
    a = tloc.localize_frame_jit(frame, db, cam, cfg, True)
    b = tloc.localize_frame_jit(torch.from_numpy(frame), db, cam, cfg, True)
    for x, y in zip(step_graph.leaves(a), step_graph.leaves(b)):
        assert torch.equal(x, y)


def _rotations(rng, n):
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], 1)


def procrustes_cases(seed=0):
    """float32 [N, 3, 3] cross-covariances: seeded random ones over twelve
    decades of scale, near-singular ones (s3 ~ 1e-7 s1), reflections (det
    S < 0, distinct singular values), exact rank 2, and the zero matrix,
    as (label, S) pairs."""
    rng = np.random.default_rng(seed)
    U, V = _rotations(rng, 256), _rotations(rng, 256)
    s = np.sort(rng.uniform(0.2, 1.0, (256, 3)), axis=1)[:, ::-1]
    near = s.copy()
    near[:, 2] = 1e-7 * rng.uniform(size=256)
    rank2 = s.copy()
    rank2[:, 2] = 0.0
    flip = np.diag([1.0, 1.0, -1.0])

    def make(sv, Ua=U):
        return np.einsum("nij,nj,nkj->nik", Ua, sv, V).astype(np.float32)

    scale = 10.0 ** rng.uniform(-6, 6, (512, 1, 1))
    return [("random", (rng.standard_normal((512, 3, 3)) * scale)
             .astype(np.float32)),
            ("near-singular", make(near)),
            ("reflection", make(s, U @ flip)),
            ("rank 2", make(rank2)),
            ("zero", np.zeros((1, 3, 3), np.float32))]


def test_procrustes_dispatch_runs_the_twin_on_the_cpu():
    """On the CPU the refit's rotation is the plain twin (the JAX
    package's SVD form), so the CPU path keeps its bits; R is a rotation
    nearest to S, and a non-finite S gives a NaN R."""
    for label, S in procrustes_cases():
        St = torch.from_numpy(S)
        R = tproc.procrustes_rotation(St)
        assert torch.equal(R, tproc.procrustes_rotation_plain(St)), label
        Rd = R.double()
        eye = torch.eye(3, dtype=torch.float64)
        assert float((Rd.transpose(-1, -2) @ Rd - eye).abs().max()) < 1e-5
        assert float((torch.linalg.det(Rd) - 1).abs().max()) < 1e-5
    S = torch.eye(3).repeat(3, 1, 1)
    S[1, 0, 2] = float("nan")
    S[2, 1, 1] = float("inf")
    R = tproc.procrustes_rotation(S)
    assert torch.equal(R[0], torch.eye(3))
    assert bool(R[1:].isnan().all())
    with pytest.raises(ValueError, match="not CUDA"):
        tproc.procrustes_rotation_cuda(S)


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels and graphs have "
                    "no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_procrustes_kernel_matches_twin_on_card(cuda_device):
    """The kernel against its twin evaluated in float64 (the kernel's own
    precision) on every case, R within 1e-6; one device-counted launch a
    call; NaN where S is not finite. (Against the float32 twin R differs
    by the float32 SVD's own rounding, up to ~1e-5 on ill-conditioned
    random matrices.)"""
    for label, S in procrustes_cases(3):
        St = torch.from_numpy(S).to(cuda_device)
        before = tproc.device_launches(cuda_device)
        R = tproc.procrustes_rotation(St)
        assert tproc.device_launches(cuda_device) == before + 1
        want = tproc.procrustes_rotation_plain(St.double()).float()
        err = float((R - want).abs().max())
        assert err <= 1e-6, (label, err)
    S = torch.eye(3, device=cuda_device).repeat(2, 1, 1)
    S[1, 2, 0] = float("nan")
    R = tproc.procrustes_rotation(S)
    assert torch.equal(R[0], S[0]) and bool(R[1].isnan().all())


def _card_scene(device, seed=42, n=256, rows=2048):
    """A corner-rich frame, and a DB of the port's features of the frame
    rolled by (7, 13), tiled to `rows` and perturbed past the first copy
    (tests/test_torch_localize.py's scene, made with the port)."""
    from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute

    rng = np.random.default_rng(seed)
    frame = np.zeros((n, n), np.float32)
    for _ in range(60):
        cy, cx = rng.integers(10, n - 50, 2)
        s = int(rng.integers(8, 40))
        frame[cy:cy + s, cx:cx + s] = rng.uniform(0.2, 1.0)
    f = detect_and_compute(torch.from_numpy(
        np.roll(frame, (7, 13), (0, 1))).to(device), CFG.akaze)
    cap = CFG.akaze.capacity
    reps = rows // cap
    desc = f.descriptors.repeat(reps, 1)
    flip = torch.from_numpy(rng.integers(0, 256, desc.shape, dtype=np.uint8)
                            & (rng.integers(0, 2, desc.shape, dtype=np.uint8)
                               * 255)).to(device)
    flip[:cap] = 0
    xy = f.keypoints.xy.repeat(reps, 1)
    db = tloc.DeviceDb(descriptors=desc ^ flip, xy=xy,
                       valid=f.keypoints.valid.repeat(reps),
                       obj_points=torch.cat([xy, torch.zeros_like(xy[:, :1])],
                                            1), has_world=True)
    return frame, db


def _equal(a, b):
    la, lb = step_graph.leaves(a), step_graph.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.cuda
@pytest.mark.parametrize("big", [False, True])
def test_graphed_back_half_equals_eager_on_card(cuda_device, big):
    """The back half through its graph equals the eager back half bit for
    bit on the same features: a lone frame and a batch of 3, the dense
    match and kernel 4's branch (db_block below the DB's rows); a second
    DB of the same shapes runs through the same graph and equals the eager
    back half on it; a result the caller holds is unchanged by the next
    call; kernel 4 and the Procrustes kernel count one launch a replay on
    the device; a warmed step on a host frame runs under
    set_sync_debug_mode("error")."""
    from cubesat_apds_tpu_torch.ops.features.akaze import (
        detect_and_compute, detect_and_compute_batch)
    from cubesat_apds_tpu_torch.ops.kernels import match_kernel as tmk

    cfg = dataclasses.replace(CFG, match=MatchConfig(
        ratio=0.75, db_block=1024 if big else 65536))
    frame, db = _card_scene(cuda_device)
    _, db2 = _card_scene(cuda_device, seed=7)
    if big:
        db = tloc.resident_db(db, cfg, cuda_device)
        db2 = tloc.resident_db(db2, cfg, cuda_device)
        assert db.match_layout is not None
    cam = CameraModel.ideal(*CAM, device=cuda_device)
    x = torch.from_numpy(frame).to(cuda_device)
    step_graph.clear_step_graphs()
    for feats in (detect_and_compute(x, cfg.akaze),
                  detect_and_compute_batch(torch.stack(
                      [x, x.roll(3, 0), x.roll(5, 1)]), cfg.akaze)):
        first = tloc.back_half(feats, db, cam, cfg, True)
        held = [t.clone() for t in step_graph.leaves(first)]
        eager = tloc.localize_from_features(feats, db, cam, cfg, True)
        assert _equal(first, eager)
        n = len(step_graph.step_graphs())
        k4 = tmk.device_launches(cuda_device)
        pr = tproc.device_launches(cuda_device)
        other = tloc.back_half(feats, db2, cam, cfg, True)
        assert tmk.device_launches(cuda_device) - k4 == int(big)
        assert tproc.device_launches(cuda_device) - pr == 1
        assert len(step_graph.step_graphs()) == n
        assert _equal(other, tloc.localize_from_features(feats, db2, cam,
                                                         cfg, True))
        assert all(torch.equal(a, b)
                   for a, b in zip(step_graph.leaves(first), held))
    assert len(step_graph.step_graphs()) == 2    # B = 1 and B = 3

    tloc.localize_frame_jit(frame, db, cam, cfg, True)      # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tloc.localize_frame_jit(torch.from_numpy(frame), db, cam, cfg,
                                      True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(got.homography.ok)
    assert step_graph.clear_step_graphs() == 2


@pytest.mark.cuda
def test_graphed_pruned_back_half_equals_eager_on_card(cuda_device):
    """The pruned back half through its graph equals `_pruned_back_half`
    bit for bit on the same features, and a warmed pruned step runs
    under set_sync_debug_mode("error")."""
    from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute

    frame, db = _card_scene(cuda_device, rows=8192)
    coarse = tloc.DeviceDb(descriptors=db.descriptors[:2048],
                           xy=db.xy[:2048], valid=db.valid[:2048],
                           obj_points=db.obj_points[:2048], has_world=True)
    pdb = tloc.make_pruned_db(db, coarse, 4096)
    cam = CameraModel.ideal(*CAM, device=cuda_device)
    feats = detect_and_compute(torch.from_numpy(frame).to(cuda_device),
                               CFG.akaze)
    got = tloc.pruned_back_half(feats, frame.shape, pdb, cam, CFG, True,
                                0.25)
    want = tloc._pruned_back_half(feats, frame.shape, pdb, cam, CFG, True,
                                  0.25)
    assert _equal(got, want)
    tloc.localize_frame_pruned_jit(frame, pdb, cam, CFG, True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tloc.localize_frame_pruned_jit(frame, pdb, cam, CFG, True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    step_graph.clear_step_graphs()
