"""The port's driver hooks (cubesat_apds_tpu_torch/graft_entry.py) against
the JAX package's __graft_entry__.py, on the CPU.

entry(device="cpu"): its frame, DB and camera equal the JAX hook's arrays
bit for bit; its step is the port's localize_frame_jit on them (which
tests/test_torch_localize.py holds against JAX); and one case runs the
JAX hook's step on the same arguments and compares the two.

The dry run at 4 and 8 CPU slots: its inputs equal the JAX hook's draws,
taken in the JAX hook's order (the JAX dry run is called with its mesh
step, sharded kNN-2 and tile extraction replaced by recorders, so no JAX
mesh step is compiled); JAX's assertions hold; each dp row of the serve
step equals the port's single-device batch step on its frames bit for
bit, the sharded kNN-2 the dense one over the whole DB, and the tile
batch the single-device detect_and_compute_batch.
"""

import dataclasses
import importlib.util
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cubesat_apds_tpu_torch import graft_entry
from cubesat_apds_tpu_torch.core.step_graph import leaves
from cubesat_apds_tpu_torch.ops import match as tmatch
from cubesat_apds_tpu_torch.ops.features.akaze import (
    detect_and_compute_batch)
from cubesat_apds_tpu_torch.pipelines.localize import (
    localize_frame_jit, localize_from_features)
from cubesat_apds_tpu_torch.pipelines.stream import _pack_outputs

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
DB_FIELDS = ("descriptors", "xy", "valid", "obj_points")


def _jax_hooks():
    """The JAX package's __graft_entry__.py, loaded from the repo root."""
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", REPO / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def hooks():
    return _jax_hooks()


@pytest.fixture(scope="module")
def port_entry():
    return graft_entry.entry(device="cpu")


def test_entry_arguments_equal_jax(hooks, port_entry):
    """frame [512, 512] float32, the 10,240-row DB and the ideal camera:
    every array equal to the JAX hook's bit for bit, the flags too; the
    step's configuration is the JAX hook's."""
    jfn, (jframe, jdb, jcam) = hooks.entry()
    fn, (frame, db, camera) = port_entry
    assert frame.device.type == "cpu" and frame.dtype == torch.float32
    np.testing.assert_array_equal(frame.numpy(), np.asarray(jframe))
    for f in DB_FIELDS:
        got, want = getattr(db, f).numpy(), np.asarray(getattr(jdb, f))
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert db.has_world is jdb.has_world is True
    assert db.world_frame == jdb.world_frame
    np.testing.assert_array_equal(camera.K.numpy(), np.asarray(jcam.K))
    np.testing.assert_array_equal(camera.dist.numpy(), np.asarray(jcam.dist))
    cfg, jcfg = fn.keywords["config"], jfn.keywords["config"]
    for part in ("akaze", "match", "ransac", "pnp"):
        assert (dataclasses.asdict(getattr(cfg, part)).items()
                <= dataclasses.asdict(getattr(jcfg, part)).items()), part
    assert fn.func is localize_frame_jit
    assert fn.keywords["solve_pose"] is jfn.keywords["solve_pose"] is True


def test_entry_step_is_localize_frame_jit(port_entry):
    """The hook's step on its arguments equals the port's
    localize_frame_jit called with them, every output tensor."""
    fn, args = port_entry
    got = fn(*args)
    want = localize_frame_jit(*args, fn.keywords["config"], True)
    lg, lw = leaves(got), leaves(want)
    assert len(lg) == len(lw) > 10
    assert all(torch.equal(a, b) for a, b in zip(lg, lw))
    assert int(got.num_keypoints) == fn.keywords["config"].akaze.capacity


def test_entry_step_matches_jax(hooks, port_entry):
    """The JAX hook's step (its default detect_topk="approx", exact top-K
    on the CPU) and the port's on the same arguments: keypoint and match
    counts and the ok flags equal. The frame is uniform noise, whose
    responses and orientation windows are full of near-ties, so the
    keypoints are compared as sets, as tests/test_torch_features.py
    does: at least 99% of the port's keypoints have a JAX keypoint on the
    same level within 1e-3 px (measured 99.6%: the top-K boundary), and
    their angles agree within 1e-4 rad on at least 99% (measured 99.7%).
    The result carries no descriptors; each keypoint's distance to its
    nearest DB row does, and a difference of d in it needs at least d
    differing descriptor bits: on the shared keypoints with agreeing
    angles the summed differences stay within 0.1% of their descriptor
    bits, the ≥ 99.9% equal bits tests/test_torch_ladder.py holds
    (measured 0.004%). H within 1e-3 where ok."""
    jfn, jargs = hooks.entry()
    ref = jfn(*jargs)
    fn, args = port_entry
    got = fn(*args)
    assert int(got.num_keypoints) == int(ref.num_keypoints) > 500
    assert int(got.num_matches) == int(ref.num_matches)
    assert bool(got.homography.ok) == bool(ref.homography.ok)
    assert bool(got.pose.ok) == bool(ref.pose.ok)
    kp, jkp = got.keypoints, ref.keypoints
    tv, jv = kp.valid.numpy(), np.asarray(jkp.valid)
    d = np.abs(kp.xy.numpy()[tv][:, None, :]
               - np.asarray(jkp.xy)[jv][None, :, :]).max(-1)
    d[kp.class_id.numpy()[tv][:, None]
      != np.asarray(jkp.class_id)[jv][None, :]] = np.inf
    j = d.argmin(1)
    shared = d[np.arange(len(j)), j] <= 1e-3
    da = np.abs(kp.angle.numpy()[tv] - np.asarray(jkp.angle)[jv][j])
    close = shared & (np.minimum(da, 2 * np.pi - da) <= 1e-4)
    dd = np.abs(got.matches.distance.numpy()[tv]
                - np.asarray(ref.matches.distance)[jv][j])[close]
    bits = 486 * int(close.sum())
    print(f"keypoints shared {shared.mean():.4%}, angles within 1e-4 "
          f"{close.sum() / shared.sum():.4%}, nearest-row distance "
          f"differences {dd.sum():.0f} of {bits} descriptor bits")
    assert shared.mean() >= 0.99
    assert close.sum() >= 0.99 * shared.sum()
    assert dd.sum() <= 0.001 * bits
    if bool(ref.homography.ok):
        np.testing.assert_allclose(got.homography.H.numpy(),
                                   np.asarray(ref.homography.H), atol=1e-3)


def _jax_dryrun_inputs(hooks, n, monkeypatch):
    """What the JAX hook's dry run hands its mesh step, sharded kNN-2 and
    tile extraction at n devices, recorded by stand-ins for them (the
    rest of the dry run, its draws and placements, runs as it is)."""
    from cubesat_apds_tpu.ops import match as jmatch
    from cubesat_apds_tpu.ops.features import akaze as jakaze
    from cubesat_apds_tpu.parallel import serve as jserve
    from cubesat_apds_tpu.parallel import sharded_match as jsm

    seen = {}

    def make_batch_localizer(mesh, camera, config, solve_pose=None):
        seen.update(mesh=dict(mesh.shape), camera=camera, config=config)

        def step(frames, db):
            seen.update(frames=np.asarray(frames), db=db)
            b = frames.shape[0]
            return (types.SimpleNamespace(H=np.zeros((b, 3, 3))),
                    types.SimpleNamespace(rvec=np.zeros((b, 3))), None, None)
        return step

    def make_sharded_knn2(mesh):
        def fn(q, db, valid):
            seen.update(q_desc=np.asarray(q), knn_db=np.asarray(db))
            return np.zeros(len(q)), np.zeros(len(q)), np.zeros(len(q), int)
        return fn

    def detect_and_compute_batch(tiles, config):
        seen["tiles"] = np.asarray(tiles)
        return types.SimpleNamespace(descriptors=None, keypoints=(
            types.SimpleNamespace(valid=np.zeros((len(tiles), 1)))))

    monkeypatch.setattr(jserve, "make_batch_localizer", make_batch_localizer)
    monkeypatch.setattr(jserve, "shard_device_db", lambda mesh, db: db)
    monkeypatch.setattr(jsm, "make_sharded_knn2", make_sharded_knn2)
    monkeypatch.setattr(jmatch, "unpack_bits", lambda x: x)
    monkeypatch.setattr(jakaze, "detect_and_compute_batch",
                        detect_and_compute_batch)
    assert jax.local_device_count() >= n
    hooks.dryrun_multichip(n)
    return seen


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_matches_jax_and_single_device(hooks, n, monkeypatch):
    """The port's dry run on n CPU slots: the JAX hook's mesh shape,
    configuration and draws (frames, DB, queries, tiles), its assertions
    (finite H, a [B, 3] pose, match indices inside the DB, one feature
    row a tile), each dp row of the serve step bit-equal to the port's
    single-device batch step on the row's frames, the sharded kNN-2 to
    the dense kNN-2 over the whole DB, and the tile batch's features to
    detect_and_compute_batch on one device."""
    want = _jax_dryrun_inputs(hooks, n, monkeypatch)
    out = graft_entry._dryrun(n, device="cpu")
    mesh, cfg, db = out["mesh"], out["config"], out["db"]
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    assert mesh.shape == want["mesh"] == {"dp": 2, "tp": n // 2}
    for part in ("akaze", "match", "ransac", "pnp"):
        assert (dataclasses.asdict(getattr(cfg, part)).items()
                <= dataclasses.asdict(getattr(want["config"], part))
                .items()), part
    np.testing.assert_array_equal(out["frames"].numpy(), want["frames"])
    for f in DB_FIELDS:
        np.testing.assert_array_equal(getattr(db, f).numpy(),
                                      np.asarray(getattr(want["db"], f)),
                                      err_msg=f)
    assert db.has_world is want["db"].has_world is True
    np.testing.assert_array_equal(out["q_desc"].numpy(), want["q_desc"])
    np.testing.assert_array_equal(db.descriptors.numpy(), want["knn_db"])
    np.testing.assert_array_equal(out["tiles"].numpy(), want["tiles"])
    np.testing.assert_array_equal(out["camera"].K.numpy(),
                                  np.asarray(want["camera"].K))

    homog, pose, n_match, n_kp = out["serve"]
    B, M = 2 * dp, 128 * tp
    assert np.isfinite(homog.H.numpy()).all()
    assert pose is not None and tuple(pose.rvec.shape) == (B, 3)
    assert int(out["knn"][2].max()) < M
    assert out["tile_features"]["valid"].shape[0] == dp * 2

    got = _pack_outputs(homog, n_match, n_kp, pose)
    lb = B // dp
    for i in range(dp):
        row = localize_from_features(detect_and_compute_batch(
            out["frames"][i * lb:(i + 1) * lb], cfg.akaze), db, out["camera"],
            cfg, True)
        assert torch.equal(got[i * lb:(i + 1) * lb], _pack_outputs(
            row.homography, row.num_matches, row.num_keypoints, row.pose)), i
    assert int(n_kp.min()) > 0
    dense = tmatch.knn2(tmatch.unpack_bits(out["q_desc"]),
                        tmatch.unpack_bits(db.descriptors), db_valid=db.valid)
    for a, b in zip(out["knn"], dense):
        assert torch.equal(a, b)
    feats = detect_and_compute_batch(out["tiles"], cfg.akaze)
    host = out["tile_features"]
    np.testing.assert_array_equal(host["desc"], feats.descriptors.numpy())
    for f in ("xy", "size", "angle", "response", "octave", "class_id",
              "valid"):
        np.testing.assert_array_equal(
            host[f], getattr(feats.keypoints, f).numpy(), err_msg=f)


def test_dryrun_multichip_prints_the_summary(capsys):
    """dryrun_multichip returns None and prints the JAX hook's line."""
    assert graft_entry.dryrun_multichip(4, device="cpu") is None
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == ("dryrun_multichip OK: mesh dp=2 tp=2, B=4 frames, "
                    "M=256 db descriptors, pose solved, 4-tile preprocess "
                    "batch extracted")


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a host without a GPU")
def test_hooks_refuse_without_a_card():
    """Without a GPU neither hook falls back to the CPU: both raise unless
    the caller names the CPU."""
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        graft_entry.dryrun_multichip(2)
