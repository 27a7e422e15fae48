"""Driver hooks: the single-card step with example arguments, and one
step over a dp × tp mesh on tiny shapes (port of __graft_entry__.py).

    entry(device=None)               → (the localization step,
                                        (frame, db, camera))
    dryrun_multichip(n, device=None) → the mesh-parallel serving step, the
                                       sharded kNN-2 and a dp-split
                                       preprocess tile batch on an
                                       n-slot mesh, once each

Both hooks run on the card unless the caller names another device (the
tests pass "cpu"); without a card they raise. The names, configurations
and numpy draws are the JAX package's. Its dry run forces a virtual CPU
mesh, because its TPU plugin cannot form an n-device mesh; the port
fills n slots of one device instead, as its mesh CLI does
(`--device cuda:0,cuda:0,...`).

    python -m cubesat_apds_tpu_torch.graft_entry    # on the card
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cubesat_apds_tpu_torch.core.config import (
    AkazeConfig, MatchConfig, PipelineConfig, PnPConfig, RansacConfig)
from cubesat_apds_tpu_torch.core.types import CameraModel
from cubesat_apds_tpu_torch.pipelines.localize import (
    DeviceDb, localize_frame_jit)


def _device(device) -> torch.device:
    """`device`, the card when None; a card asked for without one is an
    error, never a quiet fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the driver hooks run on an NVIDIA GPU and "
                               "none is visible; pass device='cpu' to run "
                               "them on the CPU")
        if dev.index is None:            # the mesh's slots name one card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"dryrun_multichip: {what}")


def _synthetic_db(m: int, seed: int = 0, device=None) -> DeviceDb:
    """An m-row DB of random descriptors at random points of a 512² frame,
    its world points on the z = 0 plane, on `device`."""
    dev = _device(device)
    rng = np.random.default_rng(seed)
    desc = rng.integers(0, 256, (m, 61), dtype=np.uint8)
    xy = rng.uniform(0, 512, (m, 2)).astype(np.float32)
    obj = np.concatenate([xy, np.zeros((m, 1), np.float32)], axis=1)
    return DeviceDb(
        descriptors=torch.from_numpy(desc).to(dev),
        xy=torch.from_numpy(xy).to(dev),
        valid=torch.ones(m, dtype=torch.bool, device=dev),
        obj_points=torch.from_numpy(obj).to(dev),
        has_world=True,
    )


def entry(device=None):
    """The flagship step, frame → detect → match → RANSAC homography + PnP
    pose, and its example arguments (a random 512² frame, a 10,240-row
    DB, an ideal camera) on `device`. On the card a warmed step replays
    three CUDA graphs: the front half, the capacity ladder and the back
    half."""
    dev = _device(device)
    config = PipelineConfig(
        akaze=AkazeConfig(capacity=1024),
        match=MatchConfig(ratio=0.75),
        ransac=RansacConfig(num_hypotheses=256),
        pnp=PnPConfig(num_hypotheses=64),
    )
    rng = np.random.default_rng(7)
    frame = torch.from_numpy(
        rng.uniform(0, 1, (512, 512)).astype(np.float32)).to(dev)
    db = _synthetic_db(10240, device=dev)
    camera = CameraModel.ideal(500.0, 500.0, 256.0, 256.0, device=dev)

    fn = functools.partial(localize_frame_jit, config=config,
                           solve_pose=True)
    return fn, (frame, db, camera)


def _dryrun(n_devices: int, device=None) -> dict:
    """dryrun_multichip's body; returns its inputs and outputs: `mesh`,
    `config`, `camera`, `db`, `frames`, `q_desc`, `tiles`, `serve`
    (homography, pose, num_matches, num_keypoints of the batch), `knn`
    (d0, d1, i0) and `tile_features` (the tile batch's host arrays)."""
    from cubesat_apds_tpu_torch.ops.match import unpack_bits
    from cubesat_apds_tpu_torch.parallel.mesh import make_mesh
    from cubesat_apds_tpu_torch.parallel.serve import (
        make_batch_localizer, shard_device_db)
    from cubesat_apds_tpu_torch.parallel.sharded_match import (
        make_sharded_knn2)
    from cubesat_apds_tpu_torch.pipelines.preprocess import (
        _mesh_host_arrays)

    dev = _device(device)
    dp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    tp = n_devices // dp
    mesh = make_mesh(dp=dp, tp=tp, devices=[dev] * n_devices)

    config = PipelineConfig(
        akaze=AkazeConfig(capacity=64),
        match=MatchConfig(ratio=0.8),
        ransac=RansacConfig(num_hypotheses=32),
        pnp=PnPConfig(num_hypotheses=8),
    )

    rng = np.random.default_rng(0)
    B, H, W, M = dp * 2, 64, 64, tp * 128
    frames = torch.from_numpy(
        rng.uniform(0, 1, (B, H, W)).astype(np.float32)).to(dev)
    xy = rng.uniform(0, W, (M, 2)).astype(np.float32)
    desc = rng.integers(0, 256, (M, 61), dtype=np.uint8)
    db = DeviceDb(
        descriptors=torch.from_numpy(desc).to(dev),
        xy=torch.from_numpy(xy).to(dev),
        valid=torch.ones(M, dtype=torch.bool, device=dev),
        obj_points=torch.from_numpy(np.concatenate(
            [xy, np.full((M, 1), 5.0, np.float32)], axis=1)).to(dev),
        has_world=True,
    )
    camera = CameraModel.ideal(float(W), float(W), W / 2.0, H / 2.0,
                               device=dev)

    # The mesh-parallel serving step: each dp row's frames through AKAZE,
    # the tp-sharded match, then the row's RANSAC homography + PnP pose.
    db_sh = shard_device_db(mesh, db, match_config=config.match)
    step = make_batch_localizer(mesh, camera, config, solve_pose=True)
    homog, pose, n_matches, n_kp = step(frames, db_sh)
    _require(bool(torch.isfinite(homog.H).all()), "H is not finite")
    _require(pose is not None and tuple(pose.rvec.shape) == (B, 3),
             "no pose of shape [B, 3]")

    # The sharded kNN-2 on its own.
    q_desc = torch.from_numpy(
        rng.integers(0, 256, (32, 61), dtype=np.uint8)).to(dev)
    knn = make_sharded_knn2(mesh)(unpack_bits(q_desc),
                                  unpack_bits(db.descriptors), db.valid)
    _require(int(knn[2].max()) < M, "a match index past the DB")

    # A preprocess tile batch split over the dp rows, as
    # pipelines.preprocess extracts one under `mesh`.
    tiles = torch.from_numpy(
        rng.uniform(0, 1, (dp * 2, H, W)).astype(np.float32))
    tile_features = _mesh_host_arrays(mesh, list(tiles), config)
    _require(tile_features["valid"].shape[0] == dp * 2,
             "the tile batch lost a tile")
    return dict(mesh=mesh, config=config, camera=camera, db=db,
                frames=frames, q_desc=q_desc, tiles=tiles,
                serve=(homog, pose, n_matches, n_kp), knn=knn,
                tile_features=tile_features)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One full multi-slot pipeline step on an n_devices mesh (dp × tp)
    of `device`'s slots, tiny shapes: the batched serving step (frames
    over dp, the DB over tp), the sharded top-2 merge on its own, and a
    dp-split preprocess tile batch."""
    out = _dryrun(n_devices, device)
    mesh = out["mesh"]
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    print(f"dryrun_multichip OK: mesh dp={dp} tp={tp}, "
          f"B={out['frames'].shape[0]} frames, "
          f"M={out['db'].descriptors.shape[0]} db descriptors, pose solved, "
          f"{dp * 2}-tile preprocess batch extracted")


def main() -> int:
    dryrun_multichip(8)
    fn, args = entry()
    out = fn(*args)
    print("entry OK:", int(out.num_keypoints), "keypoints,",
          int(out.num_matches), "matches")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
