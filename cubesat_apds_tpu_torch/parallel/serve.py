"""Mesh-parallel batched serving: the online localization step (detect →
match → homography → PnP) over a (dp × tp) mesh (port of
parallel/serve.py).

  * frames split over "dp": each dp row runs `detect_and_compute_batch` on
    its own frames (the front half's and the capacity ladder's graphs,
    kernels A and B once per row on the card);
  * the descriptor DB shards over "tp": each slot of the row matches all
    of the row's queries against its shard — kernel 4, one launch per
    shard, when a shard holds more than `config.match.db_block` rows or
    `config.match.kernel == "fused"`, else a dense product — and the
    [tp, Q] partials merge into the global top-2 (the makers of
    parallel.sharded_match);
  * the geometry (RANSAC homography and PnP) of the row's frames runs as
    one batch on the row's first slot, through the same batch-first back
    half as a single-device batch step (`localize_from_matches`), so a
    row's outputs are the single-device batch step's bits on its frames.

On the card the row's work after feature extraction runs as CUDA
graphs, one a key in the mesh's cache (parallel.mesh.run_graph), the
port's counterpart of the JAX package's jit of this step. When one
process holds the whole row on one device (every single-process mesh on
one card), `_row_back_half` (partials, merge and geometry) is one graph,
so a warmed row is three graph launches (front half, ladder, back half)
and their copies and clones; rows of one shape on one device share the
graph and its static copy of the resident DB. Otherwise each device
group's partials and merge are a graph (parallel.sharded_match), the
merge across groups and processes stays eager, and `_row_geometry` is a
graph on the row's first slot. `_row_back_half` and `_row_geometry`
stay callable eagerly as the graphs' reference; on the CPU there are no
graphs.

Across processes a row is computed by the processes that hold its slots
(each extracts the row's features), every process takes part in each
row's all_reduce(MIN) merge, the row's first slot's process runs the
geometry, and the outputs are broadcast, so every process returns the
whole batch.
"""

from __future__ import annotations

import dataclasses

import torch

from cubesat_apds_tpu_torch.core.config import MatchConfig, PipelineConfig
from cubesat_apds_tpu_torch.core.types import (
    CameraModel, HomographyResult, PoseSolution, to_device)
from cubesat_apds_tpu_torch.ops import match as M
from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute_batch
from cubesat_apds_tpu_torch.parallel.mesh import (
    Mesh, Placed, broadcast_tensors, replicate, run_graph)
from cubesat_apds_tpu_torch.parallel.sharded_match import (
    ShardedKnn2, group_top2, make_sharded_knn2, make_sharded_knn2_fused)
from cubesat_apds_tpu_torch.pipelines.localize import (
    DeviceDb, localize_from_matches)


@dataclasses.dataclass(frozen=True, eq=False)
class MeshDb:
    """A DeviceDb placed on a mesh: descriptors and valid (rows padded to
    a tp multiple with valid=False) placed as `knn2`'s per-shard inputs,
    sharded over tp — kernel 4's layouts, made once here, when the match
    dispatch sends the serve step through it (`fused`), else unpacked
    bits — and xy and obj_points replicated (the winner's coordinates
    after the merge)."""

    mesh: Mesh
    knn2: ShardedKnn2
    shards: Placed
    xy: Placed
    obj_points: Placed
    fused: bool
    has_world: bool = False
    world_frame: str = "local"

    @property
    def rows(self) -> int:
        return self.shards.shape[0]

    @property
    def shard_rows(self) -> int:
        return self.rows // self.mesh.shape["tp"]


def _use_kernel(match: MatchConfig, shard_rows: int) -> bool:
    """JAX's dispatch: kernel 4 per shard when a shard outgrows db_block
    (or when forced); "scan" keeps the dense product."""
    return match.kernel == "fused" or (match.kernel == "auto"
                                       and shard_rows > match.db_block)


def shard_device_db(mesh: Mesh, db: DeviceDb, pad_to_multiple: bool = True,
                    match_config: MatchConfig = MatchConfig()) -> MeshDb:
    """Place a DeviceDb on the mesh (see MeshDb) for the match route that
    `match_config` gives its shards."""
    tp = mesh.shape["tp"]
    m = db.descriptors.shape[0]
    pad = (-m) % tp if pad_to_multiple else 0
    desc, valid, xy, obj = db.descriptors, db.valid, db.xy, db.obj_points
    if pad:
        desc = torch.cat([desc, desc.new_zeros((pad,) + desc.shape[1:])])
        valid = torch.cat([valid, valid.new_zeros(pad)])
        xy = torch.cat([xy, xy.new_zeros((pad, 2))])
        obj = torch.cat([obj, obj.new_zeros((pad, 3))])
    fused = _use_kernel(match_config, (m + pad) // tp)
    if fused:
        knn2 = make_sharded_knn2_fused(mesh, db_block=match_config.db_block)
        shards = knn2.place(desc, valid)
    else:
        knn2 = make_sharded_knn2(mesh)
        shards = knn2.place(M.unpack_bits(desc), valid)
    xy_p, obj_p = replicate(mesh, (xy, obj))
    return MeshDb(mesh=mesh, knn2=knn2, shards=shards, xy=xy_p,
                  obj_points=obj_p, fused=fused, has_world=db.has_world,
                  world_frame=db.world_frame)


def _flat(homog, pose, n_match, n_kp):
    t = [homog.H, homog.inliers, homog.num_inliers, homog.ok]
    if pose is not None:
        t += [pose.rvec, pose.tvec, pose.inliers, pose.num_inliers, pose.ok]
    return t + [n_match, n_kp]


def _unflat(t, want_pose: bool):
    homog = HomographyResult(*t[:4])
    pose = PoseSolution(*t[4:9]) if want_pose else None
    return homog, pose, t[-2], t[-1]


def make_batch_localizer(mesh: Mesh, camera: CameraModel,
                         config: PipelineConfig = PipelineConfig(),
                         solve_pose=None):
    """The mesh-parallel batch step: step(frames, db) → (homography, pose
    or None, num_matches [B], num_keypoints [B]), every leaf leading with
    B, on this process's first slot. frames [B, H, W] (B divisible by dp;
    float32 in [0, 1]); db from shard_device_db(mesh, ...). `pose` is
    solved where the DB has world points unless `solve_pose` says
    otherwise."""
    dp = mesh.shape["dp"]
    cameras = {}                  # device → the camera on it, made once

    def step(frames, db: MeshDb):
        frames = torch.as_tensor(frames, dtype=torch.float32)
        b = frames.shape[0]
        if b % dp:
            raise ValueError(f"batch {b} does not divide over dp={dp}")
        if db.fused != _use_kernel(config.match, db.shard_rows):
            raise ValueError("the mesh DB was placed for another match "
                             "route: place it with this config's match")
        lb = b // dp
        want_pose = db.has_world if solve_pose is None else solve_pose
        rows = []
        for i in range(dp):
            groups = mesh.row_groups(i)
            out = None
            if groups:
                dev = groups[0][0]
                feats = detect_and_compute_batch(
                    frames[i * lb:(i + 1) * lb].to(dev), config.akaze)
                if dev not in cameras:
                    cameras[dev] = to_device(camera, dev)
                if mesh.row_device(i) is not None:
                    out = run_graph(_row_back_half, *_row_args(
                        db, i, feats, cameras[dev], config, want_pose))
                else:
                    top2 = db.knn2(M.unpack_bits(
                        feats.descriptors.flatten(0, 1)), db.shards, row=i)
                    if mesh.is_local(i, 0):
                        out = run_graph(
                            _row_geometry, feats.keypoints, top2,
                            db.xy.parts[(i, 0)], db.obj_points.parts[(i, 0)],
                            cameras[dev], config, want_pose, db.world_frame)
            elif mesh.multiprocess:      # take part in the row's merge
                q = lb * config.akaze.capacity
                db.knn2(torch.zeros((q, M.DESC_BITS_PADDED), dtype=torch.int8,
                                    device=mesh.home), db.shards, row=i)
            rows.append(out)
        if mesh.multiprocess:
            n_out = 6 + 5 * bool(want_pose)
            rows = [broadcast_tensors(rows[i], int(mesh.ranks[i, 0]), n_out,
                                      mesh.home) for i in range(dp)]
        home = mesh.home
        cat = [torch.cat([r[k].to(home) for r in rows])
               for k in range(len(rows[0]))]
        return _unflat(cat, want_pose)

    return step


def _row_args(db: MeshDb, i: int, feats, camera: CameraModel,
              config: PipelineConfig, want_pose: bool) -> tuple:
    """`_row_back_half`'s arguments for dp row i of `db`, whose slots are
    all on the device of `feats` and `camera`. Rows on one device pass
    the same shard, xy and world-point tensors."""
    tp = db.mesh.shape["tp"]
    return (feats, db.knn2.group_args(db.shards, i, range(tp)),
            db.xy.parts[(i, 0)], db.obj_points.parts[(i, 0)], camera,
            config, want_pose, db.world_frame)


def _row_back_half(feats, match: tuple, xy, obj, camera: CameraModel,
                   config: PipelineConfig, want_pose: bool,
                   world_frame: str) -> tuple:
    """A dp row's work after feature extraction, on one device: its lb
    frames' queries against every shard (`match`: `group_top2`'s
    arguments after the queries), the merge, then `_row_geometry` →
    the step's outputs of those frames, flattened (a tuple, see
    _flat)."""
    top2 = group_top2(M.unpack_bits(feats.descriptors.flatten(0, 1)), *match)
    return _row_geometry(feats.keypoints, top2, xy, obj, camera, config,
                         want_pose, world_frame)


def _row_geometry(kp, top2, xy, obj, camera: CameraModel,
                  config: PipelineConfig, want_pose: bool,
                  world_frame: str) -> tuple:
    """A dp row's geometry from its merged top-2 [lb · cap], its lb frames
    as one batch → the step's outputs of those frames, flattened."""
    lb, cap = kp.valid.shape
    d0, d1, i0 = (t.reshape(lb, cap) for t in top2)
    d0 = torch.where(kp.valid, d0, M.INVALID_DIST)
    matches = M._ratio_matches(d0, d1, i0, config.match.ratio)
    r = localize_from_matches(kp, matches, xy, obj, world_frame, camera,
                              config, want_pose)
    return tuple(_flat(r.homography, r.pose, r.num_matches,
                       r.num_keypoints))
