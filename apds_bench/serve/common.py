"""What both serving paths share: the reference's results as the stream
yields them (one dict a frame, the fields of `StreamResult`, each cast
to float32 as the stream packs them)."""

from __future__ import annotations

import numpy as np
import torch


def _f32(x) -> np.ndarray:
    return torch.as_tensor(x).to(torch.float32).cpu().numpy()


def rows(result, solve_pose: bool) -> list:
    """A reference LocalizationResult of a batch → one dict a frame."""
    h = result.homography
    cols = {"homography": _f32(h.H).reshape(-1, 3, 3),
            "homography_ok": _f32(h.ok).reshape(-1) > 0,
            "num_inliers": _f32(h.num_inliers).reshape(-1).astype(np.int64),
            "num_matches": _f32(result.num_matches).reshape(-1)
            .astype(np.int64),
            "num_keypoints": _f32(result.num_keypoints).reshape(-1)
            .astype(np.int64)}
    if solve_pose:
        p = result.pose
        cols.update(rvec=_f32(p.rvec).reshape(-1, 3),
                    tvec=_f32(p.tvec).reshape(-1, 3),
                    pose_ok=_f32(p.ok).reshape(-1) > 0,
                    pose_num_inliers=_f32(p.num_inliers).reshape(-1)
                    .astype(np.int64))
    n = len(cols["homography"])
    return [{k: v[i] for k, v in cols.items()} for i in range(n)]


def reference_camera(config: dict, device):
    from apds_bench.inputs import camera_args
    from apds_bench.reference.types_ import CameraModel
    return CameraModel.ideal(*camera_args(config), device=device)


def reference_full_db(raw, device):
    from apds_bench.reference.localize import DeviceDb
    return DeviceDb(descriptors=raw.descriptors.to(device),
                    xy=raw.xy.to(device), valid=raw.valid.to(device),
                    obj_points=raw.obj.to(device), has_world=True,
                    world_frame="local")


def program_full_db(raw):
    from cubesat_apds_tpu_torch.pipelines.localize import DeviceDb
    return DeviceDb(descriptors=raw.descriptors, xy=raw.xy, valid=raw.valid,
                    obj_points=raw.obj, has_world=True, world_frame="local")
