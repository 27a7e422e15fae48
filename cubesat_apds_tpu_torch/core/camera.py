"""Camera model math: projection, Brown–Conrady distortion and
undistortion (port of core/camera.py).

The reference keeps intrinsics as raw OpenCV Mats and lets calib3d handle
projection (calibrator/src/main.rs:65-80; homographier mod.rs:320-369).
Here projection and distortion are explicit tensor functions, shared by
PnP scoring, calibration and the undistortion of frames. Rotations are
applied by elementwise multiply-adds, so no matmul precision mode (TF32
on the card) enters.
"""

from __future__ import annotations

import torch

from cubesat_apds_tpu_torch.core.types import CameraModel


def distort_normalized(xy, dist):
    """Apply Brown–Conrady distortion (k1,k2,p1,p2,k3) to normalized
    coords xy [..., 2]."""
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    x_t = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    y_t = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([x * radial + x_t, y * radial + y_t], dim=-1)


def undistort_normalized(xy, dist, iters: int = 8):
    """Invert distortion by fixed-point iteration (undistortPoints style)."""
    pts = xy
    for _ in range(iters):
        pts = xy - (distort_normalized(pts, dist) - pts)
    return pts


def project_points(obj_points, rvec, tvec, K, dist=None):
    """World points → pixel coordinates (OpenCV projectPoints semantics).

    obj_points: [..., N, 3]; rvec/tvec: [..., 3]; K: [3, 3]; dist: [5] or
    None. Returns pixels [..., N, 2] and camera-frame depth z [..., N].
    """
    from cubesat_apds_tpu_torch.ops.geometry.rodrigues import (
        rodrigues_to_matrix)

    R = rodrigues_to_matrix(rvec)                           # [..., 3, 3]
    ox, oy, oz = (obj_points[..., i] for i in range(3))     # [..., N]
    cam = [R[..., i, 0, None] * ox + R[..., i, 1, None] * oy
           + R[..., i, 2, None] * oz + tvec[..., i, None] for i in range(3)]
    z = cam[2]
    safe_z = torch.where(z.abs() < 1e-12, 1e-12, z)
    xy_n = torch.stack([cam[0] / safe_z, cam[1] / safe_z], dim=-1)
    if dist is not None:
        xy_n = distort_normalized(xy_n, dist)
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    skew = K[..., 0, 1]
    u = fx[..., None] * xy_n[..., 0] + skew[..., None] * xy_n[..., 1] \
        + cx[..., None]
    v = fy[..., None] * xy_n[..., 1] + cy[..., None]
    return torch.stack([u, v], dim=-1), z


def pixels_to_normalized(pix, camera: CameraModel, undistort: bool = True):
    """Pixel coords → normalized coords, removing distortion."""
    K = camera.K
    fx, fy = K[0, 0], K[1, 1]
    cx, cy, skew = K[0, 2], K[1, 2], K[0, 1]
    y = (pix[..., 1] - cy) / fy
    x = (pix[..., 0] - cx - skew * y) / fx
    xy = torch.stack([x, y], dim=-1)
    if undistort:
        xy = undistort_normalized(xy, camera.dist)
    return xy


def undistort_image_grid(shape_hw, camera: CameraModel, device=None):
    """The sampling grid that undistorts a full image, on `device` (the
    camera's unless named).

    Returns [H, W, 2] source pixel coordinates: for each output pixel,
    where to sample in the distorted input (use with
    ops.warp.bilinear_sample).
    """
    dev = camera.K.device if device is None else torch.device(device)
    K = camera.K.to(dev)
    h, w = shape_hw
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    fx, fy = K[0, 0], K[1, 1]
    cx, cy, skew = K[0, 2], K[1, 2], K[0, 1]
    yn = (gy - cy) / fy
    xn = (gx - cx - skew * yn) / fx
    xyd = distort_normalized(torch.stack([xn, yn], dim=-1),
                             camera.dist.to(dev))
    u = fx * xyd[..., 0] + skew * xyd[..., 1] + cx
    v = fy * xyd[..., 1] + cy
    return torch.stack([u, v], dim=-1)
