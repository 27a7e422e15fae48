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

from apds_bench.reference.types_ import CameraModel


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


