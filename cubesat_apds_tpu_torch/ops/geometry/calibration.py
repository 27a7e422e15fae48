"""Camera calibration: Zhang's method + Levenberg–Marquardt refinement
(port of ops/geometry/calibration.py).

Replaces OpenCV calibrateCamera as used by the calibrator binary
(reference: calibrator/src/main.rs:65-80 — planar checkerboard views → K
matrix, distortion, RMS reprojection error):
  1. per-view homography from the z=0 object grid (weighted DLT),
  2. closed-form intrinsics from the B = K⁻ᵀK⁻¹ constraints (Zhang),
  3. per-view extrinsics from H and K,
  4. joint LM over {fx, fy, cx, cy, skew, k1, k2, p1, p2, k3, per-view
     rvec/tvec} minimizing pixel reprojection, a fixed number of steps.

Float32 throughout, on the device of the image points. The views are a
batch dimension; the LM loop reads nothing back to the host (its damping
stays a device tensor, the solve does no error check), so on the card it
only queues work. Views whose corner detection failed are masked out
with `view_valid` (the reference passes them through unfiltered —
calibrator/src/main.rs:42-55, a quirk SURVEY.md lists as fixed).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import jacfwd

from cubesat_apds_tpu_torch.core.camera import distort_normalized
from cubesat_apds_tpu_torch.core.config import CalibConfig
from cubesat_apds_tpu_torch.core.types import CameraModel
from cubesat_apds_tpu_torch.ops.geometry.homography import dlt_homography
from cubesat_apds_tpu_torch.ops.geometry.linalg_small import (
    det3x3, highest_matmul_precision)
from cubesat_apds_tpu_torch.ops.geometry.rodrigues import (
    matrix_to_rodrigues, rodrigues_to_matrix)


@dataclasses.dataclass
class CalibrationResult:
    camera: CameraModel
    rvecs: torch.Tensor     # [V, 3]
    tvecs: torch.Tensor     # [V, 3]
    rms: torch.Tensor       # scalar — RMS reprojection error in pixels
    ok: torch.Tensor


def _vij(H, i, j):
    """Zhang's v_ij constraint vector [..., 6] from homography columns."""
    h = H
    return torch.stack([
        h[..., 0, i] * h[..., 0, j],
        h[..., 0, i] * h[..., 1, j] + h[..., 1, i] * h[..., 0, j],
        h[..., 1, i] * h[..., 1, j],
        h[..., 2, i] * h[..., 0, j] + h[..., 0, i] * h[..., 2, j],
        h[..., 2, i] * h[..., 1, j] + h[..., 1, i] * h[..., 2, j],
        h[..., 2, i] * h[..., 2, j],
    ], dim=-1)


def _intrinsics_from_homographies(Hs, view_valid):
    """Closed-form K from ≥ 3 view homographies [V, 3, 3] (Zhang §3.1)."""
    V = torch.stack([_vij(Hs, 0, 1), _vij(Hs, 0, 0) - _vij(Hs, 1, 1)],
                    dim=-2)                                  # [V, 2, 6]
    V = (V * view_valid.to(V.dtype)[:, None, None]).reshape(-1, 6)
    _, vecs = torch.linalg.eigh(V.T @ V)
    B11, B12, B22, B13, B23, B33 = vecs[:, 0]
    v0 = (B12 * B13 - B11 * B23) / (B11 * B22 - B12 * B12)
    lam = B33 - (B13 * B13 + v0 * (B12 * B13 - B11 * B23)) / B11
    alpha = torch.sqrt((lam / B11).abs())
    beta = torch.sqrt((lam * B11 / (B11 * B22 - B12 * B12)).abs())
    gamma = -B12 * alpha * alpha * beta / lam
    u0 = gamma * v0 / beta - B13 * alpha * alpha / lam
    zero, one = torch.zeros_like(alpha), torch.ones_like(alpha)
    return torch.stack([torch.stack([alpha, gamma, u0]),
                        torch.stack([zero, beta, v0]),
                        torch.stack([zero, zero, one])])


def _extrinsics_from_homography(H, K):
    """Per view of H [..., 3, 3]: r1 = λK⁻¹h1, r2 = λK⁻¹h2, r3 = r1×r2,
    t = λK⁻¹h3, then the nearest rotation; returns (rvec, tvec)."""
    Kinv = torch.linalg.inv_ex(K)[0]
    kh = Kinv @ H                                   # columns K⁻¹h1..h3
    h1, h2, h3 = kh[..., :, 0], kh[..., :, 1], kh[..., :, 2]
    lam = 1.0 / torch.linalg.vector_norm(h1, dim=-1, keepdim=True) \
        .clamp(min=1e-12)
    r1 = lam * h1
    r2 = lam * h2
    r3 = torch.linalg.cross(r1, r2, dim=-1)
    Q = torch.stack([r1, r2, r3], dim=-1)
    U, _, Vt = torch.linalg.svd(Q)                  # nearest rotation
    R = U @ Vt
    R = R * torch.sign(det3x3(R))[..., None, None]
    t = lam * h3
    # Keep the board in front of the camera.
    flip = torch.sign(t[..., 2])
    t = t * flip[..., None]
    R = torch.where((flip < 0)[..., None, None],
                    R * R.new_tensor([-1.0, -1.0, 1.0]), R)
    return matrix_to_rodrigues(R), t


def _project(params, obj_xy, n_views):
    """Reproject the planar grid under packed params → [V, N, 2] pixels."""
    fx, fy, cx, cy, skew = params[0:5]
    dist = params[5:10]
    ext = params[10:].reshape(n_views, 6)
    R = rodrigues_to_matrix(ext[:, :3])                       # [V, 3, 3]
    ox, oy = obj_xy[:, 0], obj_xy[:, 1]                       # z = 0
    cam = [R[:, i, 0, None] * ox + R[:, i, 1, None] * oy + ext[:, 3 + i, None]
           for i in range(3)]                                 # [V, N] each
    z = torch.where(cam[2].abs() < 1e-9, 1e-9, cam[2])
    xy = distort_normalized(torch.stack([cam[0] / z, cam[1] / z], -1), dist)
    u = fx * xy[..., 0] + skew * xy[..., 1] + cx
    v = fy * xy[..., 1] + cy
    return torch.stack([u, v], -1)


def _residuals(params, obj_xy, img_points, w_flat):
    """Weighted reprojection residuals [V·N·2] of the packed params."""
    r = (_project(params, obj_xy, img_points.shape[0])
         - img_points).reshape(-1, 2)
    return (r * w_flat[:, None]).reshape(-1)


def _levenberg_marquardt(params, obj_xy, img_points, w_flat, iters: int,
                         lambda0: float):
    """`iters` LM steps on the packed params, each step kept only if it
    lowers the squared residual (the damping then halves, else it grows
    4×). Reads nothing back to the host: the damping stays a device
    tensor and the solve does no error check."""
    def residuals(p):
        return _residuals(p, obj_xy, img_points, w_flat)

    eye = torch.eye(params.shape[0], dtype=params.dtype, device=params.device)
    lam = torch.full((), lambda0, dtype=params.dtype, device=params.device)
    for _ in range(iters):
        r = residuals(params)
        J = jacfwd(residuals)(params)
        JtJ = J.T @ J
        A = JtJ + lam * torch.diag_embed(torch.diagonal(JtJ)) + 1e-9 * eye
        delta = torch.linalg.solve_ex(A, J.T @ r)[0]
        p_new = params - delta
        r_new = residuals(p_new)
        improved = ((r_new * r_new).sum() < (r * r).sum()) \
            & torch.isfinite(p_new).all()
        params = torch.where(improved, p_new, params)
        lam = torch.where(improved, lam * 0.5, lam * 4.0)
    return params


@highest_matmul_precision
def calibrate_camera(obj_xy, img_points, point_valid=None, view_valid=None,
                     config: CalibConfig = CalibConfig()) -> CalibrationResult:
    """obj_xy: [N, 2] planar grid (the z=0 pattern, helpers.rs:38-46);
    img_points: [V, N, 2] detected corners per view, on the device the
    solve runs on.

    Returns intrinsics + distortion + per-view extrinsics + RMS px error.
    """
    img_points = torch.as_tensor(img_points, dtype=torch.float32)
    dev = img_points.device
    obj_xy = torch.as_tensor(obj_xy, dtype=torch.float32).to(dev)
    n_views, n_pts = img_points.shape[0], img_points.shape[1]
    if point_valid is None:
        point_valid = torch.ones((n_views, n_pts), dtype=torch.bool,
                                 device=dev)
    if view_valid is None:
        view_valid = torch.ones(n_views, dtype=torch.bool, device=dev)
    point_valid = torch.as_tensor(point_valid).to(dev)
    view_valid = torch.as_tensor(view_valid).to(dev)
    pv = point_valid & view_valid[:, None]

    # 1. Per-view homographies (the weighted DLT handles masked corners).
    Hs = dlt_homography(obj_xy.expand(n_views, n_pts, 2), img_points,
                        pv.to(torch.float32))
    # 2. Closed-form intrinsics; 3. extrinsics.
    K0 = _intrinsics_from_homographies(Hs, view_valid)
    rvecs0, tvecs0 = _extrinsics_from_homography(Hs, K0)

    # 4. Joint LM refinement.
    params = torch.cat([
        torch.stack([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2], K0[0, 1]]),
        torch.zeros(5, dtype=torch.float32, device=dev),
        torch.cat([rvecs0, tvecs0], -1).reshape(-1),
    ]).to(torch.float32)
    w_flat = pv.to(torch.float32).reshape(-1)
    params = _levenberg_marquardt(params, obj_xy, img_points, w_flat,
                                  config.lm_iters, config.lm_lambda0)

    fx, fy, cx, cy, skew = params[0:5]
    dist = params[5:10]
    ext = params[10:].reshape(n_views, 6)
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    K = torch.stack([torch.stack([fx, skew, cx]), torch.stack([zero, fy, cy]),
                     torch.stack([zero, zero, one])])
    r = _residuals(params, obj_xy, img_points, w_flat).reshape(-1, 2)
    rms = torch.sqrt((r * r).sum() / w_flat.sum().clamp(min=1.0))
    ok = torch.isfinite(rms) & (view_valid.sum() >= 3)
    return CalibrationResult(camera=CameraModel(K=K, dist=dist),
                             rvecs=ext[:, :3], tvecs=ext[:, 3:], rms=rms,
                             ok=ok)


def planar_grid(nx: int, ny: int, square: float = 1.0, device=None):
    """The z=0 object grid (img_points_from_size, calibrator
    helpers.rs:38-46): row-major (x fastest) corner coordinates [nx·ny, 2]
    float32, a constant made on `device` (the CPU unless named, like
    CameraModel.ideal)."""
    ys, xs = torch.meshgrid(torch.arange(ny, device=device),
                            torch.arange(nx, device=device), indexing="ij")
    return (torch.stack([xs, ys], -1).reshape(-1, 2) * square) \
        .to(torch.float32)
