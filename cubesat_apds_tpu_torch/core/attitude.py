"""Attitude outputs from a PnP pose: quaternion, Euler angles, camera
position (a copy of the JAX package's core/attitude.py, which the port
does not import; only the Rodrigues step goes through the port's own).

The reference project is titled "satellite attitude determination
through image recognition" (reference: README.md:1-2) yet its pose type
stops at the raw OpenCV rvec/tvec (PNPRANSACSolution, homographier
mod.rs:46-51) — every consumer must do its own Rodrigues/quaternion
math. This module finishes the job: solve_pnp_ransac's (rvec, tvec) is
the world→camera transform x_cam = R·X_world + t, so

  * camera position in the WORLD frame  = −Rᵀ·t  (ECEF when the store
    carries elevation, the planar mosaic frame otherwise);
  * camera attitude                      = the camera→world rotation Rᵀ,
    reported as a unit quaternion (w, x, y, z), w ≥ 0, and ZYX
    (yaw→pitch→roll) Euler angles.

Host-side numpy (post-processing of fetched poses, not on the jit
path); trailing-batch friendly — every function accepts [..., 3] /
[..., 3, 3] stacks.
"""

from __future__ import annotations

import numpy as np


def rotation_to_quaternion(R: np.ndarray) -> np.ndarray:
    """[..., 3, 3] rotation matrix → unit quaternion [..., 4] (w,x,y,z),
    sign-normalized to w ≥ 0. Shepperd's method: build the candidate
    anchored at each of the four largest-magnitude components and pick
    per element, so no component ever divides by a near-zero pivot."""
    R = np.asarray(R, np.float64)
    m = lambda i, j: R[..., i, j]  # noqa: E731
    t = np.stack([
        1.0 + m(0, 0) + m(1, 1) + m(2, 2),      # 4w²
        1.0 + m(0, 0) - m(1, 1) - m(2, 2),      # 4x²
        1.0 - m(0, 0) + m(1, 1) - m(2, 2),      # 4y²
        1.0 - m(0, 0) - m(1, 1) + m(2, 2),      # 4z²
    ], axis=-1)
    pivot = np.sqrt(np.maximum(t, 1e-12)) / 2.0           # [..., 4]
    d = 4.0 * pivot
    cands = np.stack([
        np.stack([pivot[..., 0],
                  (m(2, 1) - m(1, 2)) / d[..., 0],
                  (m(0, 2) - m(2, 0)) / d[..., 0],
                  (m(1, 0) - m(0, 1)) / d[..., 0]], axis=-1),
        np.stack([(m(2, 1) - m(1, 2)) / d[..., 1],
                  pivot[..., 1],
                  (m(0, 1) + m(1, 0)) / d[..., 1],
                  (m(0, 2) + m(2, 0)) / d[..., 1]], axis=-1),
        np.stack([(m(0, 2) - m(2, 0)) / d[..., 2],
                  (m(0, 1) + m(1, 0)) / d[..., 2],
                  pivot[..., 2],
                  (m(1, 2) + m(2, 1)) / d[..., 2]], axis=-1),
        np.stack([(m(1, 0) - m(0, 1)) / d[..., 3],
                  (m(0, 2) + m(2, 0)) / d[..., 3],
                  (m(1, 2) + m(2, 1)) / d[..., 3],
                  pivot[..., 3]], axis=-1),
    ], axis=-2)                                           # [..., 4, 4]
    best = np.argmax(t, axis=-1)
    q = np.take_along_axis(cands, best[..., None, None].repeat(4, -1),
                           axis=-2)[..., 0, :]
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return np.where(q[..., :1] < 0, -q, q)


def quaternion_to_matrix(q: np.ndarray) -> np.ndarray:
    """Unit quaternion [..., 4] (w,x,y,z) → rotation matrix [..., 3, 3]."""
    q = np.asarray(q, np.float64)
    w, x, y, z = (q[..., i] for i in range(4))
    row = lambda *v: np.stack(v, axis=-1)  # noqa: E731
    return np.stack([
        row(1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
            2 * (x * z + w * y)),
        row(2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
            2 * (y * z - w * x)),
        row(2 * (x * z - w * y), 2 * (y * z + w * x),
            1 - 2 * (x * x + y * y)),
    ], axis=-2)


def matrix_to_euler_zyx(R: np.ndarray) -> np.ndarray:
    """[..., 3, 3] rotation → intrinsic ZYX (yaw, pitch, roll) radians.
    Gimbal-safe: at |pitch| = 90° roll is folded into yaw (roll = 0)."""
    R = np.asarray(R, np.float64)
    pitch = np.arcsin(np.clip(-R[..., 2, 0], -1.0, 1.0))
    near_gimbal = np.abs(R[..., 2, 0]) > 1.0 - 1e-9
    yaw = np.where(near_gimbal,
                   np.arctan2(-R[..., 0, 1], R[..., 1, 1]),
                   np.arctan2(R[..., 1, 0], R[..., 0, 0]))
    roll = np.where(near_gimbal, 0.0,
                    np.arctan2(R[..., 2, 1], R[..., 2, 2]))
    return np.stack([yaw, pitch, roll], axis=-1)


def pose_to_attitude(rvec, tvec) -> dict:
    """PnP (rvec, tvec) → {"position", "quat_wxyz", "euler_zyx_deg"}.

    position is the camera center in the WORLD frame (−Rᵀt); the
    quaternion/Euler angles describe the camera→world rotation Rᵀ.
    Accepts trailing batches: rvec/tvec [..., 3].
    """
    import torch

    from cubesat_apds_tpu_torch.ops.geometry.rodrigues import (
        rodrigues_to_matrix)

    rvec = np.asarray(rvec, np.float64)
    tvec = np.asarray(tvec, np.float64)
    R = rodrigues_to_matrix(torch.from_numpy(rvec.astype(np.float32))) \
        .numpy().astype(np.float64)
    Rt = np.swapaxes(R, -1, -2)
    position = -np.einsum("...ij,...j->...i", Rt, tvec)
    quat = rotation_to_quaternion(Rt)
    euler = np.degrees(matrix_to_euler_zyx(Rt))
    return {"position": position, "quat_wxyz": quat,
            "euler_zyx_deg": euler}
