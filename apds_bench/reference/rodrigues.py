"""Rodrigues rotation vector ↔ matrix (port of ops/geometry/rodrigues.py)."""

from __future__ import annotations

import torch

from apds_bench.reference.linalg_small import bmm


def rodrigues_to_matrix(rvec):
    """[..., 3] rotation vector → [..., 3, 3] rotation matrix."""
    if not rvec.is_floating_point():
        rvec = rvec.to(torch.float32)
    theta = torch.linalg.vector_norm(rvec, dim=-1, keepdim=True)
    small = theta < 1e-8
    axis = rvec / torch.where(small, 1.0, theta)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = torch.zeros_like(x)
    K = torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)
    t = theta[..., None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    R = eye + torch.sin(t) * K + (1.0 - torch.cos(t)) * bmm(K, K)
    return torch.where(small[..., None], eye, R)


def matrix_to_rodrigues(R):
    """[..., 3, 3] rotation matrix → [..., 3] rotation vector."""
    if not R.is_floating_point():
        R = R.to(torch.float32)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = ((trace - 1.0) * 0.5).clamp(-1.0, 1.0)
    theta = torch.arccos(cos_theta)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_theta = torch.sin(theta)
    generic = v * (theta / torch.where(sin_theta.abs() < 1e-8, 1.0,
                                       2.0 * sin_theta))[..., None]
    near_zero = v * 0.5
    # θ ≈ π: axis from the diagonal of (R + I)/2 = aaᵀ, signs from the
    # off-diagonals with the largest component taken positive.
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_sq = ((diag + 1.0) * 0.5).clamp(min=0.0)
    axis_pi = torch.sqrt(axis_sq)
    big = axis_sq.argmax(dim=-1)[..., None]
    s01 = torch.sign(R[..., 0, 1])
    s02 = torch.sign(R[..., 0, 2])
    s12 = torch.sign(R[..., 1, 2])
    one = torch.ones_like(s01)
    signs = torch.where(
        big == 0, torch.stack([one, s01, s02], dim=-1),
        torch.where(big == 1, torch.stack([s01, one, s12], dim=-1),
                    torch.stack([s02, s12, one], dim=-1)))
    near_pi = axis_pi * signs * theta[..., None]
    small_angle = (sin_theta.abs() < 1e-6)[..., None]
    is_pi = (cos_theta < 0)[..., None]
    return torch.where(small_angle, torch.where(is_pi, near_pi, near_zero),
                       generic)
