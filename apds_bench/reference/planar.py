"""Planar PnP: pose from (near-)coplanar points by homography
decomposition, and the scaled-orthographic (POS) pose and its two
candidates (port of ops/geometry/planar.py). All batch over leading
dimensions.
"""

from __future__ import annotations

import torch

from apds_bench.reference.homography import (
    dlt_homography_solve)
from apds_bench.reference.linalg_small import (
    bmm, eigh3x3, lstsq_normal)


def _weights(obj, weights):
    if weights is None:
        return torch.ones(obj.shape[:-1], dtype=obj.dtype, device=obj.device)
    return weights.to(obj.dtype)


def _plane_frame(obj, w):
    """Weighted centroid c [..., 3] and in-plane axes e1, e2 [..., 3]
    (the two largest principal directions)."""
    wsum = w.sum(-1).clamp(min=1e-12)
    c = (obj * w[..., None]).sum(-2) / wsum[..., None]
    centered = (obj - c[..., None, :]) * torch.sqrt(w)[..., None]
    cov = bmm(centered.transpose(-1, -2), centered) / wsum[..., None, None]
    _, eigvec = eigh3x3(cov)
    return c, eigvec[..., :, 2], eigvec[..., :, 1]


def _dot(a, b):
    return (a * b).sum(-1)


def _unit(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(
        min=1e-12)


def planar_pose(obj_points, img_points_normalized, weights=None):
    """Pose assuming (near-)coplanar obj points [..., n, 3] and normalized
    image points [..., n, 2]. Returns (R [..., 3, 3], t [..., 3], ok)."""
    obj = obj_points
    uv = img_points_normalized.to(obj.dtype)
    w = _weights(obj, weights)
    c, e1, e2 = _plane_frame(obj, w)
    rel = obj - c[..., None, :]
    p2 = torch.stack([_dot(rel, e1[..., None, :]), _dot(rel, e2[..., None, :])],
                     dim=-1)
    H = dlt_homography_solve(p2, uv, w)

    # Decompose H = λ·[r1 r2 t] (normalized camera, K = I).
    h1, h2, h3 = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    lam = 1.0 / torch.linalg.vector_norm(h1, dim=-1).clamp(min=1e-12)
    r1 = h1 * lam[..., None]
    r2raw = h2 * lam[..., None]
    r2 = _unit(r2raw - _dot(r1, r2raw)[..., None] * r1)
    r3 = torch.linalg.cross(r1, r2, dim=-1)
    Rp = torch.stack([r1, r2, r3], dim=-1)                 # plane → camera
    t = h3 * lam[..., None]
    # Cheirality: the plane origin must be in front of the camera.
    flip = torch.where(t[..., 2] < 0, -1.0, 1.0)
    t = t * flip[..., None]
    Rp = Rp * torch.stack([flip, flip, torch.ones_like(flip)],
                          dim=-1)[..., None, :]
    E = torch.stack([e1, e2, torch.linalg.cross(e1, e2, dim=-1)], dim=-1)
    R = bmm(Rp, E.transpose(-1, -2))
    t_full = t - bmm(R, c[..., None])[..., 0]
    ok = torch.isfinite(R).all(-1).all(-1) & torch.isfinite(t_full).all(-1)
    return R, t_full, ok


def ortho_pose_candidates(obj_points, img_points_normalized, weights=None):
    """Both scaled-orthographic (POS) pose candidates, fitted in the PCA
    plane basis: (R [..., 2, 3, 3], t [..., 2, 3], ok) with candidate 0
    the (c1, c2) branch and candidate 1 its mirror (−c1, −c2)."""
    obj = obj_points
    uv = img_points_normalized.to(obj.dtype)
    w = _weights(obj, weights)
    n = obj.shape[-2]
    c, e1, e2 = _plane_frame(obj, w)
    nrm = torch.linalg.cross(e1, e2, dim=-1)
    rel = obj - c[..., None, :]
    p2 = torch.stack([_dot(rel, e1[..., None, :]), _dot(rel, e2[..., None, :])],
                     dim=-1)
    X = torch.cat([p2, torch.ones(obj.shape[:-2] + (n, 1), dtype=obj.dtype,
                                  device=obj.device)], dim=-1)
    sw = torch.sqrt(w)[..., None]
    coef_u = lstsq_normal(X * sw, uv[..., 0] * sw[..., 0])
    coef_v = lstsq_normal(X * sw, uv[..., 1] * sw[..., 0])
    a1p = coef_u[..., :2]
    a2p = coef_v[..., :2]
    b = torch.stack([coef_u[..., 2], coef_v[..., 2]], dim=-1)

    # Rows r_i = (a_ip/s, c_i) in the plane frame with |r_i| = 1 and
    # r1·r2 = 0 ⇒ s² is the larger root of s⁴ − (g11+g22)s² + (g11·g22 − g12²).
    g11 = _dot(a1p, a1p)
    g22 = _dot(a2p, a2p)
    g12 = _dot(a1p, a2p)
    disc = torch.sqrt(((g11 - g22) ** 2 + 4.0 * g12 * g12).clamp(min=0.0))
    s2 = (0.5 * (g11 + g22 + disc)).clamp(min=1e-24)
    s = torch.sqrt(s2)
    c1 = torch.sqrt((1.0 - g11 / s2).clamp(min=0.0))
    c2m = torch.sqrt((1.0 - g22 / s2).clamp(min=0.0))
    c2 = torch.where(c1 > 1e-9, -g12 / (s2 * c1.clamp(min=1e-20)), c2m)

    def pose(c1s, c2s):
        r1 = (a1p[..., 0:1] * e1 + a1p[..., 1:2] * e2) / s[..., None] \
            + c1s[..., None] * nrm
        r2 = (a2p[..., 0:1] * e1 + a2p[..., 1:2] * e2) / s[..., None] \
            + c2s[..., None] * nrm
        r1 = r1 / torch.linalg.vector_norm(r1, dim=-1, keepdim=True).clamp(
            min=1e-20)
        r2 = r2 - _dot(r1, r2)[..., None] * r1
        r2 = r2 / torch.linalg.vector_norm(r2, dim=-1, keepdim=True).clamp(
            min=1e-20)
        r3 = torch.linalg.cross(r1, r2, dim=-1)
        R = torch.stack([r1, r2, r3], dim=-2)
        tz = 1.0 / s
        t = torch.cat([b * tz[..., None], tz[..., None]], dim=-1) \
            - bmm(R, c[..., None])[..., 0]
        return R, t

    Ra, ta = pose(c1, c2)
    Rb, tb = pose(-c1, -c2)
    R2 = torch.stack([Ra, Rb], dim=-3)
    t2 = torch.stack([ta, tb], dim=-2)
    ok = (torch.isfinite(R2).flatten(-3).all(-1)
          & torch.isfinite(t2).flatten(-2).all(-1) & (s > 0))
    return R2, t2, ok


