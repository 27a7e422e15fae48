"""Batched EPnP: pose from n ≥ 4 3D–2D correspondences (port of
ops/geometry/epnp.py; Lepetit, Moreno-Noguer, Fua, IJCV 2009).

Every function batches over leading dimensions, so the RANSAC caller
solves all hypotheses of all frames of a batch in one call instead of a
vmap.
"""

from __future__ import annotations

import numpy as np
import torch

from apds_bench.reference.types_ import device_const
from apds_bench.reference.linalg_small import (
    bmm, cholesky_solve, det3x3, eigh3x3, eigh_smallest, lstsq_normal,
    polar_rotation)
from apds_bench.reference.twins import procrustes_rotation

# Control-point distance constraint index pairs (6 pairs of 4 points).
_PAIRS = np.array([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)])


def _pair_index(x, dim: int):
    """x's slices at the pairs' first and second points along `dim`, the
    index tensors uploaded once per device."""
    p0 = device_const(_PAIRS[:, 0], torch.long, x.device)
    p1 = device_const(_PAIRS[:, 1], torch.long, x.device)
    return x.index_select(dim, p0), x.index_select(dim, p1)


def _mT(x):
    return x.transpose(-1, -2)


def _control_points(obj, w):
    """Centroid + principal-axis control points [..., 4, 3]."""
    wsum = w.sum(-1).clamp(min=1e-12)
    c0 = (obj * w[..., None]).sum(-2) / wsum[..., None]
    centered = (obj - c0[..., None, :]) * w[..., None]
    cov = bmm(_mT(centered), centered) / wsum[..., None, None]
    eigval, eigvec = eigh3x3(cov)
    # Axes floored RELATIVE to the largest, so planar point sets keep a
    # non-singular barycentric system.
    eig_max = eigval[..., -1].clamp(min=1e-12)
    scale = torch.sqrt(torch.maximum(eigval, 1e-4 * eig_max[..., None]))
    cpts = c0[..., None, :] + _mT(eigvec) * scale[..., :, None]
    return torch.cat([c0[..., None, :], cpts], dim=-2)


def _barycentric(obj, cw):
    """α [..., n, 4] with obj = α @ cw, Σα = 1 (damped normal equations)."""
    ones4 = torch.ones(cw.shape[:-2] + (1, 4), dtype=cw.dtype,
                       device=cw.device)
    A = torch.cat([_mT(cw), ones4], dim=-2)                          # [..., 4, 4]
    onesn = torch.ones(obj.shape[:-2] + (1, obj.shape[-2]), dtype=obj.dtype,
                       device=obj.device)
    b = torch.cat([_mT(obj), onesn], dim=-2)                         # [..., 4, n]
    AtA = bmm(_mT(A), A)
    damp = 1e-9 * torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(4, dtype=AtA.dtype, device=AtA.device)
    alpha = cholesky_solve(AtA + damp[..., None, None] * eye, bmm(_mT(A), b))
    return _mT(alpha)


def _build_M(alpha, uv_n, w):
    """2n×12 EPnP design matrix from normalized image coords."""
    n = alpha.shape[-2]
    u = uv_n[..., 0]
    v = uv_n[..., 1]
    zeros = torch.zeros_like(alpha)
    r1 = torch.stack([alpha, zeros, -u[..., None] * alpha], dim=-1)
    r2 = torch.stack([zeros, alpha, -v[..., None] * alpha], dim=-1)
    lead = alpha.shape[:-2]
    M = torch.cat([r1.reshape(lead + (n, 12)), r2.reshape(lead + (n, 12))],
                  dim=-2)
    return M * torch.cat([w, w], dim=-1)[..., None]


def _pair_diffs(pts4):
    """[..., 4, 3] → [..., 6, 3] control-point differences over _PAIRS."""
    a, b = _pair_index(pts4, -2)
    return a - b


def _procrustes(src, dst, w, fast: bool = False):
    """Weighted rigid alignment R, t minimizing ||R·src + t − dst||².
    fast=True: Newton polar iteration instead of the SVD. A non-finite S
    (a failed β case) yields a NaN rotation that the caller's finite-error
    check discards."""
    wsum = w.sum(-1).clamp(min=1e-12)[..., None]
    mu_s = (src * w[..., None]).sum(-2) / wsum
    mu_d = (dst * w[..., None]).sum(-2) / wsum
    S = bmm(_mT((dst - mu_d[..., None, :]) * w[..., None]),
            src - mu_s[..., None, :])
    # fast: Newton polar iteration; exact: the SVD's rotation (a kernel on
    # the card, its plain twin on the CPU).
    R = polar_rotation(S) if fast else procrustes_rotation(S)
    t = mu_d - bmm(R, mu_s[..., None])[..., 0]
    return R, t


def _gauss_newton_betas(betas, vmat, rho, iters: int = 5):
    """Refine β [..., 4] minimizing Σ (||c_i − c_j||²(β) − ρ_ij)².
    The residual is quadratic in β, so its Jacobian is 2·dᵀ·D with d the
    control-point differences and D their (linear) map from β."""
    V4 = vmat.reshape(vmat.shape[:-2] + (4, 3, 4))   # [..., point, coord, β]
    D0, D1 = _pair_index(V4, -3)
    D = D0 - D1                                       # [..., 6, 3, 4]
    for _ in range(iters):
        x = bmm(vmat, betas[..., None])[..., 0]
        d = _pair_diffs(x.reshape(x.shape[:-1] + (4, 3)))        # [..., 6, 3]
        r = (d * d).sum(-1) - rho
        J = (2.0 * d[..., None] * D).sum(-2)                     # [..., 6, 4]
        delta = cholesky_solve(bmm(_mT(J), J),
                               bmm(_mT(J), r[..., None])[..., 0], damp=1e-9)
        betas = betas - delta
    return betas


def epnp(obj_points, img_points_normalized, weights=None,
         fast: bool = False):
    """EPnP pose solve on [..., n, 3] world points and [..., n, 2]
    normalized image points (weights [..., n], 0 masks). fast=True swaps
    the Procrustes SVD for a polar iteration (hypothesis batches).
    Returns (R [..., 3, 3], t [..., 3], ok [...])."""
    obj = obj_points
    uv = img_points_normalized.to(obj.dtype)
    w = torch.ones(obj.shape[:-1], dtype=obj.dtype, device=obj.device) \
        if weights is None else weights.to(obj.dtype)

    cw = _control_points(obj, w)
    alpha = _barycentric(obj, cw)
    M = _build_M(alpha, uv, w)
    V = eigh_smallest(bmm(_mT(M), M), 4)                      # [..., 12, 4]
    rho = torch.sqrt((_pair_diffs(cw) ** 2).sum(-1).clamp(min=1e-18)) ** 2

    def dv(i, j):
        ci = V[..., :, i].reshape(V.shape[:-2] + (4, 3))
        cj = V[..., :, j].reshape(V.shape[:-2] + (4, 3))
        return (_pair_diffs(ci) * _pair_diffs(cj)).sum(-1)      # [..., 6]

    zero = torch.zeros_like(rho[..., 0])
    dv00 = dv(0, 0)
    beta1 = (torch.sqrt(dv00.clamp(min=1e-18)) * torch.sqrt(rho)).sum(-1) \
        / dv00.sum(-1).clamp(min=1e-18)
    case1 = torch.stack([beta1, zero, zero, zero], dim=-1)

    def root(x):
        return torch.sqrt(x.abs().clamp(min=1e-18))

    L2 = torch.stack([dv00, 2 * dv(0, 1), dv(1, 1)], dim=-1)
    s2 = lstsq_normal(L2, rho, damp=1e-9)
    case2 = torch.stack([root(s2[..., 0]),
                         root(s2[..., 2]) * torch.sign(s2[..., 1])
                         * torch.sign(s2[..., 0]), zero, zero], dim=-1)
    L3 = torch.stack([dv00, 2 * dv(0, 1), dv(1, 1), 2 * dv(0, 2),
                      2 * dv(1, 2), dv(2, 2)], dim=-1)
    s3 = lstsq_normal(L3, rho, damp=1e-9)
    case3 = torch.stack([root(s3[..., 0]),
                         root(s3[..., 2]) * torch.sign(s3[..., 1])
                         * torch.sign(s3[..., 0]),
                         root(s3[..., 5]) * torch.sign(s3[..., 3])
                         * torch.sign(s3[..., 0]), zero], dim=-1)

    # The three β initializations run as one extra batch dimension.
    cases = torch.stack([case1, case2, case3], dim=-2)         # [..., 3, 4]
    Vc = V[..., None, :, :]
    betas = _gauss_newton_betas(cases, Vc, rho[..., None, :])
    x = bmm(Vc, betas[..., None])[..., 0]
    cam = bmm(alpha[..., None, :, :], x.reshape(x.shape[:-1] + (4, 3)))
    wc = w[..., None, :]
    depth_sign = torch.sign((cam[..., 2] * wc).sum(-1) + 1e-18)
    cam = cam * depth_sign[..., None, None]
    objc = obj[..., None, :, :]
    Rs, ts = _procrustes(objc.expand(cam.shape), cam, wc.expand(cam.shape[:-1]),
                         fast=fast)
    proj = bmm(objc, _mT(Rs)) + ts[..., None, :]
    z = torch.where(proj[..., 2].abs() < 1e-12, 1e-12, proj[..., 2])
    uv_hat = proj[..., :2] / z[..., None]
    errs = (((uv_hat - uv[..., None, :, :]) ** 2).sum(-1) * wc).sum(-1)
    errs = torch.where(torch.isfinite(errs), errs, torch.inf)
    best = errs.argmin(-1)
    R_best = torch.take_along_dim(Rs, best[..., None, None, None], dim=-3)[..., 0, :, :]
    t_best = torch.take_along_dim(ts, best[..., None, None], dim=-2)[..., 0, :]
    err_best = torch.take_along_dim(errs, best[..., None], dim=-1)[..., 0]
    # Validity requires an actual rotation: the polar iteration can return
    # a scaled non-rigid map on degenerate samples.
    eye = torch.eye(3, dtype=R_best.dtype, device=R_best.device)
    ortho_err = (bmm(_mT(R_best), R_best) - eye).abs().amax(dim=(-2, -1))
    ok = torch.isfinite(err_best) & (ortho_err < 0.1) \
        & ((det3x3(R_best) - 1.0).abs() < 0.5)
    return R_best, t_best, ok


