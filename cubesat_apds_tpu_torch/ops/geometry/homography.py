"""Homography estimation: normalized DLT + fixed-batch RANSAC, LMedS and
RHO (port of ops/geometry/homography.py).

A fixed batch of H minimal 4-point samples, all hypotheses solved as one
batched 8×8 system and scored against all points at once, the winner
refined by masked DLT on its inliers. The draws come from a CPU
`torch.Generator` seeded with `config.seed` (same numbers on every
device) or from a caller-given tensor `r` — tests feed the JAX package's
draws through it.
"""

from __future__ import annotations

import torch

from cubesat_apds_tpu_torch.core.config import RansacConfig
from cubesat_apds_tpu_torch.core.types import HomographyResult
from cubesat_apds_tpu_torch.ops.geometry.linalg_small import (
    cholesky_solve, det3x3)
from cubesat_apds_tpu_torch.ops.warp import apply_homography


def _normalize_points(pts, weights):
    """Weighted Hartley normalization → (normalized pts, 3×3 similarity T)
    with weighted mean 0 and RMS √2."""
    w = weights[..., None]
    wsum = w.sum(-2).clamp(min=1e-12)                       # [..., 1]
    mean = (pts * w).sum(-2, keepdim=True) / wsum[..., None, :]
    centered = pts - mean
    rms = torch.sqrt(((centered ** 2).sum(-1, keepdim=True) * w).sum(-2)
                     / wsum)[..., 0]
    scale = 2.0 ** 0.5 / rms.clamp(min=1e-12)
    zero = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    T = torch.stack([
        torch.stack([scale, zero, -scale * mean[..., 0, 0]], -1),
        torch.stack([zero, scale, -scale * mean[..., 0, 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    return centered * scale[..., None, None], T


def dlt_homography(src, dst, weights=None):
    """Weighted DLT: H with dst ~ H·src from ≥ 4 correspondences, the
    nullspace of the 2N×9 design matrix from the eigenvector of AᵀA with
    the smallest eigenvalue.

    src, dst: [..., N, 2]; weights [..., N] (0 masks a correspondence).
    Returns [..., 3, 3] normalized to H[2,2] = 1.
    """
    dst = dst.to(src.dtype)
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    else:
        weights = weights.to(src.dtype)
    sn, Ts = _normalize_points(src, weights)
    dn, Td = _normalize_points(dst, weights)
    x, y = sn[..., 0], sn[..., 1]
    u, v = dn[..., 0], dn[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    r1 = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], -1)
    r2 = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], -1)
    A = torch.cat([r1, r2], dim=-2) \
        * torch.cat([weights, weights], dim=-1)[..., None]  # [..., 2N, 9]
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    Hn = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))
    H = torch.linalg.solve_ex(Td, Hn @ Ts)[0]               # Td⁻¹·Hn·Ts
    scale = H[..., 2:3, 2:3]
    return H / torch.where(scale.abs() < 1e-12, 1e-12, scale)


def dlt_homography_solve(src, dst, weights=None):
    """DLT with H[2,2] = 1: an 8×8 normal-equation solve per hypothesis.

    src, dst: [..., N, 2]; weights [..., N] (0 masks a correspondence).
    A degenerate H comes out non-finite or near-singular and is rejected
    by the RANSAC scorer.
    """
    dst = dst.to(src.dtype)
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    else:
        weights = weights.to(src.dtype)
    sn, Ts = _normalize_points(src, weights)
    dn, Td = _normalize_points(dst, weights)
    x, y = sn[..., 0], sn[..., 1]
    u, v = dn[..., 0], dn[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y], dim=-1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                          # [..., 2N, 8]
    b = torch.cat([u, v], dim=-1)                            # [..., 2N]
    w2 = torch.cat([weights, weights], dim=-1)
    Aw = A * w2[..., None]
    bw = b * w2
    AtA = Aw.transpose(-1, -2) @ Aw
    Atb = (Aw.transpose(-1, -2) @ bw[..., None])[..., 0]
    h8 = cholesky_solve(AtA, Atb, damp=1e-8)
    Hn = torch.cat([h8, torch.ones(h8.shape[:-1] + (1,), dtype=h8.dtype,
                                   device=h8.device)], dim=-1)
    Hn = Hn.reshape(h8.shape[:-1] + (3, 3))
    H = torch.linalg.solve_ex(Td, Hn @ Ts)[0]
    scale = H[..., 2:3, 2:3]
    return H / torch.where(scale.abs() < 1e-12, 1e-12, scale)


def _sample_nondegenerate(p4):
    """[..., 4, 2] minimal samples → [...] bool: all four points distinct
    and no three collinear (the guard against many-to-one match
    clusters, whose rank-deficient fits score every cluster match as a
    zero-error inlier)."""
    diff = p4[..., :, None, :] - p4[..., None, :, :]
    d2 = (diff * diff).sum(-1)
    eye = torch.eye(4, dtype=torch.bool, device=p4.device)
    distinct = (torch.where(eye, 1.0, d2) > 1e-9).all(-1).all(-1)
    spread = d2.amax(dim=(-2, -1)).clamp(min=1e-12)

    def cross(i, j, k):
        a = p4[..., j, :] - p4[..., i, :]
        b = p4[..., k, :] - p4[..., i, :]
        return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]

    noncol = torch.ones(p4.shape[:-2], dtype=torch.bool, device=p4.device)
    for (i, j, k) in ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)):
        noncol = noncol & (cross(i, j, k).abs() > 1e-7 * spread)
    return distinct & noncol


_det3 = det3x3        # the JAX package's name for the closed-form det


def symmetric_transfer_error(H, src, dst):
    """Forward reprojection error ||H·src − dst||² per point [..., N]."""
    return ((apply_homography(H, src) - dst) ** 2).sum(-1)


def draw_indices(num_valid, shape, seed: int, device):
    """Uniform ints in [0, max(num_valid, 1)) of `shape`: floats from a
    CPU generator seeded with `seed`, scaled on `device` (no host sync;
    the same draws on every device)."""
    gen = torch.Generator().manual_seed(int(seed))
    u = torch.rand(shape, generator=gen, dtype=torch.float32).to(device)
    n = num_valid.clamp(min=1)
    return torch.minimum((u * n.to(torch.float32)).floor().long(), n - 1)


def _rho_sample(valid, num_valid, quality, u):
    """PROSAC pools as a fixed batch: valid correspondences ranked by
    `quality` (lower is better, stable on ties), hypothesis h drawing its
    sample from the top n_h with n_h growing geometrically from 8 to
    num_valid. u: [H, 4] uniform floats in [0, 1). Returns [H, 4]
    correspondence indices."""
    nh = u.shape[0]
    q = torch.where(valid, quality.to(torch.float32), torch.inf)
    ranked = torch.argsort(q, stable=True)                   # best first
    nvf = num_valid.to(torch.float32)
    nv = nvf.clamp(min=8.0)
    grow = torch.exp2(torch.linspace(0.0, 1.0, nh, device=u.device)
                      * torch.log2(nv / 8.0)) * 8.0          # [H] in [8, nv]
    pool = torch.minimum(torch.ceil(grow), nvf)
    pool = torch.maximum(pool, nvf.clamp(max=8.0)).to(torch.int64)
    pool = pool.clamp(min=1)               # num_valid == 0: no negative r
    r = torch.minimum((u * pool[:, None].to(torch.float32)).to(torch.int64),
                      pool[:, None] - 1)
    return ranked[r]


def find_homography_ransac(src, dst, valid=None,
                           config: RansacConfig = RansacConfig(),
                           r=None, method: str = "ransac",
                           quality=None) -> HomographyResult:
    """Robust homography from fixed-capacity correspondences.

    src, dst: [N, 2]; valid: [N] bool. Returns a HomographyResult whose
    inlier mask has find_homography_mat's RANSAC mask semantics
    (reference: homographier mod.rs:243-256).

    method: "ransac" (inlier-count scoring), "lmeds" (least median of
    squares; inliers from the robust 2.5·σ gate, σ = 1.4826·√median) or
    "rho" (PROSAC-style progressive sampling, the reference's
    HomographyMethod::RHO, mod.rs:25-31): `quality` [N] ranks the
    correspondences (lower is better, e.g. the match distance) and
    hypothesis h draws from the top n_h of them. Without `quality`,
    "rho" is "ransac".

    r: optional draws replacing the seeded ones — [H, 4] indices into the
    valid entries (in index order) for "ransac" and "lmeds", [H, 4]
    uniform floats in [0, 1) for "rho" with `quality`.
    """
    if method not in ("ransac", "lmeds", "rho"):
        raise ValueError(f"unknown homography method {method!r}")
    src = src.to(torch.float32)
    dst = dst.to(torch.float32)
    n = src.shape[0]
    dev = src.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    num_valid = valid.sum()
    nh = config.num_hypotheses

    if method == "rho" and quality is not None:
        if r is None:
            gen = torch.Generator().manual_seed(int(config.seed))
            r = torch.rand((nh, 4), generator=gen, dtype=torch.float32)
        sample_idx = _rho_sample(valid, num_valid,
                                 torch.as_tensor(quality, device=dev),
                                 torch.as_tensor(r, dtype=torch.float32,
                                                 device=dev))
    else:
        valid_first = torch.argsort((~valid).to(torch.uint8), stable=True)
        if r is None:
            r = draw_indices(num_valid, (nh, 4), config.seed, dev)
        sample_idx = valid_first[torch.as_tensor(r, device=dev).long()]

    s4 = src[sample_idx]                                     # [H, 4, 2]
    d4 = dst[sample_idx]
    Hs = dlt_homography_solve(s4, d4)                        # [H, 3, 3]

    err = symmetric_transfer_error(Hs, src[None], dst[None])  # [H, N]
    finite = torch.isfinite(Hs.reshape(Hs.shape[0], -1)).all(-1)
    finite = finite & _sample_nondegenerate(s4) & _sample_nondegenerate(d4)
    finite = finite & (det3x3(Hs).abs() > 1e-6)
    if method == "lmeds":
        big = 1e30
        err_v = torch.where(valid[None, :] & torch.isfinite(err), err,
                            torch.nan)
        med = torch.nanquantile(err_v, 0.5, dim=-1, interpolation="nearest")
        med = torch.where(torch.isfinite(med), med, big)
        best = torch.where(finite, med, big).argmin()
        hyp_ok = finite[best]
        thr2 = (2.5 * 1.4826) ** 2 * med[best].clamp(min=1e-12)
        inliers = (err[best] < thr2) & valid & hyp_ok
    else:
        thr2 = config.reproj_threshold ** 2
        inl = (err < thr2) & valid[None, :]
        scores = torch.where(finite, inl.sum(-1), -1)
        best = scores.argmax()
        hyp_ok = scores[best] >= 0        # all hypotheses degenerate → fail
        inliers = inl[best] & hyp_ok
    H_best = Hs[best]

    for _ in range(config.refine_iters):
        H_new = dlt_homography_solve(src, dst, inliers.to(torch.float32))
        inl_new = (symmetric_transfer_error(H_new, src, dst) < thr2) & valid
        ok_new = (torch.isfinite(H_new).all() & (inl_new.sum() >= inliers.sum())
                  & hyp_ok & (det3x3(H_new).abs() > 1e-6))
        H_best = torch.where(ok_new, H_new, H_best)
        inliers = torch.where(ok_new, inl_new, inliers)

    num_inl = inliers.sum(dtype=torch.int32)
    ok = ((num_valid >= 4) & (num_inl >= 4) & hyp_ok
          & torch.isfinite(H_best).all() & (det3x3(H_best).abs() > 1e-6))
    return HomographyResult(H=H_best, inliers=inliers, num_inliers=num_inl,
                            ok=ok)
