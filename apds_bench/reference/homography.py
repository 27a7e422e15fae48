"""Homography estimation: normalized DLT + fixed-batch RANSAC, LMedS and
RHO (port of ops/geometry/homography.py).

A fixed batch of H minimal 4-point samples, all hypotheses solved as one
batched 8×8 system and scored against all points at once, the winner
refined by masked DLT on its inliers. The draws come from a CPU
`torch.Generator` seeded with `config.seed` (same numbers on every
device), uploaded once per (seed, shape, device), or from a caller-given
tensor `r` — tests feed the JAX package's draws through it.

`find_homography_ransac` takes correspondences with leading batch
dimensions: B frames run as one pass with B·H hypotheses, every frame
drawing from the same uniforms scaled by its own count of valid
correspondences (the JAX package's vmap, where every frame gets the same
key). A lone frame is the case with no leading dimension.
"""

from __future__ import annotations

import torch

from apds_bench.reference.config import RansacConfig
from apds_bench.reference.types_ import (
    HomographyResult, device_const, fold_lead, pick, take_rows, unfold_lead)
from apds_bench.reference.linalg_small import (
    bmm, cholesky_solve, det3x3, highest_matmul_precision)


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


@highest_matmul_precision
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
    Awt = Aw.transpose(-1, -2)
    AtA = bmm(Awt, Aw)
    Atb = bmm(Awt, bw[..., None])[..., 0]
    h8 = cholesky_solve(AtA, Atb, damp=1e-8)
    Hn = torch.cat([h8, torch.ones(h8.shape[:-1] + (1,), dtype=h8.dtype,
                                   device=h8.device)], dim=-1)
    Hn = Hn.reshape(h8.shape[:-1] + (3, 3))
    H = torch.linalg.solve_ex(Td, bmm(Hn, Ts))[0]
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
    """Forward reprojection error ||H·src − dst||² per point [..., N]
    (H [..., 3, 3] and the points [..., N, 2] broadcast), H·src by
    elementwise multiply-adds."""
    x, y = src[..., 0], src[..., 1]
    u, v, z = (H[..., i, 0, None] * x + H[..., i, 1, None] * y
               + H[..., i, 2, None] for i in range(3))
    z = torch.where(z.abs() < 1e-12, 1e-12, z)
    proj = torch.stack([u / z, v / z], dim=-1)
    return ((proj - dst) ** 2).sum(-1)


def seeded_uniforms(seed: int, shape, device):
    """Uniform float32 [0, 1) of `shape` from a CPU generator seeded with
    `seed` (the same numbers on every device), uploaded to `device` once
    (`device_const`); callers never write to the result."""
    gen = torch.Generator().manual_seed(int(seed))
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32)
    return device_const(u.numpy(), torch.float32, device)


def draw_indices(num_valid, shape, seed: int, device):
    """Uniform ints in [0, max(num_valid, 1)): `seeded_uniforms` of
    `shape` scaled on `device` by each num_valid (no host sync). num_valid
    [...] gives [..., *shape]: one set of uniforms serves every frame."""
    u = seeded_uniforms(seed, shape, device)
    n = num_valid.clamp(min=1)
    n = n.reshape(n.shape + (1,) * len(shape))
    return torch.minimum((u * n.to(torch.float32)).floor().long(), n - 1)


def _rho_sample(valid, num_valid, quality, u):
    """PROSAC pools as a fixed batch, per frame of [B, N]: valid
    correspondences ranked by `quality` (lower is better, stable on ties),
    hypothesis h drawing its sample from the top n_h with n_h growing
    geometrically from 8 to num_valid [B]. u: [H, 4] (or [B, H, 4])
    uniform floats in [0, 1). Returns [B, H, 4] correspondence indices."""
    nh = u.shape[-2]
    q = torch.where(valid, quality.to(torch.float32), torch.inf)
    ranked = torch.argsort(q, dim=-1, stable=True)           # best first
    nvf = num_valid.to(torch.float32)[:, None]               # [B, 1]
    nv = nvf.clamp(min=8.0)
    grow = torch.exp2(torch.linspace(0.0, 1.0, nh, device=u.device)
                      * torch.log2(nv / 8.0)) * 8.0          # [B, H]
    pool = torch.minimum(torch.ceil(grow), nvf)
    pool = torch.maximum(pool, nvf.clamp(max=8.0)).to(torch.int64)
    pool = pool.clamp(min=1)               # num_valid == 0: no negative r
    r = torch.minimum((u * pool[..., None].to(torch.float32)).to(torch.int64),
                      pool[..., None] - 1)
    return take_rows(ranked, r)


def draws_per_frame(r, b: int, nh: int, k: int, dev, dtype):
    """A caller's draws as [B, H, k]: [H, k] serves every frame, [..., H,
    k] one set per frame."""
    r = torch.as_tensor(r, device=dev).to(dtype)
    if r.dim() == 2:
        return r.expand(b, nh, k)
    return r.reshape(b, nh, k)


@highest_matmul_precision
def find_homography_ransac(src, dst, valid=None,
                           config: RansacConfig = RansacConfig(),
                           key=None, method: str = "ransac",
                           quality=None, *, r=None) -> HomographyResult:
    """Robust homography from fixed-capacity correspondences.

    src, dst: [..., N, 2]; valid: [..., N] bool. Leading dimensions are a
    batch of frames, solved in one pass (the JAX package's vmap of this
    function); none is one frame. Returns a HomographyResult with the
    same leading dimensions whose inlier mask has find_homography_mat's
    RANSAC mask semantics (reference: homographier mod.rs:243-256).

    method: "ransac" (inlier-count scoring), "lmeds" (least median of
    squares; inliers from the robust 2.5·σ gate, σ = 1.4826·√median) or
    "rho" (PROSAC-style progressive sampling, the reference's
    HomographyMethod::RHO, mod.rs:25-31): `quality` [..., N] ranks the
    correspondences (lower is better, e.g. the match distance) and
    hypothesis h draws from the top n_h of them. Without `quality`,
    "rho" is "ransac".

    key: the seed of the CPU generator that makes the draws (an int);
    None draws from `config.seed`, as the JAX package's
    PRNGKey(config.seed) default.
    r: optional draws replacing the seeded ones — [H, 4] (every frame) or
    [..., H, 4] (per frame) indices into the valid entries (in index
    order) for "ransac" and "lmeds", uniform floats in [0, 1) for "rho"
    with `quality`.
    """
    if method not in ("ransac", "lmeds", "rho"):
        raise ValueError(f"unknown homography method {method!r}")
    src = src.to(torch.float32)
    dst = dst.to(torch.float32)
    lead = src.shape[:-2]
    n = src.shape[-2]
    dev = src.device
    if valid is None:
        valid = torch.ones(lead + (n,), dtype=torch.bool, device=dev)
    if quality is not None:
        quality = torch.as_tensor(quality, device=dev)
    src, dst, valid, quality = fold_lead((src, dst, valid, quality),
                                         len(lead))
    seed = config.seed if key is None else int(key)
    return unfold_lead(_ransac_batch(src, dst, valid, config, seed, r,
                                     method, quality), lead)


def _ransac_batch(src, dst, valid, config: RansacConfig, seed: int, r,
                  method: str, quality) -> HomographyResult:
    """find_homography_ransac on [B, N] correspondences."""
    b, n = valid.shape
    dev = src.device
    num_valid = valid.sum(-1)                                # [B]
    nh = config.num_hypotheses

    if method == "rho" and quality is not None:
        u = (seeded_uniforms(seed, (nh, 4), dev) if r is None
             else draws_per_frame(r, b, nh, 4, dev, torch.float32))
        sample_idx = _rho_sample(valid, num_valid, quality, u)
    else:
        valid_first = torch.argsort((~valid).to(torch.uint8), dim=-1,
                                    stable=True)
        r = (draw_indices(num_valid, (nh, 4), seed, dev)
             if r is None else draws_per_frame(r, b, nh, 4, dev, torch.int64))
        sample_idx = take_rows(valid_first, r)               # [B, H, 4]

    s4 = take_rows(src, sample_idx)                          # [B, H, 4, 2]
    d4 = take_rows(dst, sample_idx)
    Hs = dlt_homography_solve(s4, d4)                        # [B, H, 3, 3]

    err = symmetric_transfer_error(Hs, src[:, None], dst[:, None])
    finite = torch.isfinite(Hs.flatten(-2)).all(-1)          # [B, H]
    finite = finite & _sample_nondegenerate(s4) & _sample_nondegenerate(d4)
    finite = finite & (det3x3(Hs).abs() > 1e-6)
    if method == "lmeds":
        big = 1e30
        err_v = torch.where(valid[:, None, :] & torch.isfinite(err), err,
                            torch.nan)
        med = torch.nanquantile(err_v, 0.5, dim=-1, interpolation="nearest")
        med = torch.where(torch.isfinite(med), med, big)
        best = torch.where(finite, med, big).argmin(-1)
        hyp_ok = pick(finite, best)
        thr2 = ((2.5 * 1.4826) ** 2
                * pick(med, best).clamp(min=1e-12))[:, None]
        inliers = (pick(err, best) < thr2) & valid & hyp_ok[:, None]
    else:
        thr2 = config.reproj_threshold ** 2
        inl = (err < thr2) & valid[:, None, :]
        scores = torch.where(finite, inl.sum(-1), -1)
        best = scores.argmax(-1)
        hyp_ok = pick(scores, best) >= 0  # all hypotheses degenerate → fail
        inliers = pick(inl, best) & hyp_ok[:, None]
    H_best = pick(Hs, best)

    for _ in range(config.refine_iters):
        H_new = dlt_homography_solve(src, dst, inliers.to(torch.float32))
        inl_new = (symmetric_transfer_error(H_new, src, dst) < thr2) & valid
        ok_new = (torch.isfinite(H_new).flatten(-2).all(-1)
                  & (inl_new.sum(-1) >= inliers.sum(-1))
                  & hyp_ok & (det3x3(H_new).abs() > 1e-6))
        H_best = torch.where(ok_new[:, None, None], H_new, H_best)
        inliers = torch.where(ok_new[:, None], inl_new, inliers)

    num_inl = inliers.sum(-1, dtype=torch.int32)
    ok = ((num_valid >= 4) & (num_inl >= 4) & hyp_ok
          & torch.isfinite(H_best).flatten(-2).all(-1)
          & (det3x3(H_best).abs() > 1e-6))
    return HomographyResult(H=H_best, inliers=inliers, num_inliers=num_inl,
                            ok=ok)
