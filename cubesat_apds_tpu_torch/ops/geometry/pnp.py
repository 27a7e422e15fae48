"""PnP-RANSAC and plain PnP: 6-DoF pose from 3D–2D correspondences (port
of ops/geometry/pnp.py: solve_pnp_ransac, solve_pnp).

A fixed batch of minimal samples, each solved by EPnP and the planar
solver, plus the two global weak-perspective candidates; the optional
up-gate, MSAC (truncated-error) scoring, a refit on the winner's inliers,
a monotone Gauss-Newton polish and the 5% consensus floor — as in the
JAX package. Draws come from a CPU `torch.Generator` seeded with
`config.seed`, or from a caller-given index tensor `r`.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from cubesat_apds_tpu_torch.core.camera import pixels_to_normalized
from cubesat_apds_tpu_torch.core.config import PnPConfig
from cubesat_apds_tpu_torch.core.types import (
    CameraModel, Correspondences, PoseSolution)
from cubesat_apds_tpu_torch.ops.geometry.epnp import epnp
from cubesat_apds_tpu_torch.ops.geometry.homography import draw_indices
from cubesat_apds_tpu_torch.ops.geometry.linalg_small import cholesky_solve
from cubesat_apds_tpu_torch.ops.geometry.planar import (
    ortho_pose_candidates, planar_pose)
from cubesat_apds_tpu_torch.ops.geometry.rodrigues import (
    matrix_to_rodrigues, rodrigues_to_matrix)


def _apply_pose(R, t, obj):
    """cam = R·obj + t by elementwise multiply-add, [..., 3, 3] × [N, 3]
    → [..., N, 3] (no matrix unit: pose scores must not depend on a
    matmul precision mode)."""
    ox = obj[:, 0][:, None]
    oy = obj[:, 1][:, None]
    oz = obj[:, 2][:, None]
    cam = (R[..., None, :, 0] * ox + R[..., None, :, 1] * oy
           + R[..., None, :, 2] * oz)
    return cam + t[..., None, :]


def _reproj_err_normalized(R, t, obj, uv_n):
    """Squared reprojection error in normalized coords [..., N]; points
    behind the camera score inf."""
    cam = _apply_pose(R, t, obj)
    z = cam[..., 2]
    zs = torch.where(z.abs() < 1e-12, 1e-12, z)
    err = ((cam[..., :2] / zs[..., None] - uv_n) ** 2).sum(-1)
    return torch.where(z <= 1e-6, torch.inf, err)


def _gn_refine_pose(rvec, tvec, obj, uv_n, weights, iters: int):
    """Gauss-Newton on (rvec, tvec); a step is kept only when it lowers
    the weighted residual norm."""

    def residuals(params):
        R = rodrigues_to_matrix(params[:3])
        cam = _apply_pose(R, params[3:], obj)
        z = torch.where(cam[:, 2].abs() < 1e-12, 1e-12, cam[:, 2])
        return ((cam[:, :2] / z[:, None] - uv_n)
                * weights[:, None]).reshape(-1)

    params = torch.cat([rvec, tvec])
    for _ in range(iters):
        r = residuals(params)
        J = jacfwd(residuals)(params)
        delta = cholesky_solve(J.T @ J, J.T @ r, damp=1e-9)
        new = params - delta
        ok = torch.isfinite(new).all() & \
            ((residuals(new) ** 2).sum() < (r ** 2).sum())
        params = torch.where(ok, new, params)
    return params[:3], params[3:]


def solve_pnp_ransac(corr: Correspondences, camera: CameraModel,
                     config: PnPConfig = PnPConfig(), up=None,
                     r=None) -> PoseSolution:
    """RANSAC-EPnP over fixed-capacity correspondences.

    corr.obj_points [N, 3], corr.img_points [N, 2] pixels, corr.valid [N].
    `up` ([3] world-frame unit vector, optional): the camera centre must
    lie on its + side for a hypothesis to be selected. `r`: optional
    [H, sample_size] indices into the valid entries replacing the draws.
    """
    obj = corr.obj_points.to(torch.float32)
    pix = corr.img_points.to(torch.float32)
    valid = corr.valid
    dev = obj.device

    uv_n = pixels_to_normalized(pix, camera)
    vf = valid.to(torch.float32)
    num_valid = valid.sum()

    # Zero-centroid / unit-RMS world frame; t maps back exactly below.
    nvf = vf.sum().clamp(min=1.0)
    c_obj = (obj * vf[:, None]).sum(0) / nvf
    centered = (obj - c_obj) * vf[:, None]
    scale = torch.sqrt((centered * centered).sum() / nvf).clamp(min=1e-12)
    obj = (obj - c_obj) / scale

    f_avg = 0.5 * (camera.K[0, 0] + camera.K[1, 1])
    thr2 = (config.reproj_threshold / f_avg) ** 2

    valid_first = torch.argsort((~valid).to(torch.uint8), stable=True)
    if r is None:
        r = draw_indices(num_valid, (config.num_hypotheses, config.sample_size),
                         config.seed, dev)
    samp = valid_first[torch.as_tensor(r, device=dev).long()]
    obj_s, uv_s = obj[samp], uv_n[samp]
    R, t, ok = epnp(obj_s, uv_s, fast=True)
    Rp, tp, okp = planar_pose(obj_s, uv_s)
    # Per hypothesis (EPnP, planar), interleaved as the JAX package's
    # vmap + reshape lays them out (argmin ties pick the first).
    Rs = torch.stack([R, Rp], dim=1).reshape(-1, 3, 3)
    ts = torch.stack([t, tp], dim=1).reshape(-1, 3)
    oks = torch.stack([ok, okp], dim=1).reshape(-1)

    R_o, t_o, ok_o = ortho_pose_candidates(obj, uv_n, vf)
    Rs = torch.cat([Rs, R_o], dim=0)
    ts = torch.cat([ts, t_o], dim=0)
    oks = torch.cat([oks, torch.stack([ok_o, ok_o])], dim=0)

    up_n = None if up is None else torch.as_tensor(
        up, dtype=torch.float32, device=dev)

    def above(R, t):
        # Camera centre −Rᵀt (zero-centred obj frame) on the +up side.
        rt = (R * t[..., :, None]).sum(-2)
        return (-rt * up_n).sum(-1) > 0.0

    if up_n is not None:
        oks = oks & above(Rs, ts)

    def msac(R, t):
        err = _reproj_err_normalized(R, t, obj, uv_n)
        return (torch.minimum(err, thr2) * vf[None, :]).sum(-1), err

    scores_err, err = msac(Rs, ts)
    inl = (err < thr2) & valid[None, :]
    scores_err = torch.where(oks, scores_err, torch.inf)
    best = scores_err.argmin()
    R_best, t_best = Rs[best], ts[best]
    inliers = inl[best]
    s_best = scores_err[best]

    # Refit on the inlier set (EPnP exact + planar + both POS candidates);
    # a refit must improve the truncated error to replace the best.
    w_inl = inliers.to(torch.float32)
    R_o2, t_o2, ok_o2 = ortho_pose_candidates(obj, uv_n, w_inl)
    fits = [epnp(obj, uv_n, w_inl), planar_pose(obj, uv_n, w_inl),
            (R_o2[0], t_o2[0], ok_o2), (R_o2[1], t_o2[1], ok_o2)]
    R_fits = torch.stack([f[0] for f in fits])
    t_fits = torch.stack([f[1] for f in fits])
    ok_fits = torch.stack([f[2] for f in fits])
    if up_n is not None:
        ok_fits = ok_fits & above(R_fits, t_fits)
    s_fits, _ = msac(R_fits, t_fits)
    for i in range(len(fits)):
        use_fit = ok_fits[i] & (s_fits[i] < s_best)
        R_best = torch.where(use_fit, R_fits[i], R_best)
        t_best = torch.where(use_fit, t_fits[i], t_best)
        s_best = torch.where(use_fit, s_fits[i], s_best)

    rvec0 = matrix_to_rodrigues(R_best)
    rvec_gn, tvec_gn = _gn_refine_pose(rvec0, t_best, obj, uv_n, w_inl,
                                       config.refine_iters)
    s_gn, _ = msac(rodrigues_to_matrix(rvec_gn)[None], tvec_gn[None])
    s_pre, _ = msac(R_best[None], t_best[None])
    keep_gn = torch.isfinite(rvec_gn).all() & torch.isfinite(tvec_gn).all() \
        & (s_gn[0] <= s_pre[0])
    if up_n is not None:
        keep_gn = keep_gn & above(rodrigues_to_matrix(rvec_gn), tvec_gn)
    rvec = torch.where(keep_gn, rvec_gn, rvec0)
    tvec = torch.where(keep_gn, tvec_gn, t_best)
    R_final = rodrigues_to_matrix(rvec)
    inliers = (_reproj_err_normalized(R_final, tvec, obj, uv_n) < thr2) & valid
    num_inl = inliers.sum(dtype=torch.int32)
    # ≥ 4 points and a consensus of ≥ 5% of the valid correspondences.
    min_consensus = torch.clamp(
        (0.05 * num_valid.to(torch.float32)).to(torch.int32), min=4)
    ok = (num_valid >= 4) & (num_inl >= min_consensus) \
        & torch.isfinite(rvec).all() & torch.isfinite(tvec).all()
    if up_n is not None:
        ok = ok & above(R_final, tvec)
    tvec = scale * tvec - R_final @ c_obj
    return PoseSolution(rvec=rvec, tvec=tvec, inliers=inliers,
                        num_inliers=num_inl, ok=ok)


def solve_pnp(corr: Correspondences, camera: CameraModel,
              refine_iters: int = 10) -> PoseSolution:
    """Non-robust PnP (every valid point taken as an inlier): the better of
    EPnP and the planar solver by weighted reprojection error, polished
    by Gauss-Newton, in the zero-centroid / unit-RMS world frame of
    solve_pnp_ransac."""
    obj = corr.obj_points.to(torch.float32)
    pix = corr.img_points.to(torch.float32)
    uv_n = pixels_to_normalized(pix, camera)
    w = corr.valid.to(torch.float32)
    nw = w.sum().clamp(min=1.0)
    c_obj = (obj * w[:, None]).sum(0) / nw
    centered = (obj - c_obj) * w[:, None]
    scale = torch.sqrt((centered * centered).sum() / nw).clamp(min=1e-12)
    obj = (obj - c_obj) / scale
    R, t, ok = epnp(obj, uv_n, w)
    Rp, tp, okp = planar_pose(obj, uv_n, w)

    def werr(R, t):
        e = _reproj_err_normalized(R, t, obj, uv_n)
        return (torch.where(torch.isfinite(e), e, 1e12) * w).sum()

    use_p = okp & ((~ok) | (werr(Rp, tp) < werr(R, t)))
    R = torch.where(use_p, Rp, R)
    t = torch.where(use_p, tp, t)
    ok = ok | okp
    rvec, tvec = _gn_refine_pose(matrix_to_rodrigues(R), t, obj, uv_n, w,
                                 refine_iters)
    tvec = scale * tvec - rodrigues_to_matrix(rvec) @ c_obj
    num_valid = corr.valid.sum(dtype=torch.int32)
    return PoseSolution(rvec=rvec, tvec=tvec, inliers=corr.valid,
                        num_inliers=num_valid,
                        ok=ok & (num_valid >= 4) & torch.isfinite(rvec).all())
