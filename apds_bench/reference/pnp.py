"""PnP-RANSAC and plain PnP: 6-DoF pose from 3D–2D correspondences (port
of ops/geometry/pnp.py: solve_pnp_ransac, solve_pnp).

A fixed batch of minimal samples, each solved by EPnP and the planar
solver, plus the two global weak-perspective candidates; the optional
up-gate, MSAC (truncated-error) scoring, a refit on the winner's inliers,
a monotone Gauss-Newton polish and the 5% consensus floor — as in the
JAX package. Draws come from a CPU `torch.Generator` seeded with
`config.seed` (uploaded once per seed, shape and device), or from a
caller-given index tensor `r`.

`solve_pnp_ransac` takes correspondences with leading batch dimensions:
B frames run as one pass (the JAX package's vmap), the Gauss-Newton
polish as `jacfwd` under `torch.func.vmap` over the frames. A lone frame
is the case with no leading dimension.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from apds_bench.reference.camera import pixels_to_normalized
from apds_bench.reference.config import PnPConfig
from apds_bench.reference.types_ import (
    CameraModel, Correspondences, PoseSolution, fold_lead, pick, take_rows,
    unfold_lead)
from apds_bench.reference.epnp import epnp
from apds_bench.reference.homography import (
    draw_indices, draws_per_frame)
from apds_bench.reference.linalg_small import (
    bmm, cholesky_solve, highest_matmul_precision)
from apds_bench.reference.planar import (
    ortho_pose_candidates, planar_pose)
from apds_bench.reference.rodrigues import (
    matrix_to_rodrigues, rodrigues_to_matrix)


def _apply_pose(R, t, obj):
    """cam = R·obj + t by elementwise multiply-add: R [..., 3, 3], t
    [..., 3] and obj [..., N, 3] (leading dimensions broadcast) →
    [..., N, 3] (no matrix unit: pose scores must not depend on a matmul
    precision mode)."""
    cam = (R[..., None, :, 0] * obj[..., :, 0:1]
           + R[..., None, :, 1] * obj[..., :, 1:2]
           + R[..., None, :, 2] * obj[..., :, 2:3])
    return cam + t[..., None, :]


def _reproj_err_normalized(R, t, obj, uv_n):
    """Squared reprojection error in normalized coords [..., N]; points
    behind the camera score inf."""
    cam = _apply_pose(R, t, obj)
    z = cam[..., 2]
    zs = torch.where(z.abs() < 1e-12, 1e-12, z)
    err = ((cam[..., :2] / zs[..., None] - uv_n) ** 2).sum(-1)
    return torch.where(z <= 1e-6, torch.inf, err)


def _gn_residuals(params, obj, uv_n, weights):
    """One frame's weighted residuals [2N] at params = (rvec, tvec)."""
    R = rodrigues_to_matrix(params[:3])
    cam = _apply_pose(R, params[3:], obj)
    z = torch.where(cam[:, 2].abs() < 1e-12, 1e-12, cam[:, 2])
    return ((cam[:, :2] / z[:, None] - uv_n) * weights[:, None]).reshape(-1)


def _gn_refine_pose(rvec, tvec, obj, uv_n, weights, iters: int):
    """Gauss-Newton on (rvec, tvec) of a batch of frames ([B, 3], obj
    [B, N, 3], uv_n [B, N, 2], weights [B, N]); a frame's step is kept
    only when it lowers its weighted residual norm. The Jacobian is the
    JAX package's forward mode (`jacfwd`), vmapped over the frames."""
    residuals = vmap(_gn_residuals)
    jacobian = vmap(jacfwd(_gn_residuals))
    params = torch.cat([rvec, tvec], dim=-1)
    for _ in range(iters):
        r = residuals(params, obj, uv_n, weights)           # [B, 2N]
        J = jacobian(params, obj, uv_n, weights)            # [B, 2N, 6]
        Jt = J.transpose(-1, -2)
        delta = cholesky_solve(bmm(Jt, J), bmm(Jt, r[..., None])[..., 0],
                               damp=1e-9)
        new = params - delta
        ok = torch.isfinite(new).all(-1) & (
            (residuals(new, obj, uv_n, weights) ** 2).sum(-1)
            < (r ** 2).sum(-1))
        params = torch.where(ok[:, None], new, params)
    return params[:, :3], params[:, 3:]


def _recenter(obj, vf):
    """Zero-centroid / unit-RMS world frame of [B, N, 3] over the weights
    vf [B, N]: (obj in that frame, centroid [B, 3], scale [B])."""
    nvf = vf.sum(-1).clamp(min=1.0)
    c_obj = (obj * vf[..., None]).sum(-2) / nvf[:, None]
    centered = (obj - c_obj[:, None]) * vf[..., None]
    scale = torch.sqrt((centered * centered).sum((-2, -1)) / nvf).clamp(
        min=1e-12)
    return (obj - c_obj[:, None]) / scale[:, None, None], c_obj, scale


@highest_matmul_precision
def solve_pnp_ransac(corr: Correspondences, camera: CameraModel,
                     config: PnPConfig = PnPConfig(), key=None, up=None,
                     *, r=None) -> PoseSolution:
    """RANSAC-EPnP over fixed-capacity correspondences.

    corr.obj_points [..., N, 3], corr.img_points [..., N, 2] pixels,
    corr.valid [..., N]: leading dimensions are a batch of frames, solved
    in one pass; none is one frame. `up` ([3] or [..., 3] world-frame unit
    vector, optional): the camera centre must lie on its + side for a
    hypothesis to be selected. `key`: the seed of the CPU generator that
    makes the draws (an int); None draws from `config.seed`, as the JAX
    package's PRNGKey(config.seed) default. `r`: optional
    [H, sample_size] (every frame) or [..., H, sample_size] (per frame)
    indices into the valid entries replacing the draws.
    """
    obj = corr.obj_points.to(torch.float32)
    lead = obj.shape[:-2]
    dev = obj.device
    up_n = None if up is None else torch.broadcast_to(
        torch.as_tensor(up, dtype=torch.float32, device=dev), lead + (3,))
    obj, pix, valid, up_n = fold_lead(
        (obj, corr.img_points.to(torch.float32), corr.valid, up_n), len(lead))
    seed = config.seed if key is None else int(key)
    return unfold_lead(_pnp_batch(obj, pix, valid, camera, config, up_n,
                                  seed, r), lead)


def _pnp_batch(obj, pix, valid, camera: CameraModel, config: PnPConfig,
               up_n, seed: int, r) -> PoseSolution:
    """solve_pnp_ransac on [B, N] correspondences (up_n [B, 3] or None)."""
    b = valid.shape[0]
    dev = obj.device
    uv_n = pixels_to_normalized(pix, camera)
    vf = valid.to(torch.float32)
    num_valid = valid.sum(-1)                                # [B]

    # Zero-centroid / unit-RMS world frame; t maps back exactly below.
    obj, c_obj, scale = _recenter(obj, vf)

    f_avg = 0.5 * (camera.K[0, 0] + camera.K[1, 1])
    thr2 = (config.reproj_threshold / f_avg) ** 2

    nh, ns = config.num_hypotheses, config.sample_size
    valid_first = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)
    r = (draw_indices(num_valid, (nh, ns), seed, dev) if r is None
         else draws_per_frame(r, b, nh, ns, dev, torch.int64))
    samp = take_rows(valid_first, r)                         # [B, H, S]
    obj_s, uv_s = take_rows(obj, samp), take_rows(uv_n, samp)
    R, t, ok = epnp(obj_s, uv_s, fast=True)
    Rp, tp, okp = planar_pose(obj_s, uv_s)
    # Per hypothesis (EPnP, planar), interleaved as the JAX package's
    # vmap + reshape lays them out (argmin ties pick the first).
    Rs = torch.stack([R, Rp], dim=2).reshape(b, -1, 3, 3)
    ts = torch.stack([t, tp], dim=2).reshape(b, -1, 3)
    oks = torch.stack([ok, okp], dim=2).reshape(b, -1)

    R_o, t_o, ok_o = ortho_pose_candidates(obj, uv_n, vf)
    Rs = torch.cat([Rs, R_o], dim=1)
    ts = torch.cat([ts, t_o], dim=1)
    oks = torch.cat([oks, torch.stack([ok_o, ok_o], dim=-1)], dim=1)

    def above(R, t):
        # Camera centre −Rᵀt (zero-centred obj frame) on the +up side.
        rt = (R * t[..., :, None]).sum(-2)
        u = up_n.reshape((b,) + (1,) * (rt.dim() - 2) + (3,))
        return (-rt * u).sum(-1) > 0.0

    if up_n is not None:
        oks = oks & above(Rs, ts)

    def msac(R, t):
        # R [B, C, 3, 3], t [B, C, 3]: scores [B, C], errors [B, C, N].
        err = _reproj_err_normalized(R, t, obj[:, None], uv_n[:, None])
        return (torch.minimum(err, thr2) * vf[:, None, :]).sum(-1), err

    scores_err, err = msac(Rs, ts)
    inl = (err < thr2) & valid[:, None, :]
    scores_err = torch.where(oks, scores_err, torch.inf)
    best = scores_err.argmin(-1)
    R_best, t_best = pick(Rs, best), pick(ts, best)
    inliers = pick(inl, best)
    s_best = pick(scores_err, best)

    # Refit on the inlier set (EPnP exact + planar + both POS candidates);
    # a refit must improve the truncated error to replace the best.
    w_inl = inliers.to(torch.float32)
    R_o2, t_o2, ok_o2 = ortho_pose_candidates(obj, uv_n, w_inl)
    fits = [epnp(obj, uv_n, w_inl), planar_pose(obj, uv_n, w_inl),
            (R_o2[:, 0], t_o2[:, 0], ok_o2), (R_o2[:, 1], t_o2[:, 1], ok_o2)]
    R_fits = torch.stack([f[0] for f in fits], dim=1)
    t_fits = torch.stack([f[1] for f in fits], dim=1)
    ok_fits = torch.stack([f[2] for f in fits], dim=1)
    if up_n is not None:
        ok_fits = ok_fits & above(R_fits, t_fits)
    s_fits, _ = msac(R_fits, t_fits)
    for i in range(len(fits)):
        use_fit = ok_fits[:, i] & (s_fits[:, i] < s_best)
        R_best = torch.where(use_fit[:, None, None], R_fits[:, i], R_best)
        t_best = torch.where(use_fit[:, None], t_fits[:, i], t_best)
        s_best = torch.where(use_fit, s_fits[:, i], s_best)

    rvec0 = matrix_to_rodrigues(R_best)
    rvec_gn, tvec_gn = _gn_refine_pose(rvec0, t_best, obj, uv_n, w_inl,
                                       config.refine_iters)
    R_gn = rodrigues_to_matrix(rvec_gn)
    s_gn, _ = msac(R_gn[:, None], tvec_gn[:, None])
    s_pre, _ = msac(R_best[:, None], t_best[:, None])
    keep_gn = (torch.isfinite(rvec_gn).all(-1)
               & torch.isfinite(tvec_gn).all(-1) & (s_gn[:, 0] <= s_pre[:, 0]))
    if up_n is not None:
        keep_gn = keep_gn & above(R_gn, tvec_gn)
    rvec = torch.where(keep_gn[:, None], rvec_gn, rvec0)
    tvec = torch.where(keep_gn[:, None], tvec_gn, t_best)
    R_final = rodrigues_to_matrix(rvec)
    inliers = (_reproj_err_normalized(R_final, tvec, obj, uv_n) < thr2) & valid
    num_inl = inliers.sum(-1, dtype=torch.int32)
    # ≥ 4 points and a consensus of ≥ 5% of the valid correspondences.
    min_consensus = torch.clamp(
        (0.05 * num_valid.to(torch.float32)).to(torch.int32), min=4)
    ok = ((num_valid >= 4) & (num_inl >= min_consensus)
          & torch.isfinite(rvec).all(-1) & torch.isfinite(tvec).all(-1))
    if up_n is not None:
        ok = ok & above(R_final, tvec)
    tvec = scale[:, None] * tvec - bmm(R_final, c_obj[..., None])[..., 0]
    return PoseSolution(rvec=rvec, tvec=tvec, inliers=inliers,
                        num_inliers=num_inl, ok=ok)


