"""Plain PyTorch forms of the port's four hand-written kernels, as the
reference computes them.

- the FED cycle (kernel A): explicit steps, one at a time;
- the patch sampler (kernel B): one flat gather over the level stack;
- the Procrustes rotation: an SVD in float64, R rounded to float32 (the
  port's kernel runs a float64 Jacobi SVD and rounds the same way);
- the kNN-2 (kernel 4) is `match.knn2_blockwise`, the streaming top-2
  over DB blocks.
"""

from __future__ import annotations

import numpy as np
import torch



def _shift(x, dy: int, dx: int):
    """Edge-clamped shift of [..., H, W]: out[i, j] = x[clamp(i+dy), clamp(j+dx)]."""
    if dy == 1:
        return torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)
    if dy == -1:
        return torch.cat([x[..., :1, :], x[..., :-1, :]], dim=-2)
    if dx == 1:
        return torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    return torch.cat([x[..., :1], x[..., :-1]], dim=-1)


def nld_step(L, g, tau: float):
    """One explicit step L ← L + τ/2 · Σ₄ (g + g_q)(L_q − L), in the term
    order (right, left, down, up)."""
    contrib = (
        (g + _shift(g, 0, 1)) * (_shift(L, 0, 1) - L)
        + (g + _shift(g, 0, -1)) * (_shift(L, 0, -1) - L)
        + (g + _shift(g, 1, 0)) * (_shift(L, 1, 0) - L)
        + (g + _shift(g, -1, 0)) * (_shift(L, -1, 0) - L)
    )
    return L + (0.5 * float(tau)) * contrib


def fed_cycle(L, g, taus):
    """A full FED cycle, one step at a time, on [..., H, W]."""
    for tau in np.asarray(taus, np.float32):
        L = nld_step(L, g, tau)
    return L


def fed_cycle_fused(L, g, taus, batched: bool = False):
    """`fed_cycle` on any device (the name the scale space calls)."""
    return fed_cycle(L, g, taus)


def sample_patches_plain(packed, level_hw, lvl, iy, ix):
    """One flat gather over the stack. Levels and level sizes are clamped
    into the stack."""
    L, H, W, C = packed.shape
    lvl = lvl.long().clamp(0, L - 1)
    hs = level_hw[lvl, 0][:, None].to(iy.dtype).clamp(1, H)
    ws = level_hw[lvl, 1][:, None].to(ix.dtype).clamp(1, W)
    iy_c = torch.minimum(iy.clamp(min=0), hs - 1)
    ix_c = torch.minimum(ix.clamp(min=0), ws - 1)
    lin = (lvl[:, None] * H + iy_c) * W + ix_c
    return packed.reshape(L * H * W, C)[lin].to(torch.float32)


def patch_sampler(packed, level_hw, lvl):
    """sample_fn(iy, ix) → [K, S, 4] f32 for keypoints on levels `lvl`. A
    batch — packed [B, L, H, W, 4], lvl [B, n] — samples its B·n
    keypoints, image by image, with iy, ix [B·n, S]."""
    if packed.dim() == 5:
        b, n_lvl = packed.shape[:2]
        offs = torch.arange(b, device=lvl.device)[:, None] * n_lvl
        packed = packed.reshape((b * n_lvl,) + packed.shape[2:])
        level_hw = level_hw.repeat(b, 1)
        lvl = (lvl + offs).reshape(-1)
    return lambda iy, ix: sample_patches_plain(packed, level_hw, lvl, iy, ix)


def procrustes_rotation(S):
    """R [..., 3, 3] float32, the rotation nearest to each S, from a
    float64 SVD: R = U·diag(1, 1, sign det(U Vᵀ))·Vᵀ; NaN where S is not
    finite."""
    finite = torch.isfinite(S).flatten(-2).all(-1)[..., None, None]
    s64 = S.to(torch.float64)
    eye = torch.eye(3, dtype=torch.float64, device=S.device)
    U, _, Vt = torch.linalg.svd(torch.where(finite, s64, eye))
    d = torch.sign(torch.linalg.det(U @ Vt))
    one = torch.ones_like(d)
    D = torch.diag_embed(torch.stack([one, one, d], dim=-1))
    R = (U @ D @ Vt).to(torch.float32)
    return torch.where(finite, R, torch.nan)
