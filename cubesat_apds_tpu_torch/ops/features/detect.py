"""AKAZE keypoint detection: scale-normalized det-Hessian + NMS + top-K
(port of ops/features/detect.py).

Every acceptance rule (strict 3×3 peak, threshold, border, cross-level
dominance, sub-pixel refinement within 1 px) is a per-pixel predicate on
dense maps, followed by ONE exact global top-K over all levels and the
canonical (response DESC, map position ASC) re-sort, as in the JAX
package with ``detect_topk="exact"``. A batched scale space ([B, h, w]
levels) detects in every image at once; maps, top-K and sort act on each
image alone.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cubesat_apds_tpu_torch.core.config import AkazeConfig
from cubesat_apds_tpu_torch.core.types import Keypoints, select
from cubesat_apds_tpu_torch.ops.features.scale_space import ScaleSpace
from cubesat_apds_tpu_torch.ops.resample import separable_conv2d

_NEG = float(torch.finfo(torch.float32).min)


def _deriv_kernels(scale: int):
    """Scaled Scharr-family kernels with taps at {−scale, 0, +scale}."""
    ksize = 3 + 2 * (scale - 1)
    w = 10.0 / 3.0
    norm = 1.0 / (2.0 * scale * (w + 2.0))
    smooth = np.zeros(ksize, np.float32)
    smooth[0] = norm
    smooth[ksize // 2] = w * norm
    smooth[-1] = norm
    deriv = np.zeros(ksize, np.float32)
    deriv[0] = -1.0
    deriv[-1] = 1.0
    return smooth, deriv


def scharr_scale(img, scale: int, dx: int, dy: int):
    """Scaled Scharr derivative (order 1 in one axis, smoothing in the other)."""
    smooth, deriv = _deriv_kernels(scale)
    row = deriv if dy else smooth
    col = deriv if dx else smooth
    return separable_conv2d(img, row, col, pad_mode="reflect")


def det_hessian_response(Lsmooth, sigma_size: int):
    """σ⁴-normalized det-Hessian of one level, plus (Lx, Ly)·s."""
    s = sigma_size
    lx = scharr_scale(Lsmooth, s, 1, 0)
    ly = scharr_scale(Lsmooth, s, 0, 1)
    lxx = scharr_scale(lx, s, 1, 0) * float(s * s)
    lyy = scharr_scale(ly, s, 0, 1) * float(s * s)
    lxy = scharr_scale(lx, s, 0, 1) * float(s * s)
    ldet = lxx * lyy - lxy * lxy
    return ldet, lx * float(s), ly * float(s)


def _shift2d(x, dy: int, dx: int):
    """Edge-clamped static shift of [B, H, W]."""
    h, w = x.shape[-2:]
    xp = F.pad(x[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    return xp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _maxpool_1d(x, r: int, axis: int):
    n = x.shape[axis]
    pads = (r, r) if axis == x.dim() - 1 else (0, 0, r, r)
    xp = F.pad(x, pads, value=_NEG)
    out = None
    for k in range(2 * r + 1):
        t = xp.narrow(axis, k, n)
        out = t if out is None else torch.maximum(out, t)
    return out


def _maxpool3x3(x):
    return _maxpool_1d(_maxpool_1d(x, 1, x.dim() - 2), 1, x.dim() - 1)


def _maxpool_radius(x, r: int):
    if r <= 0:
        return x
    return _maxpool_1d(_maxpool_1d(x, r, x.dim() - 2), r, x.dim() - 1)


def _resample_to(x, shape_hw):
    """Nearest-resample [B, h, w] response maps to an adjacent octave's
    grid."""
    b, h, w = x.shape
    th, tw = shape_hw
    if (h, w) == (th, tw):
        return x
    if th <= h:   # downsample by 2: max of 2×2 (conservative)
        x = x[:, : th * 2, : tw * 2].reshape(b, th, 2, tw, 2)
        return x.amax(dim=(2, 4))
    x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)[:, :th, :tw]
    if x.shape[1:] != (th, tw):
        x = F.pad(x[:, None], (0, tw - x.shape[2], 0, th - x.shape[1]),
                  mode="replicate")[:, 0]
    return x


def _stable_sort_canonical(vals, idx):
    """Per row, the permutation ordering by (vals DESC, idx ASC): torch
    has no lexsort, so sort by the secondary key, then stably by the
    primary."""
    p1 = torch.sort(idx, stable=True).indices
    p2 = torch.sort(-vals.gather(-1, p1), stable=True).indices
    return p1.gather(-1, p2)


def detect_keypoints(ss: ScaleSpace, config: AkazeConfig = AkazeConfig(),
                     capacity: int | None = None
                     ) -> Tuple[Keypoints, List[torch.Tensor],
                                List[torch.Tensor]]:
    """Scale-space extrema → fixed-capacity Keypoints (+ per-level Lx, Ly).

    class_id is the evolution level index. The top-K is exact
    (`torch.topk`) whatever `config.detect_topk` says. A batched scale
    space gives Keypoints [B, capacity] and per-level [B, h, w] maps.
    """
    capacity = capacity or config.capacity
    meta = ss.meta
    n_levels = len(meta)
    dev = ss.Lt[0].device
    batched = ss.Lt[0].dim() == 3
    lsmooth = ss.Lsmooth if batched else [a[None] for a in ss.Lsmooth]
    bsz = lsmooth[0].shape[0]

    ldet_list, lx_list, ly_list = [], [], []
    for i in range(n_levels):
        ldet, lx, ly = det_hessian_response(lsmooth[i], meta[i].sigma_size)
        ldet_list.append(ldet)
        lx_list.append(lx)
        ly_list.append(ly)

    masked_maps, sub_maps = [], []
    thr = torch.tensor(config.threshold, dtype=torch.float32, device=dev)
    for i in range(n_levels):
        ldet = ldet_list[i]
        h, w = ldet.shape[1:]
        m = meta[i]
        is_peak = ldet >= _maxpool3x3(ldet)
        above = ldet > thr
        r = max(int(round(m.esigma * config.derivative_factor / m.ratio)), 1)
        dominated = torch.zeros_like(ldet, dtype=torch.bool)
        for j in (i - 1, i + 1):
            if j < 0 or j >= n_levels:
                continue
            other_max = _maxpool_radius(_resample_to(ldet_list[j], (h, w)), r)
            if j < i:   # the earlier level wins ties
                dominated = dominated | (other_max >= ldet)
            else:
                dominated = dominated | (other_max > ldet)
        ys = torch.arange(h, device=dev)[:, None]
        xs = torch.arange(w, device=dev)[None, :]
        b = m.border
        inside = (xs >= b) & (xs < w - b) & (ys >= b) & (ys < h - b)

        def sh(dy, dx):
            return _shift2d(ldet, dy, dx)

        dx1 = 0.5 * (sh(0, 1) - sh(0, -1))
        dy1 = 0.5 * (sh(1, 0) - sh(-1, 0))
        dxx = sh(0, 1) + sh(0, -1) - 2.0 * ldet
        dyy = sh(1, 0) + sh(-1, 0) - 2.0 * ldet
        dxy = 0.25 * (sh(1, 1) + sh(-1, -1) - sh(1, -1) - sh(-1, 1))
        det = dxx * dyy - dxy * dxy
        det_safe = torch.where(det.abs() < 1e-12, 1e-12, det)
        offx_map = -(dyy * dx1 - dxy * dy1) / det_safe
        offy_map = -(dxx * dy1 - dxy * dx1) / det_safe
        refine_ok = (offx_map.abs() <= 1.0) & (offy_map.abs() <= 1.0)

        keep = is_peak & above & inside & ~dominated & refine_ok & (ldet > 0)
        masked_maps.append(torch.where(keep, ldet, -torch.inf).reshape(bsz,
                                                                      -1))
        sub_maps.append(torch.stack([offx_map, offy_map],
                                    dim=-1).reshape(bsz, -1, 2))

    all_vals = torch.cat(masked_maps, dim=1)
    all_sub = torch.cat(sub_maps, dim=1)
    p_total = all_vals.shape[1]
    k = min(capacity, p_total)
    top_vals, top_idx = torch.topk(all_vals, k)
    perm = _stable_sort_canonical(top_vals, top_idx)
    top_vals = top_vals.gather(1, perm)
    top_idx = top_idx.gather(1, perm)
    sel = all_sub.gather(1, top_idx[..., None].expand(-1, -1, 2))

    sizes = [ld.shape[1] * ld.shape[2] for ld in ldet_list]
    level_end = torch.tensor(np.cumsum(sizes), device=dev)
    sel_lvl = torch.bucketize(top_idx, level_end, right=True)
    level_off = torch.tensor(np.concatenate([[0], np.cumsum(sizes)[:-1]]),
                             device=dev)
    level_w = torch.tensor([ld.shape[2] for ld in ldet_list], device=dev)
    ratios = torch.tensor([m.ratio for m in meta], dtype=torch.float32,
                          device=dev)
    local = top_idx - level_off[sel_lvl]
    py = torch.div(local, level_w[sel_lvl], rounding_mode="floor")
    px = local - py * level_w[sel_lvl]
    ratio = ratios[sel_lvl]
    sel_x = (px.to(torch.float32) + sel[..., 0]) * ratio
    sel_y = (py.to(torch.float32) + sel[..., 1]) * ratio
    valid = torch.isfinite(top_vals)

    esigmas = torch.tensor([m.esigma for m in meta], dtype=torch.float32,
                           device=dev)
    octaves = torch.tensor([m.octave for m in meta], dtype=torch.int32,
                           device=dev)
    size = esigmas[sel_lvl] * config.derivative_factor
    xy = torch.stack([sel_x, sel_y], dim=-1)

    pad = capacity - k
    if pad:
        top_vals, size, valid, xy, sel_lvl = (
            torch.cat([t, t.new_zeros((bsz, pad) + t.shape[2:])], dim=1)
            for t in (top_vals, size, valid, xy, sel_lvl))

    # Invalid slots are zeroed at the source (their values are whatever
    # −inf ties the top-k kept, which differ between implementations).
    kps = Keypoints(
        xy=torch.where(valid[..., None], xy, 0.0),
        size=torch.where(valid, size, 0.0),
        angle=torch.zeros((bsz, capacity), dtype=torch.float32, device=dev),
        response=torch.where(valid, top_vals, 0.0),
        octave=torch.where(valid, octaves[sel_lvl],
                           0).to(torch.int32),
        class_id=torch.where(valid, sel_lvl, -1).to(torch.int32),
        valid=valid,
    )
    if not batched:
        kps = select(kps, 0)
        lx_list = [a[0] for a in lx_list]
        ly_list = [a[0] for a in ly_list]
    return kps, lx_list, ly_list
