"""AKAZE dominant-orientation assignment, batched over keypoints (port of
ops/features/orientation.py, exact mode).

Gaussian-weighted (Lx, Ly) on the static 109-point radius-6 disc (step =
keypoint scale), then 42 sliding 60° windows; the window with the largest
resultant vector gives the angle.

Angles come from `_atan2`, float64 atan2 rounded to float32: float32
atan2 on the CPU has a vector and a scalar path that differ in the last
bit, and which one an element takes depends on where it sits in the
tensor, so a keypoint's angle would depend on the batch around it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cubesat_apds_tpu_torch.ops.kernels.sample_kernel import (
    sample_patches_plain)

_DISC = np.array([(i, j) for i in range(-6, 7) for j in range(-6, 7)
                  if i * i + j * j < 36], np.int32)          # [109, 2]
_GAUSS_W = np.exp(-(_DISC[:, 0] ** 2 + _DISC[:, 1] ** 2) / (2.0 * 2.5 ** 2)
                  ).astype(np.float32)                        # σ = 2.5
_N_WINDOWS = 42
_WINDOW_STARTS = (np.arange(_N_WINDOWS) * 0.15).astype(np.float32)


def _fround(x):
    """OpenCV fRound: round half away from zero (positive domain here)."""
    return torch.floor(x + 0.5).to(torch.int32)


def _atan2(y, x):
    """float32 atan2 through float64: the same bits on every device and
    wherever the element sits in its tensor."""
    return torch.atan2(y.double(), x.double()).to(torch.float32)


def orientation_sample_coords(xy, size, class_id, octave):
    """Integer sample coordinates (iy, ix) [K, 109] of the orientation
    disc, in level coordinates (pre-clip)."""
    ratio = torch.exp2(octave.to(torch.float32))
    s = _fround(0.5 * size / ratio).to(torch.float32)
    xf = xy[:, 0] / ratio
    yf = xy[:, 1] / ratio
    disc = torch.as_tensor(_DISC, dtype=torch.float32, device=xy.device)
    ix = _fround(xf[:, None] + disc[None, :, 0] * s[:, None])
    iy = _fround(yf[:, None] + disc[None, :, 1] * s[:, None])
    return iy, ix


def gather_sampler(packed_stack, level_hw, lvl):
    """Plain point-gather sampler: (iy, ix) [K, S] → [K, S, C] f32."""
    return lambda iy, ix: sample_patches_plain(packed_stack, level_hw, lvl,
                                               iy, ix)


def compute_orientations(packed_stack, level_hw, xy, size, class_id,
                         octave, valid, sample_fn=None):
    """Dominant orientation per keypoint, angle [K] in [0, 2π).

    packed_stack: [L, H, W, 4] per-level stack (Lt, Lx, Ly, 0);
    level_hw: [L, 2] true (h, w) per level; sample_fn overrides the
    sampling backend (kernel B); defaults to the plain gather.
    """
    lvl = class_id.clamp(0, packed_stack.shape[0] - 1)
    iy, ix = orientation_sample_coords(xy, size, class_id, octave)
    if sample_fn is None:
        sample_fn = gather_sampler(packed_stack, level_hw, lvl)
    vals = sample_fn(iy, ix)                                  # [K, S, C]
    weights = torch.as_tensor(_GAUSS_W, device=xy.device)
    res_x = vals[..., 1] * weights[None, :]
    res_y = vals[..., 2] * weights[None, :]

    two_pi = 2.0 * math.pi
    ang = _atan2(res_y, res_x)
    ang = torch.where(ang < 0, ang + two_pi, ang)              # [K, 109]
    starts = torch.as_tensor(_WINDOW_STARTS, device=xy.device)
    rel = ang[:, None, :] - starts[None, :, None]               # [K, 42, 109]
    rel = torch.where(rel < 0, rel + two_pi, rel)
    in_win = rel < (math.pi / 3.0)

    sum_x = torch.where(in_win, res_x[:, None, :], 0.0).sum(-1)
    sum_y = torch.where(in_win, res_y[:, None, :], 0.0).sum(-1)
    mag = sum_x * sum_x + sum_y * sum_y                         # [K, 42]
    best = mag.argmax(-1, keepdim=True)
    bx = sum_x.gather(-1, best)[:, 0]
    by = sum_y.gather(-1, best)[:, 0]
    angle = _atan2(by, bx)
    angle = torch.where(angle < 0, angle + two_pi, angle)
    return torch.where(valid, angle, 0.0)
