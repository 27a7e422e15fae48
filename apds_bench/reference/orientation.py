"""AKAZE dominant-orientation assignment, batched over keypoints (port of
ops/features/orientation.py).

Gaussian-weighted (Lx, Ly) on the static 109-point radius-6 disc (step =
keypoint scale; mode "fast": its 57-point checkerboard half), then 42
sliding 60° windows; the window with the largest resultant vector gives
the angle.

Every step gives the same bits on every device and wherever a keypoint
sits in its batch: angles come from `_atan2`, float64 atan2 rounded to
float32 (float32 atan2 on the CPU has a vector and a scalar path that
differ in the last bit, and CUDA's differs again), and the window sums
are `tree_sum`s, a fixed pairwise order of elementwise adds (a library
reduction sums in an order of its own on each device).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from apds_bench.reference.types_ import device_const
from apds_bench.reference.twins import (
    sample_patches_plain)

_DISC = np.array([(i, j) for i in range(-6, 7) for j in range(-6, 7)
                  if i * i + j * j < 36], np.int32)          # [109, 2]
_GAUSS_W = np.exp(-(_DISC[:, 0] ** 2 + _DISC[:, 1] ** 2) / (2.0 * 2.5 ** 2)
                  ).astype(np.float32)                        # σ = 2.5
# Fast mode: the checkerboard half of the disc, i + j even: 57 points (the
# JAX package's comments say 55; its selection is this one).
_FAST_SEL = (_DISC[:, 0] + _DISC[:, 1]) % 2 == 0
_DISC_FAST = _DISC[_FAST_SEL]                                 # [57, 2]
_GAUSS_W_FAST = _GAUSS_W[_FAST_SEL]
_N_WINDOWS = 42
_WINDOW_STARTS = (np.arange(_N_WINDOWS) * 0.15).astype(np.float32)


def _fround(x):
    """OpenCV fRound: round half away from zero (positive domain here)."""
    return torch.floor(x + 0.5).to(torch.int32)


def _atan2(y, x):
    """float32 atan2 through float64: the same bits on every device and
    wherever the element sits in its tensor."""
    return torch.atan2(y.double(), x.double()).to(torch.float32)


def tree_sum(x, dim: int = -1):
    """Sum over `dim` in a fixed pairwise order, zero-padded to a power of
    two: each level adds the upper half to the lower half elementwise, so
    the result is the same bits on every device."""
    dim = dim % x.dim()
    n = x.shape[dim]
    width = 1 << max(n - 1, 0).bit_length()
    if width > n:
        pad = [0, 0] * (x.dim() - 1 - dim) + [0, width - n]
        x = torch.nn.functional.pad(x, pad)
    while width > 1:
        width //= 2
        x = x.narrow(dim, 0, width) + x.narrow(dim, width, width)
    return x.squeeze(dim)


def orientation_sample_coords(xy, size, class_id, octave, mode="exact"):
    """Integer sample coordinates (iy, ix) [K, S] of the orientation
    disc (S = 109 exact, 57 fast), in level coordinates (pre-clip)."""
    ratio = torch.exp2(octave.to(torch.float32))
    s = _fround(0.5 * size / ratio).to(torch.float32)
    xf = xy[:, 0] / ratio
    yf = xy[:, 1] / ratio
    disc = device_const(_DISC_FAST if mode == "fast" else _DISC,
                        torch.float32, xy.device)
    ix = _fround(xf[:, None] + disc[None, :, 0] * s[:, None])
    iy = _fround(yf[:, None] + disc[None, :, 1] * s[:, None])
    return iy, ix


def gather_sampler(packed_stack, level_hw, lvl):
    """Plain point-gather sampler: (iy, ix) [K, S] → [K, S, C] f32."""
    return lambda iy, ix: sample_patches_plain(packed_stack, level_hw, lvl,
                                               iy, ix)


def compute_orientations(packed_stack, level_hw, xy, size, class_id,
                         octave, valid, sample_fn=None, mode="exact"):
    """Dominant orientation per keypoint, angle [K] in [0, 2π).

    packed_stack: [L, H, W, 4] per-level stack (Lt, Lx, Ly, 0);
    level_hw: [L, 2] true (h, w) per level; sample_fn overrides the
    sampling backend (kernel B); defaults to the plain gather.
    mode="fast" samples the 57-point checkerboard half of the disc.
    """
    lvl = class_id.clamp(0, packed_stack.shape[0] - 1)
    iy, ix = orientation_sample_coords(xy, size, class_id, octave, mode)
    if sample_fn is None:
        sample_fn = gather_sampler(packed_stack, level_hw, lvl)
    vals = sample_fn(iy, ix)                                  # [K, S, C]
    weights = device_const(_GAUSS_W_FAST if mode == "fast" else _GAUSS_W,
                           torch.float32, xy.device)
    res_x = vals[..., 1] * weights[None, :]
    res_y = vals[..., 2] * weights[None, :]

    two_pi = 2.0 * math.pi
    ang = _atan2(res_y, res_x)
    ang = torch.where(ang < 0, ang + two_pi, ang)              # [K, S]
    starts = device_const(_WINDOW_STARTS, torch.float32, xy.device)
    rel = ang[:, None, :] - starts[None, :, None]               # [K, 42, S]
    rel = torch.where(rel < 0, rel + two_pi, rel)
    in_win = rel < (math.pi / 3.0)

    sum_x = tree_sum(torch.where(in_win, res_x[:, None, :], 0.0))
    sum_y = tree_sum(torch.where(in_win, res_y[:, None, :], 0.0))
    mag = sum_x * sum_x + sum_y * sum_y                         # [K, 42]
    best = mag.argmax(-1, keepdim=True)
    bx = sum_x.gather(-1, best)[:, 0]
    by = sum_y.gather(-1, best)[:, 0]
    angle = _atan2(by, bx)
    angle = torch.where(angle < 0, angle + two_pi, angle)
    return torch.where(valid, angle, 0.0)
