"""Full MLDB binary descriptor (486 bits / 61 bytes), batched (port of
ops/features/mldb.py).

A (2·pattern)² patch around the keypoint, rotated by its angle and
sampled at step = keypoint scale (441 nearest-neighbour samples); 2×2,
3×3 and 4×4 grids of cell means of (intensity, rotated ∂x, rotated ∂y);
every cell pair compared per channel → 486 bits, LSB-first packed.

The approximate modes read each grid's cells from a blur-matched stack
instead: "fast" one sample per cell (29 a keypoint), "hybrid" sub×sub
weighted subcell samples per cell placed in the rotated frame (116 at
sub = 2, 261 at sub = 3). Each grid's samples come from its own stack of
L levels through one sampler call (kernel B on the card); the bit layout
is exact mode's.

The rotation's cos and sin are float64 rounded to float32 and the cell
means `tree_sum`s (the hybrid subcell sums a fixed sequential order), so
a descriptor is the same bits on every device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from apds_bench.reference.types_ import device_const
from apds_bench.reference.match import pack_bits

_PATTERN = 10  # descriptor_pattern_size default


def _grid_geometry(pattern: int = _PATTERN):
    """Static (offsets [S,2], per-grid averaging matrices, pair indices).

    Offsets enumerate every integer (k, l) the three grids touch. Grid
    level g has cells indexed row-major over i (outer) then j (inner).
    """
    size_mult = [1.0, 2.0 / 3.0, 1.0 / 2.0]
    span = np.arange(-pattern, pattern + 1, dtype=np.int32)
    offsets = np.array([(k, l) for k in span for l in span], np.int32)  # [S,2]
    off_index = {(int(k), int(l)): n for n, (k, l) in enumerate(offsets)}

    avg_mats, pair_idx = [], []
    for g in range(3):
        step = int(np.ceil(pattern * size_mult[g]))
        cell_starts = list(range(-pattern, pattern, step))
        n_side = len(cell_starts)
        n_cells = n_side * n_side
        W = np.zeros((n_cells, offsets.shape[0]), np.float32)
        c = 0
        for i in cell_starts:
            for j in cell_starts:
                members = [(k, l) for k in range(i, i + step)
                           for l in range(j, j + step)]
                for k, l in members:
                    W[c, off_index[(k, l)]] = 1.0 / len(members)
                c += 1
        avg_mats.append(W)
        pairs = np.array([(i, j) for i in range(n_cells)
                          for j in range(i + 1, n_cells)], np.int32)
        pair_idx.append(pairs)
    return offsets, avg_mats, pair_idx


_OFFSETS, _AVG_MATS, _PAIR_IDX = _grid_geometry()


def _fround(x):
    return torch.floor(x + 0.5).to(torch.int32)


def _cos_sin(angle):
    """cos and sin of float32 angles [K] → [K, 1] each, through float64
    (float32 sin and cos differ in the last bit between devices)."""
    a = angle.double()[:, None]
    return torch.cos(a).to(torch.float32), torch.sin(a).to(torch.float32)


def mldb_sample_coords(xy, size, angle, class_id, octave):
    """Rotated integer sample coordinates (iy, ix) [K, 441] of the MLDB
    pattern, in level coordinates (pre-clip)."""
    ratio = torch.exp2(octave.to(torch.float32))
    s = _fround(0.5 * size / ratio).to(torch.float32)
    xf = xy[:, 0] / ratio
    yf = xy[:, 1] / ratio
    co, si = _cos_sin(angle)
    offs = device_const(_OFFSETS, torch.float32, xy.device)
    k_off = offs[:, 0][None, :]
    l_off = offs[:, 1][None, :]
    sample_x = xf[:, None] + s[:, None] * (k_off * co - l_off * si)
    sample_y = yf[:, None] + s[:, None] * (k_off * si + l_off * co)
    return _fround(sample_y), _fround(sample_x)


def mldb_descriptors(packed_stack, level_hw,
                     xy, size, angle, class_id, octave, valid,
                     sample_fn=None):
    """Packed MLDB descriptors [K, 61] uint8 for all keypoints at once.

    packed_stack: [L, H, W, 4] per-level stack (Lt, Lx, Ly, 0);
    sample_fn overrides the sampling backend (kernel B); defaults to the
    plain gather.
    """
    from apds_bench.reference.orientation import gather_sampler

    K = xy.shape[0]
    dev = xy.device
    lvl = class_id.clamp(0, packed_stack.shape[0] - 1)
    co, si = _cos_sin(angle)
    iy, ix = mldb_sample_coords(xy, size, angle, class_id, octave)
    if sample_fn is None:
        sample_fn = gather_sampler(packed_stack, level_hw, lvl)
    vals = sample_fn(iy, ix)                                 # [K, S, C]
    di = vals[..., 0]
    rx = vals[..., 1]
    ry = vals[..., 2]
    dx = rx * co + ry * si
    dy = -rx * si + ry * co
    samples = torch.stack([di, dx, dy], dim=-1)              # [K, S, 3]

    bit_groups = []
    for g in range(3):
        cells = _cell_means(samples, g)                      # [K, C, 3]
        pairs = device_const(_PAIR_IDX[g], torch.long, dev)
        bits = cells[:, pairs[:, 0], :] > cells[:, pairs[:, 1], :]
        bit_groups.append(bits.transpose(-1, -2).reshape(K, -1))
    desc = pack_bits(torch.cat(bit_groups, dim=-1))          # [K, 61]
    return torch.where(valid[:, None], desc, torch.zeros_like(desc))


def _cell_means(samples, g: int, pattern: int = _PATTERN):
    """Grid g's cell means [K, n², 3] — the product with _AVG_MATS[g],
    computed as tree sums of w·x over the step×step blocks of the
    [K, 2p+1, 2p+1, 3] sample grid (cells from −p, row-major), so no
    matrix unit (nor TF32 on CUDA) is involved and every device sums in
    one order."""
    from apds_bench.reference.orientation import tree_sum

    K = samples.shape[0]
    side = 2 * pattern + 1
    step = int(np.ceil(pattern * [1.0, 2.0 / 3.0, 1.0 / 2.0][g]))
    n = len(range(-pattern, pattern, step))
    grid = samples.reshape(K, side, side, 3)[:, :n * step, :n * step]
    w = float(np.float32(1.0 / (step * step)))
    blocks = (grid * w).reshape(K, n, step, n, step, 3)
    blocks = blocks.permute(0, 1, 3, 5, 2, 4).reshape(K, n * n, 3,
                                                      step * step)
    return tree_sum(blocks)


# ---- approximate modes: blur-matched samples per cell ---------------------

def _cell_centers(pattern: int = _PATTERN):
    """Static per-grid (step, cell centres [n², 2]) in pattern coordinates."""
    size_mult = [1.0, 2.0 / 3.0, 1.0 / 2.0]
    out = []
    for g in range(3):
        step = int(np.ceil(pattern * size_mult[g]))
        starts = list(range(-pattern, pattern, step))
        centers = np.array([(i + (step - 1) / 2.0, j + (step - 1) / 2.0)
                            for i in starts for j in starts], np.float32)
        out.append((step, centers))
    return out


_CELL_CENTERS = _cell_centers()
# Cells per grid (2×2, 3×3, 4×4): a hybrid cell folds m² subcell samples.
_N_CELLS = [len(c) for _, c in _CELL_CENTERS]


def fast_blur_sigmas(scale: int):
    """Per-grid Gaussian σ (level pixels) matching a box mean over a
    (step·scale)² cell: σ = step·scale/√12."""
    return [step * scale / np.sqrt(12.0) for step, _ in _CELL_CENTERS]


def _subcell_geometry(sub: int, pattern: int = _PATTERN):
    """Static per-grid sub×sub subcell centres and weights.

    A cell's integer samples {i..i+step−1} split into `sub` parts per
    axis (bounds round(step·k/sub)); a subcell's centre is the mean
    position of its part's samples and its weight the count fraction.
    Returns per grid (step, centres [n²·m², 2], weights [n²·m²], m), m the
    number of non-empty parts (≤ sub)."""
    size_mult = [1.0, 2.0 / 3.0, 1.0 / 2.0]
    out = []
    for g in range(3):
        step = int(np.ceil(pattern * size_mult[g]))
        starts = list(range(-pattern, pattern, step))
        bounds = [round(step * k / sub) for k in range(sub + 1)]
        parts = []
        for k in range(sub):
            lo, hi = bounds[k], bounds[k + 1]
            if hi > lo:
                parts.append(((lo + hi - 1) / 2.0, (hi - lo) / step))
        centers, weights = [], []
        for i in starts:
            for j in starts:
                for ca, wa in parts:
                    for cb, wb in parts:
                        centers.append((i + ca, j + cb))
                        weights.append(wa * wb)
        out.append((step, np.asarray(centers, np.float32),
                    np.asarray(weights, np.float32), len(parts)))
    return out


@functools.lru_cache(maxsize=None)
def _subcell(sub: int):
    return _subcell_geometry(sub)


def hybrid_blur_sigmas(scale: int, sub: int = 2):
    """Per-grid σ (level pixels) matching a box mean over a 1/sub cell
    part: σ = step·scale/(sub·√12)."""
    return [step * scale / (sub * np.sqrt(12.0))
            for step, _, _, _ in _subcell(sub)]


def approx_mldb_fn(config):
    """The approximate-mode descriptor function of a config, the one
    dispatch point for fast/hybrid: f(grid_stacks, level_hw, xy, size,
    angle, class_id, octave, valid) on the three per-grid stacks."""
    if config.descriptor_mode == "fast":
        return _fast_descriptors
    return functools.partial(_hybrid_descriptors, sub=config.hybrid_subcells)


def approx_blur_sigmas_fn(config):
    """The blur-σ function paired with approx_mldb_fn."""
    if config.descriptor_mode == "fast":
        return fast_blur_sigmas
    return functools.partial(hybrid_blur_sigmas, sub=config.hybrid_subcells)


def _approx_descriptors(centers_per_grid, weights_per_grid, grid_stacks,
                        level_hw, xy, size, angle, class_id, octave, valid):
    """Shared body of the fast and hybrid modes: grid g samples its stack
    at the rotated `centers_per_grid[g]` (pattern units × the keypoint's
    scale), one sampler (a kernel-B launch on the card) a grid;
    `weights_per_grid[g]` (None in fast mode) folds each cell's m²
    subcell samples into its weighted sum."""
    from apds_bench.reference.twins import (
        patch_sampler)

    K = xy.shape[0]
    dev = xy.device
    lvl = class_id.clamp(0, grid_stacks[0].shape[-4] - 1)
    if grid_stacks[0].dim() == 5:                 # a batch: lvl [B, n]
        lvl = lvl.reshape(grid_stacks[0].shape[0], -1)
    sample_fns = [patch_sampler(g, level_hw, lvl) for g in grid_stacks]
    ratio = torch.exp2(octave.to(torch.float32))
    s = _fround(0.5 * size / ratio).to(torch.float32)[:, None]
    xf = (xy[:, 0] / ratio)[:, None]
    yf = (xy[:, 1] / ratio)[:, None]
    co, si = _cos_sin(angle)

    bit_groups = []
    for g in range(3):
        centers = device_const(centers_per_grid[g], torch.float32, dev)
        k_off = centers[:, 0][None, :]
        l_off = centers[:, 1][None, :]
        sx = xf + s * (k_off * co - l_off * si)
        sy = yf + s * (k_off * si + l_off * co)
        vals = sample_fns[g](_fround(sy), _fround(sx))       # [K, S_g, 4]
        rx = vals[..., 1]
        ry = vals[..., 2]
        dx = rx * co + ry * si
        dy = -rx * si + ry * co
        cells = torch.stack([vals[..., 0], dx, dy], dim=-1)  # [K, S_g, 3]
        if weights_per_grid is not None:
            w = device_const(weights_per_grid[g], torch.float32, dev)
            ms = centers.shape[0] // _N_CELLS[g]
            block = (cells * w[None, :, None]).reshape(K, -1, ms, 3)
            cells = block[:, :, 0]
            for t in range(1, ms):                           # fixed order
                cells = cells + block[:, :, t]
        pairs = device_const(_PAIR_IDX[g], torch.long, dev)
        bits = cells[:, pairs[:, 0], :] > cells[:, pairs[:, 1], :]
        bit_groups.append(bits.transpose(-1, -2).reshape(K, -1))
    desc = pack_bits(torch.cat(bit_groups, dim=-1))
    return torch.where(valid[:, None], desc, torch.zeros_like(desc))


def _fast_descriptors(grid_stacks, level_hw, xy, size, angle, class_id,
                      octave, valid):
    """mldb_descriptors_fast on the three per-grid stacks, each
    [L, H, W, 4] (or [B, L, H, W, 4] for a batch of B·n keypoints): the
    port keeps each grid its own tensor, one contiguous kernel-B stack."""
    return _approx_descriptors(
        [c for _, c in _CELL_CENTERS], None, grid_stacks, level_hw, xy,
        size, angle, class_id, octave, valid)


def _hybrid_descriptors(grid_stacks, level_hw, xy, size, angle, class_id,
                        octave, valid, sub: int = 2):
    """mldb_descriptors_hybrid on the three per-grid stacks (as
    `_fast_descriptors`)."""
    geo = _subcell(sub)
    return _approx_descriptors(
        [c for _, c, _, _ in geo], [w for _, _, w, _ in geo], grid_stacks,
        level_hw, xy, size, angle, class_id, octave, valid)


