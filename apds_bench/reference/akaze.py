"""AKAZE detect-and-compute over a batch of images, in plain PyTorch.

A frozen copy of the port's eager CPU path (the scale space with the FED
cycle's plain twin, det-Hessian detection, bf16 channel-packed level
stacks, orientation and MLDB descriptors through the plain gather), with
no CUDA graph, no capacity ladder and no hand-written kernel: the
per-keypoint stages run on every capacity slot, which gives the same bits
as any rung that holds the live keypoints. It runs on whatever device its
tensors are on.

`precision="bfloat16"` rounds the scale space's levels to bfloat16 as
they are made: the lower-precision control of the benchmark's check.
"""

from __future__ import annotations

import torch

from apds_bench.reference.config import AkazeConfig
from apds_bench.reference.types_ import (
    Features, Keypoints, device_const, select)
from apds_bench.reference.detect import detect_keypoints
from apds_bench.reference.mldb import (
    approx_blur_sigmas_fn, approx_mldb_fn, mldb_descriptors)
from apds_bench.reference.orientation import (
    compute_orientations)
from apds_bench.reference.scale_space import build_scale_space
from apds_bench.reference.twins import patch_sampler
from apds_bench.reference.resample import gaussian_blur

def _packed_stack(lt, lx, ly) -> torch.Tensor:
    """[B, L, H, W, 4] channel-packed (Lt, Lx, Ly, 0) stacks in bfloat16
    (round to nearest even, as JAX's astype), each level zero-padded to
    the largest. Each level is written into its channel of the output
    directly, so no float32 stack of all the levels is ever made."""
    hmax = max(a.shape[-2] for a in lt)
    wmax = max(a.shape[-1] for a in lt)
    out = lt[0].new_zeros((lt[0].shape[0], len(lt), hmax, wmax, 4),
                          dtype=torch.bfloat16)
    for c, levels in enumerate((lt, lx, ly)):
        for i, a in enumerate(levels):
            out[:, i, :a.shape[-2], :a.shape[-1], c] = a
    return out


def _grid_stacks(ss, lx, ly, config: AkazeConfig):
    """The approximate modes' blur-matched stacks: for each MLDB grid g a
    [B, L, H, W, 4] packed stack of every level's (Lt, Lx, Ly) blurred
    together with that level's matched σ (approx_blur_sigmas_fn). The JAX
    package concatenates the three along the level axis ([3L, H, W, 4]);
    here each grid keeps its own tensor, so each is one contiguous
    kernel-B stack. None in exact mode."""
    if config.descriptor_mode == "exact":
        return None
    sigmas_fn = approx_blur_sigmas_fn(config)
    base3 = [torch.stack([ss.Lt[i], lx[i], ly[i]], dim=1)
             for i in range(len(ss.Lt))]                     # [B, 3, h, w]
    grids = []
    for g in range(3):
        blurred = [gaussian_blur(base3[i], sigmas_fn(m.sigma_size)[g])
                   for i, m in enumerate(ss.meta)]
        grids.append(_packed_stack([b[:, 0] for b in blurred],
                                   [b[:, 1] for b in blurred],
                                   [b[:, 2] for b in blurred]))
    return tuple(grids)


def detect_and_compute_batch(imgs, config: AkazeConfig = AkazeConfig(),
                             capacity: int | None = None,
                             precision: str = "float32") -> Features:
    """imgs: [B, H, W] float32 grayscale in [0, 1] → Features [B,
    capacity], each image's keypoints response-sorted and
    capacity-padded."""
    capacity = capacity or config.capacity
    imgs = torch.as_tensor(imgs, dtype=torch.float32)
    if imgs.dim() != 3:
        raise ValueError(f"detect_and_compute_batch: [B, H, W] images, got "
                         f"{tuple(imgs.shape)}")
    kps, packed, level_hw, grids = _front_end(imgs, config, capacity,
                                              precision)
    angle, desc = orient_describe(kps, packed, level_hw, capacity, config,
                                  grids)
    kps = Keypoints(xy=kps.xy, size=kps.size, angle=angle,
                    response=kps.response, octave=kps.octave,
                    class_id=kps.class_id, valid=kps.valid)
    return Features(keypoints=kps, descriptors=desc)


def _front_end(imgs, config: AkazeConfig, capacity: int, precision: str):
    """Scale space, detection and the packed level stacks of a batch:
    (keypoints without angles, packed [B, L, H, W, 4], level_hw [L, 2],
    the approximate modes' grid stacks or None)."""
    ss = build_scale_space(imgs, config, precision=precision)
    kps, lx_list, ly_list = detect_keypoints(ss, config, capacity)
    packed = _packed_stack(ss.Lt, lx_list, ly_list)
    level_hw = device_const([list(a.shape[-2:]) for a in ss.Lt],
                            torch.int32, imgs.device)
    return kps, packed, level_hw, _grid_stacks(ss, lx_list, ly_list, config)


def _stage(xy, size, class_id, octave, valid, packed, level_hw, n: int,
           config: AkazeConfig, grids):
    """Orientation and MLDB descriptors of the first `n` slots of every
    image → (angle [B, n], desc [B, n, 61]): the body of each ladder rung.
    Both stages sample through one `patch_sampler` (kernel B on the card)
    over the batch's stacks; in the approximate descriptor modes `grids`
    holds `_grid_stacks`' three stacks, each sampled on its own (one
    kernel-B launch a grid on the card)."""
    bsz = valid.shape[0]
    lvl = class_id[:, :n].clamp(0, packed.shape[1] - 1)
    xy, size, class_id, octave, valid = (
        t[:, :n].reshape((bsz * n,) + t.shape[2:])
        for t in (xy, size, class_id, octave, valid))
    sample_fn = patch_sampler(packed, level_hw, lvl)
    # Both stages sample through sample_fn, so they get one image's
    # stack only for its shape.
    a = compute_orientations(packed[0], level_hw, xy, size, class_id,
                             octave, valid, sample_fn=sample_fn,
                             mode=config.orientation_mode)
    if config.descriptor_mode == "exact":
        d = mldb_descriptors(packed[0], level_hw, xy, size, a, class_id,
                             octave, valid, sample_fn=sample_fn)
    else:
        d = approx_mldb_fn(config)(grids, level_hw, xy, size, a, class_id,
                                   octave, valid)
    return a.reshape(bsz, n), d.reshape(bsz, n, 61)


def orient_describe(kps: Keypoints, packed, level_hw, n: int,
                    config: AkazeConfig = AkazeConfig(), grids=None):
    """Orientation and MLDB descriptors of the first `n` slots of every
    image of the batch → (angle [B, capacity], desc [B, capacity, 61]),
    zero past slot n. Invalid slots come out as zeros from both stages'
    masks, and the valid keypoints are a response-sorted prefix, so any
    n at or above the batch's largest live count gives the same bits."""
    bsz, capacity = kps.valid.shape
    dev = kps.xy.device
    angle = torch.zeros((bsz, capacity), dtype=torch.float32, device=dev)
    desc = torch.zeros((bsz, capacity, 61), dtype=torch.uint8, device=dev)
    if n == 0:
        return angle, desc
    angle[:, :n], desc[:, :n] = _stage(
        kps.xy, kps.size, kps.class_id, kps.octave, kps.valid, packed,
        level_hw, n, config, grids)
    return angle, desc


def detect_and_compute(img, config: AkazeConfig = AkazeConfig(),
                       capacity: int | None = None,
                       precision: str = "float32") -> Features:
    """img: [H, W] float32 grayscale in [0, 1] → Features:
    `detect_and_compute_batch` of a batch of one."""
    img = torch.as_tensor(img, dtype=torch.float32)
    return select(detect_and_compute_batch(img[None], config, capacity,
                                           precision), 0)


