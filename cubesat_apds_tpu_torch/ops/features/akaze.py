"""AKAZE detect-and-compute over a batch of images, exact mode (port of
ops/features/akaze.py:detect_and_compute and detect_and_compute_batch).

Scale space (kernel A per FED cycle on CUDA, one launch per level for
the batch) → det-Hessian detection → bf16 channel-packed level stacks →
orientation and MLDB descriptors, both sampled through kernel B on CUDA
(one launch each for the batch). Only the live, response-sorted prefix
of the keypoints goes through the per-keypoint stages; the outputs are
padded back to capacity. One image is a batch of one.
"""

from __future__ import annotations

from typing import List

import torch

from cubesat_apds_tpu_torch.core.config import AkazeConfig
from cubesat_apds_tpu_torch.core.types import Features, Keypoints, select
from cubesat_apds_tpu_torch.ops.features.detect import detect_keypoints
from cubesat_apds_tpu_torch.ops.features.mldb import mldb_descriptors
from cubesat_apds_tpu_torch.ops.features.orientation import (
    compute_orientations)
from cubesat_apds_tpu_torch.ops.features.scale_space import build_scale_space
from cubesat_apds_tpu_torch.ops.kernels.sample_kernel import patch_sampler


def _pad_stack(levels: List[torch.Tensor]) -> torch.Tensor:
    """Stack per-level [B, h, w] arrays into one [B, L, Hmax, Wmax]
    zero-padded tensor."""
    hmax = max(a.shape[-2] for a in levels)
    wmax = max(a.shape[-1] for a in levels)
    out = levels[0].new_zeros((levels[0].shape[0], len(levels), hmax, wmax))
    for i, a in enumerate(levels):
        out[:, i, : a.shape[-2], : a.shape[-1]] = a
    return out


def _packed_stack(lt, lx, ly) -> torch.Tensor:
    """[B, L, H, W, 4] channel-packed (Lt, Lx, Ly, 0) stacks in bfloat16
    (round to nearest even, as JAX's astype)."""
    stacks = [_pad_stack(x).to(torch.bfloat16) for x in (lt, lx, ly)]
    return torch.stack(stacks + [torch.zeros_like(stacks[0])], dim=-1)


def _check_exact(config: AkazeConfig):
    if config.descriptor_mode != "exact" or config.orientation_mode != "exact":
        raise NotImplementedError(
            "cubesat_apds_tpu_torch ports descriptor_mode='exact' and "
            "orientation_mode='exact' only, got "
            f"{config.descriptor_mode!r}/{config.orientation_mode!r}")


def detect_and_compute_batch(imgs, config: AkazeConfig = AkazeConfig(),
                             capacity: int | None = None,
                             kcontrast=None) -> Features:
    """imgs: [B, H, W] float32 grayscale in [0, 1] (tensor; its device
    picks the path) → Features [B, capacity], each image's keypoints
    response-sorted and capacity-padded: the same bits as
    `detect_and_compute` on each image alone.

    The front end runs on the whole batch (one kernel-A launch per level).
    The per-keypoint stages run once for the batch, on the first n slots
    of every image, n the batch's largest live count (one host read per
    batch): the valid keypoints are a prefix and slots past an image's
    count come out as zeros either way. The detector's top-K is exact
    whatever `config.detect_topk` says, and `config.sampler` is ignored:
    on CUDA both per-keypoint stages sample through kernel B, on CPU
    through the plain gather.
    """
    _check_exact(config)
    capacity = capacity or config.capacity
    imgs = torch.as_tensor(imgs, dtype=torch.float32)
    if imgs.dim() != 3:
        raise ValueError(f"detect_and_compute_batch: [B, H, W] images, got "
                         f"{tuple(imgs.shape)}")
    bsz, dev = imgs.shape[0], imgs.device
    ss = build_scale_space(imgs, config, kcontrast)
    kps, lx_list, ly_list = detect_keypoints(ss, config, capacity)
    packed = _packed_stack(ss.Lt, lx_list, ly_list)
    level_hw = torch.tensor([list(a.shape[-2:]) for a in ss.Lt],
                            dtype=torch.int32, device=dev)

    n = int(kps.valid.sum(-1).max())
    angle = torch.zeros((bsz, capacity), dtype=torch.float32, device=dev)
    desc = torch.zeros((bsz, capacity, 61), dtype=torch.uint8, device=dev)
    if n:
        xy, size, class_id, octave, valid = (
            t[:, :n].reshape((bsz * n,) + t.shape[2:])
            for t in (kps.xy, kps.size, kps.class_id, kps.octave, kps.valid))
        lvl = kps.class_id[:, :n].clamp(0, packed.shape[1] - 1)
        sample_fn = patch_sampler(packed, level_hw, lvl)
        # Both stages sample through sample_fn, so they get one image's
        # stack only for its shape.
        a = compute_orientations(packed[0], level_hw, xy, size, class_id,
                                 octave, valid, sample_fn=sample_fn)
        d = mldb_descriptors(packed[0], level_hw, xy, size, a, class_id,
                             octave, valid, sample_fn=sample_fn)
        angle[:, :n] = a.reshape(bsz, n)
        desc[:, :n] = d.reshape(bsz, n, 61)
    kps = Keypoints(xy=kps.xy, size=kps.size, angle=angle,
                    response=kps.response, octave=kps.octave,
                    class_id=kps.class_id, valid=kps.valid)
    return Features(keypoints=kps, descriptors=desc)


def detect_and_compute(img, config: AkazeConfig = AkazeConfig(),
                       capacity: int | None = None,
                       kcontrast=None) -> Features:
    """img: [H, W] float32 grayscale in [0, 1] → Features, keypoints
    response-sorted and capacity-padded: `detect_and_compute_batch` of a
    batch of one."""
    img = torch.as_tensor(img, dtype=torch.float32)
    return select(detect_and_compute_batch(img[None], config, capacity,
                                           kcontrast), 0)
