"""AKAZE detect-and-compute for one image, exact mode (port of
ops/features/akaze.py:detect_and_compute).

Scale space (kernel A per FED cycle on CUDA) → det-Hessian detection →
bf16 channel-packed level stack → orientation and MLDB descriptors, both
sampled through kernel B on CUDA. Only the live, response-sorted prefix
of the keypoints goes through the per-keypoint stages; the outputs are
padded back to capacity.
"""

from __future__ import annotations

from typing import List

import torch

from cubesat_apds_tpu_torch.core.config import AkazeConfig
from cubesat_apds_tpu_torch.core.types import Features, Keypoints
from cubesat_apds_tpu_torch.ops.features.detect import detect_keypoints
from cubesat_apds_tpu_torch.ops.features.mldb import mldb_descriptors
from cubesat_apds_tpu_torch.ops.features.orientation import (
    compute_orientations)
from cubesat_apds_tpu_torch.ops.features.scale_space import build_scale_space
from cubesat_apds_tpu_torch.ops.kernels.sample_kernel import patch_sampler


def _pad_stack(levels: List[torch.Tensor]) -> torch.Tensor:
    """Stack per-level arrays into one [L, Hmax, Wmax] zero-padded tensor."""
    hmax = max(a.shape[0] for a in levels)
    wmax = max(a.shape[1] for a in levels)
    out = levels[0].new_zeros((len(levels), hmax, wmax))
    for i, a in enumerate(levels):
        out[i, : a.shape[0], : a.shape[1]] = a
    return out


def _packed_stack(lt, lx, ly) -> torch.Tensor:
    """[L, H, W, 4] channel-packed (Lt, Lx, Ly, 0) stack in bfloat16
    (round to nearest even, as JAX's astype)."""
    stacks = [_pad_stack(x).to(torch.bfloat16) for x in (lt, lx, ly)]
    return torch.stack(stacks + [torch.zeros_like(stacks[0])], dim=-1)


def _check_exact(config: AkazeConfig):
    if config.descriptor_mode != "exact" or config.orientation_mode != "exact":
        raise NotImplementedError(
            "cubesat_apds_tpu_torch ports descriptor_mode='exact' and "
            "orientation_mode='exact' only, got "
            f"{config.descriptor_mode!r}/{config.orientation_mode!r}")


def detect_and_compute(img, config: AkazeConfig = AkazeConfig(),
                       capacity: int | None = None,
                       kcontrast=None) -> Features:
    """img: [H, W] float32 grayscale in [0, 1] (tensor; its device picks
    the path) → Features, keypoints response-sorted and capacity-padded.

    The detector's top-K is exact whatever `config.detect_topk` says, and
    `config.sampler` is ignored: on CUDA both per-keypoint stages sample
    through kernel B, on CPU through the plain gather.
    """
    _check_exact(config)
    capacity = capacity or config.capacity
    img = torch.as_tensor(img, dtype=torch.float32)
    ss = build_scale_space(img, config, kcontrast)
    kps, lx_list, ly_list = detect_keypoints(ss, config, capacity)
    packed = _packed_stack(ss.Lt, lx_list, ly_list)
    level_hw = torch.tensor([list(a.shape) for a in ss.Lt],
                            dtype=torch.int32, device=img.device)

    # The valid keypoints are a prefix: run the per-keypoint stages on it
    # alone (one host read of the count per image).
    n = int(kps.valid.sum())
    angle = torch.zeros(capacity, dtype=torch.float32, device=img.device)
    desc = torch.zeros((capacity, 61), dtype=torch.uint8, device=img.device)
    if n:
        xy, size = kps.xy[:n], kps.size[:n]
        class_id, octave, valid = kps.class_id[:n], kps.octave[:n], kps.valid[:n]
        lvl = class_id.clamp(0, packed.shape[0] - 1)
        sample_fn = patch_sampler(packed, level_hw, lvl)
        angle[:n] = compute_orientations(packed, level_hw, xy, size, class_id,
                                         octave, valid, sample_fn=sample_fn)
        desc[:n] = mldb_descriptors(packed, level_hw, xy, size, angle[:n],
                                    class_id, octave, valid,
                                    sample_fn=sample_fn)
    kps = Keypoints(xy=kps.xy, size=kps.size, angle=angle,
                    response=kps.response, octave=kps.octave,
                    class_id=kps.class_id, valid=kps.valid)
    return Features(keypoints=kps, descriptors=desc)
