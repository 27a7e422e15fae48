"""Typed tensor containers for the pipeline (port of core/types.py).

Everything downstream of detection is fixed capacity + validity mask, as
in the JAX package, so the port's outputs line up with the reference's
array for array. The containers are plain dataclasses of tensors;
``to_device`` moves any of them (nested included) to another device,
``upload`` puts host data on a card without waiting for the copy,
``select`` takes one item of a batched one, ``fold_lead`` /
``unfold_lead`` fold leading (batch) dimensions into one and back, and
``take_rows`` and ``pick`` gather rows batch by batch. Every container
may carry leading batch dimensions: the back half (match, homography, pose) runs a
whole batch of frames as one pass, and a lone frame is the case with no
leading dimension.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def _map_tensors(obj, fn):
    """fn applied to every tensor of a tensor dataclass (nested
    dataclasses and tuples of tensors included). Non-tensor fields are
    kept as they are."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple):
        return tuple(_map_tensors(x, fn) for x in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _map_tensors(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj)})
    return obj


def to_device(obj, device):
    """Copy a tensor dataclass to `device`."""
    return _map_tensors(obj, lambda t: t.to(device))


_CONSTS: dict = {}


def device_const(values, dtype, device) -> torch.Tensor:
    """Host data (a number or nested lists/tuples of numbers, or a numpy
    array) as a `dtype` tensor on `device`, uploaded once and kept: the
    steps' constants are then never copied up again, and a step on the
    card queues no synchronising copy. The cache lives as long as the
    process, so callers pass only small constants of a fixed set (tap
    tables, level sizes) and never write to the result. A new constant
    cannot be uploaded while the current stream captures a CUDA graph (the
    graph would record a copy from a host buffer that is gone by its
    replay): that raises, and a warm-up before the capture makes them."""
    arr = np.asarray(values)
    key = (arr.tobytes(), arr.shape, arr.dtype.str, dtype, str(device))
    t = _CONSTS.get(key)
    if t is None:
        if torch.device(device).type == "cuda" \
                and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"device_const: a new {dtype} constant of shape {arr.shape} "
                "while a CUDA graph is being captured; run the captured "
                "work once before the capture")
        # From pageable memory a non-blocking copy is staged at once and
        # does not wait on the device.
        t = torch.as_tensor(arr, dtype=dtype).to(device, non_blocking=True)
        _CONSTS[key] = t
    return t


def select(obj, index):
    """Item `index` of the leading (batch) axis of every tensor of a tensor
    dataclass: one image's Features of a batch's."""
    return _map_tensors(obj, lambda t: t[index])


def fold_lead(obj, n: int):
    """The first `n` dimensions of every tensor of `obj` folded into one
    (n = 0 adds a leading dimension of 1)."""
    return _map_tensors(obj, lambda t: t.reshape(
        (math.prod(t.shape[:n]),) + t.shape[n:]))


def unfold_lead(obj, lead):
    """The inverse of `fold_lead`: the first dimension of every tensor of
    `obj` unfolded into the shape `lead` (() drops it)."""
    return _map_tensors(obj, lambda t: t.reshape(tuple(lead) + t.shape[1:]))


def pick(x, idx):
    """x [B, C, ...] at idx [B] → [B, ...]: each batch row's choice (a
    RANSAC winner) among its C candidates."""
    i = idx.reshape(idx.shape + (1,) * (x.dim() - 1))
    return torch.take_along_dim(x, i, dim=1)[:, 0]


def take_rows(table, idx):
    """Rows of `table` at `idx`, batch by batch: table [B, M, ...], idx
    [B, ...] integer → [B, *idx.shape[1:], ...] (row idx[b, ...] of
    table[b])."""
    b = idx.shape[0]
    flat = idx.reshape(b, -1).long()
    trail = table.shape[2:]
    out = torch.take_along_dim(
        table, flat.reshape(flat.shape + (1,) * len(trail)), dim=1)
    return out.reshape(idx.shape + trail)


@dataclasses.dataclass
class Keypoints:
    """Fixed-capacity keypoint set; ``valid`` masks the live entries.

    Invalid slots hold zeros (class_id −1). The detector emits a
    response-sorted valid prefix.
    """

    xy: torch.Tensor          # [..., K, 2] float32 — (x, y) pixel coords
    size: torch.Tensor        # [..., K]   float32 — diameter
    angle: torch.Tensor       # [..., K]   float32 — orientation, radians
    response: torch.Tensor    # [..., K]   float32 — detector response
    octave: torch.Tensor      # [..., K]   int32
    class_id: torch.Tensor    # [..., K]   int32 — evolution level index
    valid: torch.Tensor       # [..., K]   bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]

    def count(self) -> torch.Tensor:
        return self.valid.sum(-1, dtype=torch.int32)


@dataclasses.dataclass
class Features:
    """Keypoints + packed MLDB descriptors, uint8 ``[..., K, 61]``."""

    keypoints: Keypoints
    descriptors: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.keypoints.capacity


@dataclasses.dataclass
class Matches:
    """Fixed-capacity match set (query index, train index, distance)."""

    query_idx: torch.Tensor  # [..., M] int32
    train_idx: torch.Tensor  # [..., M] int32
    distance: torch.Tensor   # [..., M] float32
    valid: torch.Tensor      # [..., M] bool

    def count(self) -> torch.Tensor:
        return self.valid.sum(-1, dtype=torch.int32)


@dataclasses.dataclass
class Correspondences:
    """3D↔2D correspondences for PnP."""

    obj_points: torch.Tensor  # [..., N, 3] float32
    img_points: torch.Tensor  # [..., N, 2] float32 (pixels)
    valid: torch.Tensor       # [..., N] bool


@dataclasses.dataclass
class HomographyResult:
    """3×3 homography + inlier mask."""

    H: torch.Tensor            # [..., 3, 3] float32
    inliers: torch.Tensor      # [..., N] bool
    num_inliers: torch.Tensor  # [...] int32
    ok: torch.Tensor           # [...] bool


@dataclasses.dataclass
class PoseSolution:
    """6-DoF pose: Rodrigues rotation vector + translation + inliers."""

    rvec: torch.Tensor         # [..., 3] float32
    tvec: torch.Tensor         # [..., 3] float32
    inliers: torch.Tensor      # [..., N] bool
    num_inliers: torch.Tensor  # [...] int32
    ok: torch.Tensor           # [...] bool


@dataclasses.dataclass
class CameraModel:
    """Pinhole intrinsics + Brown–Conrady distortion (k1,k2,p1,p2,k3)."""

    K: torch.Tensor     # [3, 3] float32
    dist: torch.Tensor  # [5] float32

    @staticmethod
    def ideal(fx: float, fy: float, cx: float, cy: float,
              device=None) -> "CameraModel":
        K = torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                         dtype=torch.float32, device=device)
        return CameraModel(K=K, dist=torch.zeros(5, dtype=torch.float32,
                                                 device=device))
