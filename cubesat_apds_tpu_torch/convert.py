"""State exchange with the JAX package through numpy.

The JAX package's containers (DeviceDb, CameraModel, Features, Keypoints)
and the port's have the same fields. These functions read any object
with those attribute names — a JAX container, a port container or a
plain namespace — with ``numpy.asarray`` (no jax import needed), and
build the port's containers from numpy on a chosen device (the card,
``"cuda"``, unless the caller names another; a CPU test passes
``device="cpu"``); `to_numpy` goes back to a dict of numpy arrays that the
JAX containers accept as keyword arguments.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cubesat_apds_tpu_torch.core.types import CameraModel, Features, Keypoints
from cubesat_apds_tpu_torch.pipelines.localize import DeviceDb

_KP_DTYPES = {"xy": np.float32, "size": np.float32, "angle": np.float32,
              "response": np.float32, "octave": np.int32,
              "class_id": np.int32, "valid": np.bool_}


def _get(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def _tensor(src, name, dtype, device):
    return torch.from_numpy(np.array(_get(src, name), dtype=dtype)).to(device)


def keypoints_from(src, device="cuda") -> Keypoints:
    return Keypoints(**{k: _tensor(src, k, dt, device)
                        for k, dt in _KP_DTYPES.items()})


def features_from(src, device="cuda") -> Features:
    return Features(keypoints=keypoints_from(_get(src, "keypoints"), device),
                    descriptors=_tensor(src, "descriptors", np.uint8, device))


def camera_from(src, device="cuda") -> CameraModel:
    return CameraModel(K=_tensor(src, "K", np.float32, device),
                       dist=_tensor(src, "dist", np.float32, device))


def device_db_from(src, device="cuda") -> DeviceDb:
    """DeviceDb from an object or dict with descriptors [M, 61] uint8,
    xy [M, 2], valid [M], obj_points [M, 3], has_world, world_frame."""
    return DeviceDb(
        descriptors=_tensor(src, "descriptors", np.uint8, device),
        xy=_tensor(src, "xy", np.float32, device),
        valid=_tensor(src, "valid", np.bool_, device),
        obj_points=_tensor(src, "obj_points", np.float32, device),
        has_world=bool(_get(src, "has_world")),
        world_frame=str(_get(src, "world_frame")))


def to_numpy(obj):
    """A port container → nested dict of numpy arrays (non-tensor fields
    kept as they are)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    return obj
