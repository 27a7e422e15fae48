"""Calibration pipeline: image folder → corners → intrinsics (port of
pipelines/calibrate.py), on the card unless the caller names another
device.

The calibrator binary rebuilt (reference: calibrator/src/main.rs:27-80):
read ≥10 grayscale images, detect (nx × ny) checkerboard corners, solve
intrinsics + distortion, report K and RMS reprojection error. Improvement
over the reference: views with failed corner detection are masked out of
the solve rather than passed through (main.rs:42-55 quirk).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

from cubesat_apds_tpu_torch.core.config import CalibConfig
from cubesat_apds_tpu_torch.ops.geometry.calibration import (
    CalibrationResult,
    calibrate_camera,
    planar_grid,
)
from cubesat_apds_tpu_torch.ops.geometry.chessboard import (
    find_chessboard_corners)

VALID_EXTENSIONS = (".png", ".jpg", ".jpeg", ".tif", ".tiff")


def read_gray_images(folder: str) -> List[np.ndarray]:
    """Grayscale image folder read (read_images, calibrator
    helpers.rs:12-31)."""
    from PIL import Image

    out = []
    for name in sorted(os.listdir(folder)):
        if os.path.splitext(name)[1].lower() not in VALID_EXTENSIONS:
            continue
        with Image.open(os.path.join(folder, name)) as im:
            out.append(np.asarray(im.convert("F"), np.float32) / 255.0)
    return out


def calibrate_from_images(
    images: List[np.ndarray],
    corners: Tuple[int, int],
    config: CalibConfig = CalibConfig(),
    *,
    device=None,
) -> Tuple[CalibrationResult, np.ndarray]:
    """images: list of [H, W] float grayscale; corners: (nx, ny) inner
    corner counts (the clap `corners` arg, main.rs:18-25). Corner
    detection and the solve run on `device` (the card unless named).

    Returns (result, per-view found mask). Raises like the reference's
    assert when fewer than config.min_images usable views exist
    (main.rs:30-34).
    """
    nx, ny = corners
    if len(images) < config.min_images:
        raise ValueError(
            f"calibration needs >= {config.min_images} images, "
            f"got {len(images)}")
    dev = torch.device("cuda" if device is None else device)
    all_corners, found = [], []
    for img in images:
        c, f = find_chessboard_corners(
            torch.as_tensor(np.asarray(img, np.float32)).to(dev), nx, ny)
        all_corners.append(c)
        found.append(f)
    found_t = torch.stack(found)
    found_mask = found_t.cpu().numpy()
    if found_mask.sum() < config.min_images:
        raise ValueError(
            f"only {int(found_mask.sum())} of {len(images)} views had a "
            f"detectable {nx}x{ny} grid (need {config.min_images})")
    res = calibrate_camera(
        planar_grid(nx, ny, device=dev), torch.stack(all_corners),
        view_valid=found_t, config=config)
    return res, found_mask


def format_report(res: CalibrationResult) -> str:
    """The reference's output: fx, skew, cx / fy, cy + RMS
    (calibrator/src/main.rs:75-80)."""
    K = res.camera.K.cpu().numpy()
    d = res.camera.dist.cpu().numpy()
    return (
        f"Camera matrix:\n"
        f"  fx={K[0, 0]:.4f}  skew={K[0, 1]:.6f}  cx={K[0, 2]:.4f}\n"
        f"  fy={K[1, 1]:.4f}  cy={K[1, 2]:.4f}\n"
        f"Distortion (k1 k2 p1 p2 k3): {d.tolist()}\n"
        f"RMS reprojection error: {float(res.rms):.6f} px"
    )
