"""Visualization + image codec IO (host-side, PIL; port of utils/viz.py).

Replaces the OpenCV draw/imread/imwrite utilities the reference leans on
(export_matches / draw_matches / imread — feature_extraction/src/
lib.rs:128-159; SURVEY.md §2.2 classifies these as host-side, not
perf-critical). Every drawing function takes numpy arrays or tensors on
any device: tensors come to the host with `.detach().cpu()`.
"""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageDraw


def _host(a) -> np.ndarray:
    """A numpy view of `a`; a tensor (CPU or CUDA) is copied to the host."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def _to_rgb_u8(img) -> np.ndarray:
    a = _host(img)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255).astype(np.uint8)
    if a.ndim == 2:
        a = np.stack([a] * 3, -1)
    return a[..., :3]


def read_image_gray(path: str) -> np.ndarray:
    """imread grayscale → float32 [0,1] (get_mat_from_dir equivalent,
    reference lib.rs:157-159)."""
    with Image.open(path) as im:
        return np.asarray(im.convert("F"), np.float32) / 255.0


def write_image(path: str, img):
    Image.fromarray(_to_rgb_u8(img)).save(path)


def draw_keypoints(img, xy, valid=None, color=(0, 255, 0),
                   radius: int = 3) -> np.ndarray:
    """Draw keypoint circles (cv2.drawKeypoints equivalent)."""
    canvas = Image.fromarray(_to_rgb_u8(img))
    d = ImageDraw.Draw(canvas)
    xy = _host(xy)
    valid = np.ones(len(xy), bool) if valid is None else _host(valid)
    for (x, y), ok in zip(xy, valid):
        if not ok:
            continue
        d.ellipse([x - radius, y - radius, x + radius, y + radius],
                  outline=tuple(color))
    return np.asarray(canvas)


def draw_matches(img1, kp1_xy, img2, kp2_xy, query_idx, train_idx,
                 valid=None, color=(0, 220, 60)) -> np.ndarray:
    """Side-by-side match visualization (cv2.drawMatches /
    DrawMatchesFlags::NOT_DRAW_SINGLE_POINTS equivalent)."""
    a = _to_rgb_u8(img1)
    b = _to_rgb_u8(img2)
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1]:] = b
    im = Image.fromarray(canvas)
    d = ImageDraw.Draw(im)
    off = a.shape[1]
    kp1_xy = _host(kp1_xy)
    kp2_xy = _host(kp2_xy)
    query_idx = _host(query_idx)
    train_idx = _host(train_idx)
    valid = (np.ones(len(query_idx), bool) if valid is None
             else _host(valid))
    for qi, ti, ok in zip(query_idx, train_idx, valid):
        if not ok:
            continue
        x1, y1 = kp1_xy[qi]
        x2, y2 = kp2_xy[ti]
        d.line([x1, y1, x2 + off, y2], fill=tuple(color), width=1)
        d.ellipse([x1 - 2, y1 - 2, x1 + 2, y1 + 2], outline=tuple(color))
        d.ellipse([x2 + off - 2, y2 - 2, x2 + off + 2, y2 + 2],
                  outline=tuple(color))
    return np.asarray(im)


def export_matches(img1, feats1, img2, feats2, matches,
                   export_location: str):
    """export_matches equivalent (reference lib.rs:128-155): draw and
    write to disk."""
    out = draw_matches(
        img1, feats1.keypoints.xy, img2, feats2.keypoints.xy,
        matches.query_idx, matches.train_idx, matches.valid)
    write_image(export_location, out)
    return out
