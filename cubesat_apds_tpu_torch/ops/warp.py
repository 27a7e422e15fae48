"""Perspective warp, bilinear sampling and undistortion as gathers (port
of ops/warp.py).

Replaces OpenCV ``warp_perspective`` INTER_LINEAR / BORDER_CONSTANT
(reference: homographier/src/homographier/mod.rs:271-300): build the
inverse map on the image's device, gather 4 neighbours, blend. The map is
built by elementwise multiply-adds, never a matrix unit, so the result
does not depend on a matmul precision mode (TF32 on the card).
"""

from __future__ import annotations

import torch


def bilinear_sample(img, coords, fill_value: float = 0.0):
    """Sample [H, W] or [H, W, C] at float (x, y) coords [..., 2].

    Out-of-bounds taps → fill_value (BORDER_CONSTANT semantics).
    """
    h, w = img.shape[0], img.shape[1]
    extra = (1,) * (img.dim() - 2)
    x = coords[..., 0]
    y = coords[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    # Indices far outside the image are clamped before the integer cast
    # (both taps of a clamped index stay out of bounds).
    x0i = x0.clamp(-2, w).to(torch.int64)
    y0i = y0.clamp(-2, h).to(torch.int64)

    def tap(yi, xi, wt):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return torch.where(inb.reshape(inb.shape + extra), v, fill_value) \
            * wt.reshape(wt.shape + extra)

    return (tap(y0i, x0i, (1 - fx) * (1 - fy))
            + tap(y0i, x0i + 1, fx * (1 - fy))
            + tap(y0i + 1, x0i, (1 - fx) * fy)
            + tap(y0i + 1, x0i + 1, fx * fy))


def warp_perspective(img, H, out_shape=None, fill_value: float = 0.0):
    """Warp img [H, W(, C)] by the 3×3 homography H (dst(x) = src(H⁻¹x)),
    INTER_LINEAR, on img's device.

    Matches warp_image_perspective (reference: homographier
    mod.rs:271-300), which forwards to OpenCV warpPerspective: output
    pixel p samples the input at H⁻¹·p. H is inverted in float32.
    """
    img = torch.as_tensor(img)
    dev = img.device
    if out_shape is None:
        out_shape = img.shape[:2]
    oh, ow = out_shape
    Hinv = torch.linalg.inv_ex(torch.as_tensor(H, dtype=torch.float32)
                               .to(dev))[0]
    gy, gx = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                            torch.arange(ow, dtype=torch.float32, device=dev),
                            indexing="ij")
    src = [Hinv[i, 0] * gx + Hinv[i, 1] * gy + Hinv[i, 2] for i in range(3)]
    z = src[2]
    safe_z = torch.where(z.abs() < 1e-12, 1e-12, z)
    coords = torch.stack([src[0] / safe_z, src[1] / safe_z], dim=-1)
    return bilinear_sample(img, coords, fill_value)


def _on_device(x, device):
    """A tensor stays on its own device; a host array goes to `device`
    (the card unless the caller names another)."""
    if isinstance(x, torch.Tensor) and device is None:
        return x
    return torch.as_tensor(x).to("cuda" if device is None else device)


def undistort_image(img, camera, grid=None, *, device=None):
    """Remove lens distortion from a frame [H, W(, C)] (BASELINE config 3:
    batched undistortion of frame streams). A tensor runs on its own
    device, a host array on `device` (the card unless named).

    The sampling grid depends only on the camera model: precompute it
    once with core.camera.undistort_image_grid and pass it as `grid` for
    streaming use; the per-frame work is then one bilinear gather.
    """
    from cubesat_apds_tpu_torch.core.camera import undistort_image_grid

    img = _on_device(img, device)
    if grid is None:
        grid = undistort_image_grid(img.shape[:2], camera, img.device)
    return bilinear_sample(img, grid)


def undistort_frames(frames, camera, *, device=None):
    """Undistortion of a frame batch [B, H, W(, C)]: one grid, and the
    batch gathered with it as trailing channels (one gather for the whole
    batch, no loop over frames). A tensor runs on its own device, a host
    array on `device` (the card unless named)."""
    from cubesat_apds_tpu_torch.core.camera import undistort_image_grid

    frames = _on_device(frames, device)
    b, h, w = frames.shape[:3]
    grid = undistort_image_grid((h, w), camera, frames.device)
    stacked = frames.movedim(0, 2).reshape(h, w, -1)   # [H, W, B·C]
    out = bilinear_sample(stacked, grid)
    return out.reshape((h, w, b) + frames.shape[3:]).movedim(2, 0)


def apply_homography(H, pts):
    """Transform 2D points [..., N, 2] by 3×3 homography [..., 3, 3]."""
    ones = torch.ones(pts.shape[:-1] + (1,), dtype=pts.dtype,
                      device=pts.device)
    ph = torch.cat([pts, ones], dim=-1)
    out = ph @ H.transpose(-1, -2)
    z = out[..., 2]
    safe_z = torch.where(z.abs() < 1e-12, 1e-12, z)
    return out[..., :2] / safe_z[..., None]
