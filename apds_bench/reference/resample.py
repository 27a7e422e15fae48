"""Separable Gaussian blur (and its multiscale approximation), 2× area
downsample, separable filters and Lanczos resampling (port of
ops/resample.py, the parts the scale space, the descriptor modes' stacks
and the mosaic use).

Filters, the Lanczos downsample included, are shift-and-add sums in the
JAX package's term order, with padding done by an index gather or a zero
pad: every tap is one elementwise multiply and add, so the CPU and CUDA
results are the same bits and no convolution library (nor its TF32
default on CUDA) is involved. The Lanczos resample at other ratios is a
dense float32 product per axis, as in the JAX package; TF32 must be off.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _gaussian_kernel_np(sigma: float, radius: int | None = None):
    if radius is None:
        radius = max(int(math.ceil(3.0 * sigma)), 1)
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    w = np.exp(-0.5 * (xs / sigma) ** 2)
    w /= w.sum()
    return w.astype(np.float32)


def _pad_index(n: int, r: int, mode: str, device) -> torch.Tensor:
    """Source index of each position of an axis of length n padded by r
    on both sides: "edge" repeats the border sample (jnp.pad "edge"),
    "reflect" mirrors without repeating it (jnp.pad "reflect")."""
    i = torch.arange(-r, n + r, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "reflect":
        if r >= n:
            raise ValueError(f"reflect padding {r} needs an axis longer "
                             f"than {r}, got {n}")
        return torch.where(i < 0, -i, torch.where(i >= n, 2 * (n - 1) - i, i))
    raise ValueError(f"unsupported pad mode {mode!r}")


def _shift_filter(x, kernel: np.ndarray, axis: int, pad_mode: str):
    """Apply a 1-D correlation filter along `axis` as Σ wₖ·shiftₖ(x)."""
    kernel = np.asarray(kernel, np.float32)
    r = len(kernel) // 2
    n = x.shape[axis]
    xp = x.index_select(axis, _pad_index(n, r, pad_mode, x.device))
    out = None
    for k, w in enumerate(kernel):
        if w == 0.0:
            continue
        term = xp.narrow(axis, k, n) * float(w)
        out = term if out is None else out + term
    return out if out is not None else torch.zeros_like(x)


def gaussian_blur(img, sigma: float, radius: int | None = None):
    """Separable Gaussian blur on [..., H, W], replicate-edge padding."""
    x = img.to(torch.float32)
    if sigma <= 0:
        return x
    w = _gaussian_kernel_np(sigma, radius)
    x = _shift_filter(x, w, x.dim() - 2, "edge")
    return _shift_filter(x, w, x.dim() - 1, "edge")


def half_sample(img):
    """Downsample by 2 with the 2×2 mean (odd trailing row/col dropped)."""
    x = img.to(torch.float32)
    h2, w2 = x.shape[-2] // 2, x.shape[-1] // 2
    x = x[..., : h2 * 2, : w2 * 2]
    s = (x[..., 0::2, 0::2] + x[..., 0::2, 1::2]) \
        + (x[..., 1::2, 0::2] + x[..., 1::2, 1::2])
    return s / 4.0


def separable_conv2d(img, row_kernel, col_kernel, pad_mode: str = "edge"):
    """General separable filter on [..., H, W]: `row_kernel` along H,
    then `col_kernel` along W (correlation, no kernel flip)."""
    x = img.to(torch.float32)
    x = _shift_filter(x, row_kernel, x.dim() - 2, pad_mode)
    return _shift_filter(x, col_kernel, x.dim() - 1, pad_mode)


# --- Lanczos resampling (the mosaic's windowed reads) ----------------------


def _lanczos_matrix_np(in_n: int, out_n: int, a: int = 3,
                       scale: float | None = None, offset: float = -0.5):
    """Dense 1-D Lanczos resampling matrix [out_n, in_n] at any ratio: for
    a downscale the kernel is stretched by the scale, and border rows
    renormalize over the in-range taps. `scale` and `offset` override the
    in_n/out_n ratio and the half-pixel centre convention."""
    if scale is None:
        scale = in_n / out_n
    stretch = max(scale, 1.0)
    centers = (np.arange(out_n, dtype=np.float64) + 0.5) * scale + offset
    t = (np.arange(in_n, dtype=np.float64)[None, :]
         - centers[:, None]) / stretch
    with np.errstate(invalid="ignore", divide="ignore"):
        w = np.sinc(t) * np.sinc(t / a)
    w[np.abs(t) >= a] = 0.0
    w /= w.sum(axis=1, keepdims=True)
    return w.astype(np.float32)


def _apply_rows_cols(x, wr, wc):
    """wr @ x @ wcᵀ over the last two axes, in float32 (TF32 is refused:
    the product must keep float32's mantissa)."""
    if torch.backends.cuda.matmul.allow_tf32 and x.device.type == "cuda":
        raise RuntimeError("lanczos_resample: torch.backends.cuda.matmul."
                           "allow_tf32 must stay False")
    if wr is not None:
        x = torch.matmul(torch.from_numpy(wr).to(x.device), x)
    if wc is not None:
        x = torch.matmul(x, torch.from_numpy(wc).to(x.device).T)
    return x


def lanczos_resample(img, out_size, a: int = 3):
    """Resample [..., H, W] to [..., oh, ow] with Lanczos-a at any ratio,
    each axis one dense [out, in] product."""
    oh, ow = out_size
    x = img.to(torch.float32)
    h, w = x.shape[-2:]
    return _apply_rows_cols(
        x, _lanczos_matrix_np(h, oh, a) if h != oh else None,
        _lanczos_matrix_np(w, ow, a) if w != ow else None)


