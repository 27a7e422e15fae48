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


def _up2_axis(x, axis: int, out_n: int):
    """Bilinear 2× upsample along `axis`, inverse-aligned with
    half_sample's 2×2-mean grid (coarse centre i ↔ fine 2i+0.5):
    fine[2i] = 0.25·C[i−1] + 0.75·C[i], fine[2i+1] = 0.75·C[i] +
    0.25·C[i+1] (edge-clamped), then cropped or edge-padded to out_n."""
    n = x.shape[axis]
    i = torch.arange(n, device=x.device)
    prev = x.index_select(axis, (i - 1).clamp(0, n - 1))
    nxt = x.index_select(axis, (i + 1).clamp(0, n - 1))
    even = prev * 0.25 + x * 0.75
    odd = x * 0.75 + nxt * 0.25
    out = torch.stack([even, odd], dim=axis + 1)
    shape = list(x.shape)
    shape[axis] = 2 * n
    out = out.reshape(shape)
    if 2 * n != out_n:
        idx = torch.arange(out_n, device=x.device).clamp(max=2 * n - 1)
        out = out.index_select(axis, idx)
    return out


def gaussian_blur_ms(img, sigma: float, coarse_sigma_max: float = 2.5):
    """Multiscale approximate Gaussian blur: a large σ runs at reduced
    resolution (half-sample → blur → bilinear upsample), O(H·W) instead
    of O(σ·H·W).

    Each 2× round trip at the current factor f consumes 1.0·f² of the σ²
    budget (the 2×2 mean 0.25·f² per axis, the bilinear upsample 0.75·f²);
    the composite kernel is box ⊗ Gaussian ⊗ tent, within ~1% of a true
    Gaussian once two convolutions have mixed."""
    x = img.to(torch.float32)
    var = float(sigma) * float(sigma)
    f = 1
    sizes = []
    while (math.sqrt(var) / f > coarse_sigma_max
           and var - f * f >= (1.6 * f * 2) ** 2 * 0.25):
        sizes.append(tuple(x.shape[-2:]))
        var -= 1.0 * f * f
        h, w = x.shape[-2:]
        if h % 2 or w % 2:                         # edge-pad to even
            x = x.index_select(x.dim() - 2, torch.arange(
                h + h % 2, device=x.device).clamp(max=h - 1))
            x = x.index_select(x.dim() - 1, torch.arange(
                w + w % 2, device=x.device).clamp(max=w - 1))
        x = half_sample(x)
        f *= 2
    x = gaussian_blur(x, math.sqrt(var) / f)
    for h, w in reversed(sizes):
        x = _up2_axis(x, x.dim() - 2, h)
        x = _up2_axis(x, x.dim() - 1, w)
    return x


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

def _lanczos_kernel_np(scale: float, a: int = 3):
    """Tap weights for Lanczos-a downsampling by an integer factor: the
    kernel stretched by the factor (support a·scale on each side)."""
    stretch = max(scale, 1.0)
    support = a * stretch
    radius = int(math.ceil(support))
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    t = xs / stretch
    with np.errstate(invalid="ignore", divide="ignore"):
        w = np.sinc(t) * np.sinc(t / a)
    w[np.abs(t) >= a] = 0.0
    w /= w.sum()
    return w.astype(np.float32)


def _strided_filter(x, kernel: np.ndarray, axis: int, stride: int):
    """Zero-padded 1-D correlation along `axis`, sampled every `stride`
    positions: out[i] = Σ_k w_k·x[i·stride + k − r], as a shift-and-add
    over strided views (each tap one elementwise multiply and add)."""
    r = len(kernel) // 2
    n = x.shape[axis]
    n_out = (n + 2 * r - len(kernel)) // stride + 1
    pad = [0, 0] * (x.dim() - 1 - axis % x.dim()) + [r, r]
    xp = torch.nn.functional.pad(x, pad)
    out = None
    for k, w in enumerate(np.asarray(kernel, np.float32)):
        if w == 0.0:
            continue
        idx = [slice(None)] * x.dim()
        idx[axis] = slice(k, k + stride * (n_out - 1) + 1, stride)
        term = xp[tuple(idx)] * float(w)
        out = term if out is None else out + term
    return out


def lanczos_downsample(img, factor: int, a: int = 3):
    """Downsample [..., H, W] by an integer factor with Lanczos-a
    filtering: rows, then columns, each a strided zero-padded filter."""
    x = img.to(torch.float32)
    if factor == 1:
        return x
    w = _lanczos_kernel_np(float(factor), a)
    x = _strided_filter(x, w, x.dim() - 2, factor)
    return _strided_filter(x, w, x.dim() - 1, factor)


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


def lanczos_resample_scaled(img, out_size, scale_yx,
                            offset_yx=(-0.5, -0.5), a: int = 3):
    """lanczos_resample with explicit per-axis scales (input px per output
    px) and centre offsets, independent of the array shapes (the
    two-stage resample of a decimated, possibly padded intermediate)."""
    oh, ow = out_size
    x = img.to(torch.float32)
    h, w = x.shape[-2:]
    return _apply_rows_cols(
        x, _lanczos_matrix_np(h, oh, a, scale=scale_yx[0],
                              offset=offset_yx[0]),
        _lanczos_matrix_np(w, ow, a, scale=scale_yx[1], offset=offset_yx[1]))
