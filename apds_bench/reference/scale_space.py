"""AKAZE nonlinear (FED) scale space (port of ops/features/scale_space.py).

Same structure as the JAX package: level (o, j) has σ = soffset·2^(j/S+o)
and diffusion time t = σ²/2; a new octave half-samples the diffused image
and scales the contrast factor by 0.75; per level, Lsmooth = G(σ=1)·Lt,
conductance g = PM-G2(∇Lsmooth, k) and one FED cycle (kernel A on CUDA)
with the τ schedule of `fed_tau_by_process_time`. The step `nld_step`
and its plain cycle `fed_cycle` live beside the kernel, in
ops/kernels/diffusion.py, and are imported here too. A batch [B, H, W]
builds every image's scale space at once (one kernel-A launch per level
for the batch); each image keeps its own contrast factor, and every
operation acts on each image alone, so an image gives the same bits in a
batch as alone.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

from apds_bench.reference.config import AkazeConfig
from apds_bench.reference.types_ import device_const
from apds_bench.reference.twins import fed_cycle_fused
from apds_bench.reference.resample import (
    gaussian_blur, half_sample, separable_conv2d)


def fed_tau_by_process_time(T: float, tau_max: float = 0.25) -> np.ndarray:
    """τ schedule for one FED cycle covering diffusion time T."""
    n = int(math.ceil(math.sqrt(3.0 * T / tau_max + 0.25) - 0.5 - 1e-8))
    n = max(n, 1)
    scale = 3.0 * T / (tau_max * n * (n + 1))
    c = 1.0 / (4.0 * n + 2.0)
    d = scale * tau_max / 2.0
    k = np.arange(n)
    tau = d / np.cos(np.pi * (2.0 * k + 1.0) * c) ** 2
    return tau.astype(np.float32)


# Unnormalized Scharr kernels (OpenCV cv::Scharr defaults).
_SCHARR_SMOOTH = np.array([3.0, 10.0, 3.0], np.float32)
_SCHARR_DERIV = np.array([-1.0, 0.0, 1.0], np.float32)


def scharr_x(img):
    """∂x with unnormalized Scharr (smooth in y, differentiate in x)."""
    return separable_conv2d(img, _SCHARR_SMOOTH, _SCHARR_DERIV,
                            pad_mode="reflect")


def scharr_y(img):
    return separable_conv2d(img, _SCHARR_DERIV, _SCHARR_SMOOTH,
                            pad_mode="reflect")


def pm_g2(lx, ly, k):
    """Perona–Malik G2 conductance: g = 1 / (1 + |∇L|²/k²)."""
    return 1.0 / (1.0 + (lx * lx + ly * ly) / (k * k))


def compute_k_percentile(img, percentile: float = 0.7, gscale: float = 1.0,
                         nbins: int = 300):
    """Contrast factor k: `percentile` of the gradient-magnitude histogram.

    Picks the same bin as the JAX package: the smallest k in [1, nbins]
    with #{non-zero |∇|² < (k·hmax/nbins)²} ≥ ⌊percentile·npoints⌋, found
    by the same 9-round bisection over the same f32 thresholds, on the
    device and without a host round trip. Borders excluded. img [..., H,
    W] → k [...]: one per image (the max and the counts are per image).
    """
    smooth = gaussian_blur(img, gscale)
    lx = scharr_x(smooth)[..., 1:-1, 1:-1]
    ly = scharr_y(smooth)[..., 1:-1, 1:-1]
    modg2 = lx * lx + ly * ly
    hw = (-2, -1)
    hmax = torch.sqrt(modg2.amax(dim=hw))
    nz = modg2 > 0.0
    npoints = nz.sum(dim=hw)
    nthreshold = (npoints.to(torch.float32) * percentile).to(torch.int32)
    lo = torch.zeros(hmax.shape, dtype=torch.int32, device=img.device)
    hi = torch.full(hmax.shape, nbins, dtype=torch.int32, device=img.device)
    # A tensor divisor: CUDA divides by a Python number as a product with
    # its reciprocal, which differs from the CPU's (and JAX's) quotient in
    # the last bit.
    n = device_const(float(nbins), torch.float32, img.device)
    for _ in range(9):          # 2^9 = 512 ≥ nbins = 300
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        t = (mid.to(torch.float32) * hmax / n) ** 2
        below = (nz & (modg2 < t[..., None, None])).sum(dim=hw) < nthreshold
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    kperc = hmax * hi.to(torch.float32) / n
    return torch.where(npoints.to(torch.float32) * percentile < 1.0,
                       device_const(0.03, torch.float32, img.device), kperc)


@dataclasses.dataclass(frozen=True)
class LevelMeta:
    """Static per-level metadata."""

    octave: int
    sublevel: int
    esigma: float        # scale in original-image pixels
    etime: float         # diffusion time = esigma²/2
    ratio: int           # 2^octave
    sigma_size: int      # round(esigma·derivative_factor / ratio)
    border: int          # detection border in level pixels


def evolution_metadata(config: AkazeConfig) -> List[LevelMeta]:
    levels = []
    for o in range(config.octaves):
        for j in range(config.sublevels):
            esigma = config.soffset * (2.0 ** (j / config.sublevels + o))
            ratio = 1 << o
            sigma_size = int(round(esigma * config.derivative_factor / ratio))
            border = sigma_size * 2 + 1
            levels.append(LevelMeta(
                octave=o, sublevel=j, esigma=esigma,
                etime=0.5 * esigma * esigma, ratio=ratio,
                sigma_size=max(sigma_size, 1), border=border))
    return levels


@dataclasses.dataclass
class ScaleSpace:
    """Per level (index o·S + j): Lt (diffused) and Lsmooth (σ=1 blur of
    the level's pre-diffusion image) at [..., H/2^o, W/2^o], and the
    contrast factor of each image [...]."""

    Lt: List[torch.Tensor]
    Lsmooth: List[torch.Tensor]
    meta: List[LevelMeta]
    kcontrast: torch.Tensor


def build_scale_space(img, config: AkazeConfig = AkazeConfig(),
                      kcontrast=None, batched: bool = False,
                      precision: str = "float32") -> ScaleSpace:
    """img: [H, W] or a batch [B, H, W], float32 in [0, 1] → 16-level
    nonlinear scale space.

    `kcontrast` overrides the per-image contrast factor (a scalar, or one
    per image). `batched` is accepted and ignored, as in
    `fed_cycle_fused`. `precision="bfloat16"` rounds every level to
    bfloat16 as it is made (the check's lower-precision control).
    """
    if precision not in ("float32", "bfloat16"):
        raise ValueError(f"build_scale_space: precision {precision!r}")

    def level(x):
        if precision == "bfloat16":
            return x.to(torch.bfloat16).to(torch.float32)
        return x

    img = img.to(torch.float32)
    meta = evolution_metadata(config)
    if kcontrast is None:
        kcontrast0 = compute_k_percentile(
            img, config.kcontrast_percentile, 1.0, config.kcontrast_nbins)
    else:
        kcontrast0 = torch.as_tensor(kcontrast, dtype=torch.float32,
                                     device=img.device).expand(img.shape[:-2])

    Lt = level(gaussian_blur(img, config.soffset))
    Lt_list = [Lt]
    Ls_list = [gaussian_blur(Lt, 1.0)]
    kcontrast = kcontrast0
    for i in range(1, len(meta)):
        if meta[i].octave > meta[i - 1].octave:
            Lt = half_sample(Lt)
            kcontrast = kcontrast * 0.75
        Lsmooth = gaussian_blur(Lt, 1.0)
        g = pm_g2(scharr_x(Lsmooth), scharr_y(Lsmooth),
                  kcontrast[..., None, None])
        taus = fed_tau_by_process_time(
            meta[i].etime - meta[i - 1].etime, config.fed_tau_max)
        Lt = level(fed_cycle_fused(Lt, g, taus))
        Lt_list.append(Lt)
        Ls_list.append(Lsmooth)
    return ScaleSpace(Lt=Lt_list, Lsmooth=Ls_list, meta=meta,
                      kcontrast=kcontrast0)
