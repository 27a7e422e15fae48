"""Kernel B: per-keypoint patch sampler (csrc/sample_patches.cu), with its
plain PyTorch twin.

Both read the bf16 channel-packed level stack [L, Hmax, Wmax, 4]
(Lt, Lx, Ly, 0) at integer sample points (iy, ix) [K, S] of each
keypoint's level, clipped to that level's true (h, w), and return
[K, S, 4] float32 — the gather of the JAX package's
orientation.gather_sampler. The kernel is a direct gather: one thread
per sample, texels read through the read-only cache.

`patch_sampler` dispatches on the stack's device: CPU tensors go to the
twin, CUDA tensors to the kernel, anything else raises. A batch of stacks
[B, L, H, W, 4] folds into the stack axis ([B·L, H, W, 4], image b's
levels at b·L + l), so one launch samples every image's keypoints.
"""

from __future__ import annotations

import torch

from cubesat_apds_tpu_torch.ops.kernels import build

CHANNELS = 4


def sample_patches_plain(packed, level_hw, lvl, iy, ix):
    """Plain twin of kernel B: one flat gather over the stack. Levels and
    level sizes are clamped into the stack, as in the kernel."""
    L, H, W, C = packed.shape
    lvl = lvl.long().clamp(0, L - 1)
    hs = level_hw[lvl, 0][:, None].to(iy.dtype).clamp(1, H)
    ws = level_hw[lvl, 1][:, None].to(ix.dtype).clamp(1, W)
    iy_c = torch.minimum(iy.clamp(min=0), hs - 1)
    ix_c = torch.minimum(ix.clamp(min=0), ws - 1)
    lin = (lvl[:, None] * H + iy_c) * W + ix_c
    return packed.reshape(L * H * W, C)[lin].to(torch.float32)


def sample_patches_cuda(packed, level_hw, lvl, iy, ix):
    """Kernel B on CUDA tensors: packed [L, Hmax, Wmax, 4] bf16;
    level_hw [L, 2], lvl [K], iy/ix [K, S] int32 → [K, S, 4] f32."""
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError(f"sample_patches_cuda: stack on {dev}, not CUDA")
    if packed.dtype != torch.bfloat16 or packed.dim() != 4 \
            or packed.shape[3] != CHANNELS:
        raise ValueError(f"sample_patches_cuda: stack must be [L, H, W, "
                         f"{CHANNELS}] bfloat16, got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    L, Hmax, Wmax, _ = packed.shape
    K, S = iy.shape
    for name, t, want in (("level_hw", level_hw, (L, 2)), ("lvl", lvl, (K,)),
                          ("iy", iy, (K, S)), ("ix", ix, (K, S))):
        if t.dtype != torch.int32 or t.shape != want or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(
                f"sample_patches_cuda: {name} must be a contiguous int32 "
                f"{want} tensor on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if not packed.is_contiguous() or packed.data_ptr() % 8:
        raise ValueError("sample_patches_cuda: stack must be contiguous "
                         "and 8-byte aligned")
    if K * S >= 1 << 31:
        raise ValueError(f"sample_patches_cuda: K·S = {K * S} samples, "
                         "the kernel takes fewer than 2^31")
    out = torch.empty((K, S, CHANNELS), dtype=torch.float32, device=dev)
    if K == 0 or S == 0:
        return out
    lib = build.load_kernels().lib
    with build.on_device(dev):
        err = lib.apds_sample_patches(
            build.ptr(packed), build.ptr(level_hw), build.ptr(lvl),
            build.ptr(iy), build.ptr(ix), build.ptr(out), K, S, L, Hmax,
            Wmax, build.stream_of(packed))
    build.check_launch("apds_sample_patches", err)
    sample_patches_cuda.launches += 1
    return out


sample_patches_cuda.launches = 0


def patch_sampler(packed, level_hw, lvl):
    """sample_fn(iy, ix) → [K, S, 4] f32 for keypoints on levels `lvl`
    (already clipped to [0, L)): kernel B for a CUDA stack, the plain twin
    for a CPU one. A batch — packed [B, L, H, W, 4], lvl [B, n] — samples
    its B·n keypoints, image by image, with iy, ix [B·n, S]."""
    if packed.dim() == 5:
        b, n_lvl = packed.shape[:2]
        offs = torch.arange(b, device=lvl.device)[:, None] * n_lvl
        packed = packed.reshape((b * n_lvl,) + packed.shape[2:])
        level_hw = level_hw.repeat(b, 1)
        lvl = (lvl + offs).reshape(-1)
    dev = packed.device
    if dev.type == "cpu":
        return lambda iy, ix: sample_patches_plain(packed, level_hw, lvl,
                                                   iy, ix)
    if dev.type != "cuda":
        raise ValueError(f"patch_sampler: unsupported device {dev}")
    i32 = [t.to(torch.int32).contiguous() for t in (level_hw, lvl)]

    def sample_fn(iy, ix):
        return sample_patches_cuda(
            packed, *i32, iy.to(torch.int32).contiguous(),
            ix.to(torch.int32).contiguous())

    return sample_fn
