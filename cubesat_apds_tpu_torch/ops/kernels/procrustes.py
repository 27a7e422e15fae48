"""The refit's exact Procrustes rotation (csrc/procrustes3.cu), with its
plain twin.

For a batch of 3×3 cross-covariances S, both return the rotation nearest
to each, R = U·diag(1, 1, sign det(U Vᵀ))·Vᵀ from S = U·diag(s)·Vᵀ, and a
NaN R where S is not finite (the caller's finite-error check then drops
that candidate). The twin is the JAX package's form
(cubesat_apds_tpu/ops/geometry/epnp.py:_procrustes): `torch.linalg.svd` in
S's dtype. The kernel runs a float64 Jacobi SVD, one thread a matrix,
and rounds R to float32; on the card it takes the SVD's place because
cuSOLVER's info check reads back to the host at every call, which
synchronised the serving step and kept it out of a CUDA graph.

`procrustes_rotation` dispatches on the device of S: CPU tensors go to the
twin (so the CPU path and its parity with the JAX package are unchanged),
CUDA tensors to the kernel, anything else raises.
"""

from __future__ import annotations

import torch

from cubesat_apds_tpu_torch.ops.geometry.linalg_small import bmm, det3x3
from cubesat_apds_tpu_torch.ops.kernels import build


def procrustes_rotation_plain(S):
    """Plain twin: R [..., 3, 3] from S [..., 3, 3] through the SVD."""
    # A non-finite S (a failed β case) yields a NaN rotation; torch's SVD
    # would raise.
    finite = torch.isfinite(S).flatten(-2).all(-1)[..., None, None]
    eye = torch.eye(3, dtype=S.dtype, device=S.device)
    U, _, Vt = torch.linalg.svd(torch.where(finite, S, eye))
    d = torch.sign(det3x3(bmm(U, Vt)))
    one = torch.ones_like(d)
    D = torch.diag_embed(torch.stack([one, one, d], dim=-1))
    return torch.where(finite, bmm(bmm(U, D), Vt), torch.nan)


def device_launches(dev) -> int:
    """The kernel's launches on `dev` so far, as the device counted them
    (eager or replayed from a CUDA graph); a synchronising call."""
    return build.device_launches("procrustes3", dev)


def procrustes_rotation_cuda(S):
    """The kernel on a CUDA tensor S [..., 3, 3] float32 → R float32."""
    dev = S.device
    if dev.type != "cuda":
        raise ValueError(f"procrustes_rotation_cuda: S on {dev}, not CUDA")
    if S.dtype != torch.float32 or S.dim() < 2 or S.shape[-2:] != (3, 3):
        raise ValueError("procrustes_rotation_cuda: S must be float32 "
                         f"[..., 3, 3], got {S.dtype} {tuple(S.shape)}")
    S = S.contiguous()
    R = torch.empty_like(S)
    n = S.numel() // 9
    if n == 0:
        return R
    if n >= 1 << 31:
        raise ValueError(f"procrustes_rotation_cuda: {n} matrices, the "
                         "kernel takes fewer than 2^31")
    lib = build.load_kernels().lib
    counter = build.launch_counter("procrustes3", dev)
    with build.on_device(dev):
        err = lib.apds_procrustes3(build.ptr(S), build.ptr(R), n,
                                   build.ptr(counter), build.stream_of(S))
    build.check_launch("apds_procrustes3", err)
    return R


def procrustes_rotation(S):
    """R [..., 3, 3], the rotation nearest to each S [..., 3, 3]: the
    kernel for a CUDA tensor, the plain twin for a CPU one."""
    if S.device.type == "cpu":
        return procrustes_rotation_plain(S)
    if S.device.type != "cuda":
        raise ValueError(f"procrustes_rotation: unsupported device "
                         f"{S.device}")
    return procrustes_rotation_cuda(S)
