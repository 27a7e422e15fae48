"""Small batched linear algebra (port of ops/geometry/linalg_small.py).

The same closed forms and fixed iteration counts as the JAX package
(unrolled Cholesky, cyclic Jacobi, damped inverse iteration, Newton
polar), so that degenerate RANSAC hypotheses fail the same way: the
damping and floors here decide what a singular minimal sample returns.
All functions batch over leading dimensions and never synchronise with
the host: their constants (the Jacobi one-hot matrices, the inverse
iteration's start basis) are uploaded once per device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from apds_bench.reference.types_ import device_const


def _matmul_precision():
    """torch's float32 matmul precision, or None where the caller has set
    TF32 through both of torch's APIs and they disagree (torch then
    refuses to read it)."""
    try:
        return torch.get_float32_matmul_precision()
    except RuntimeError:
        return None


def highest_matmul_precision(fn):
    """Run the wrapped call with TF32 off for float32 matmuls
    (`torch.backends.cuda.matmul.allow_tf32 = False` and
    `torch.set_float32_matmul_precision("highest")`), then restore the
    caller's settings.

    The solvers' contractions (DLT normal equations, the EPnP null
    space, Gauss-Newton steps) need full float32: TF32 keeps 10 mantissa
    bits, the error the JAX package saw as kilometre-scale positions
    when the TPU ran them in bfloat16. The port's solvers are wrapped,
    so a caller that turned TF32 on does not reach them.
    """
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        matmul = torch.backends.cuda.matmul
        precision, tf32 = _matmul_precision(), matmul.allow_tf32
        torch.set_float32_matmul_precision("highest")
        matmul.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            if precision is not None:
                torch.set_float32_matmul_precision(precision)
            if matmul.allow_tf32 != tf32:
                matmul.allow_tf32 = tf32
    return wrapper


def inv3x3(A):
    """Adjugate inverse of [..., 3, 3]."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.where(det.abs() < 1e-20, 1e-20, det)
    adj = torch.stack([
        torch.stack([A11, A12, A13], -1),
        torch.stack([A21, A22, A23], -1),
        torch.stack([A31, A32, A33], -1),
    ], -2)
    return adj / det[..., None, None]


def det3x3(A):
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def bmm(a, b):
    """a [..., m, k] @ b [..., k, n], leading dimensions broadcast, as
    elementwise products summed over k: one matrix's product has the same
    bits whatever batch surrounds it (a library product picks its kernel,
    and so its order of summation, by the size of the batch), so a frame
    of a batch gets the bits it gets alone. Used by every product of the
    pose and homography solvers."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def cholesky_solve(A, b, damp: float = 0.0):
    """Solve A x = b for symmetric positive-definite [..., N, N] (N ≤ ~8)
    via unrolled Cholesky with pivots floored at 1e-20. b: [..., N] or
    [..., N, M]."""
    n = A.shape[-1]
    if damp:
        A = A + damp * _eye(n, A)
    vec = b.dim() == A.dim() - 1
    if vec:
        b = b[..., None]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(s.clamp(min=1e-20))
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i, :]
        for k in range(i):
            s = s - L[i][k][..., None] * y[k]
        y[i] = s / L[i][i][..., None]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i][..., None] * x[k]
        x[i] = s / L[i][i][..., None]
    out = torch.stack(x, dim=-2)
    return out[..., 0] if vec else out


def lstsq_normal(A, b, damp: float = 1e-9):
    """Least squares via normal equations + unrolled Cholesky.
    A: [..., M, N] (N small), b: [..., M]."""
    At = A.transpose(-1, -2)
    AtA = bmm(At, A)
    Atb = bmm(At, b[..., None])[..., 0]
    return cholesky_solve(AtA, Atb, damp=damp)


def _one_hot(k: int, p: int, q: int):
    """The unit matrices at (p, p), (q, q), (p, q) and (q, p), [4, k, k]."""
    hot = np.zeros((4, k, k))
    hot[0, p, p] = hot[1, q, q] = hot[2, p, q] = hot[3, q, p] = 1.0
    return hot


def _givens(S, p: int, q: int):
    """One cyclic-Jacobi rotation zeroing S[p, q] of symmetric [..., k, k]:
    returns the rotation G (S ← Gᵀ S G)."""
    k = S.shape[-1]
    app, aqq, apq = S[..., p, p], S[..., q, q], S[..., p, q]
    tiny = apq.abs() < 1e-30
    tau = (aqq - app) / (2.0 * torch.where(tiny, 1e-30, apq))
    s_tau = torch.where(tau >= 0, 1.0, -1.0)      # ±1, never sign(0) = 0
    t = s_tau / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tiny, 0.0, t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    hot = device_const(_one_hot(k, p, q), S.dtype, S.device)
    cm1 = (c - 1.0)[..., None, None]
    sm = s[..., None, None]
    return (_eye(k, S) + cm1 * (hot[0] + hot[1]) + sm * hot[2]
            - sm * hot[3])


def _jacobi(S, iters: int):
    """Cyclic Jacobi on symmetric [..., k, k] → (eigvals ascending,
    eigvecs as columns)."""
    k = S.shape[-1]
    V = _eye(k, S).expand(S.shape).clone()
    for _ in range(iters):
        for p in range(k):
            for q in range(p + 1, k):
                G = _givens(S, p, q)
                S = bmm(bmm(G.transpose(-1, -2), S), G)
                V = bmm(V, G)
    w = torch.diagonal(S, dim1=-2, dim2=-1)
    order = torch.argsort(w, dim=-1)
    w_sorted = torch.take_along_dim(w, order, dim=-1)
    V_sorted = torch.take_along_dim(V, order[..., None, :], dim=-1)
    return w_sorted, V_sorted


def eigh3x3(A, iters: int = 4):
    """Symmetric 3×3 eigendecomposition by cyclic Jacobi sweeps:
    (eigvals ascending [..., 3], eigvecs as COLUMNS [..., 3, 3])."""
    return _jacobi(A, iters)


def _mgs_orthonormalize(Q):
    """Modified Gram-Schmidt on the COLUMNS of [..., n, k]; a collapsed
    column is replaced by a fixed unit vector."""
    n, k = Q.shape[-2], Q.shape[-1]
    cols = [Q[..., :, j] for j in range(k)]
    for j in range(k):
        v = cols[j]
        for i in range(j):
            v = v - (cols[i] * v).sum(-1, keepdim=True) * cols[i]
        norm = torch.sqrt((v * v).sum(-1, keepdim=True))
        fallback = device_const(np.eye(n)[j % n], Q.dtype, Q.device)
        v = torch.where(norm < 1e-20, fallback, v / norm.clamp(min=1e-20))
        cols[j] = v
    return torch.stack(cols, dim=-1)


def _start_basis(n: int, k: int):
    """The inverse iteration's fixed orthonormal start [n, k] (float32)."""
    rng = np.random.default_rng(12345)
    return np.linalg.qr(rng.standard_normal((n, k)))[0].astype(np.float32)


def eigh_smallest(A, k: int = 4, iters: int = 3):
    """k smallest-eigenvalue eigenvectors of symmetric PSD [..., n, n]
    (damped inverse iteration + Jacobi Rayleigh-Ritz), columns ordered
    by ascending eigenvalue."""
    n = A.shape[-1]
    diag_mean = torch.diagonal(A, dim1=-2, dim2=-1).mean(-1)[..., None, None]
    eps = 1e-5 * diag_mean.clamp(min=1e-30)
    Ad = A + eps * _eye(n, A)
    Q = device_const(_start_basis(n, k), A.dtype, A.device).expand(
        A.shape[:-2] + (n, k))
    for _ in range(iters):
        Q = _mgs_orthonormalize(cholesky_solve(Ad, Q))
    S = bmm(Q.transpose(-1, -2), bmm(A, Q))
    S = 0.5 * (S + S.transpose(-1, -2))
    _, U = _jacobi(S, 6)
    return bmm(Q, U)


def polar_rotation(S, iters: int = 8):
    """Nearest rotation to [..., 3, 3] S (det(S) > 0 branch) by Newton
    polar iteration X ← (X + X⁻ᵀ)/2."""
    norm = torch.sqrt((S * S).sum(dim=(-2, -1), keepdim=True) / 3.0)
    X = S / torch.where(norm < 1e-20, 1e-20, norm)
    for _ in range(iters):
        X = 0.5 * (X + inv3x3(X).transpose(-1, -2))
    return X
