"""Binary descriptor matching, dense branch (port of ops/match.py).

With descriptor bits unpacked to {0,1} vectors a, b of length B,

    hamming(a, b) = popcount(a) + popcount(b) − 2·(a · b)

so the full Q×M distance matrix is one matrix product plus rank-1
corrections. The product runs in float32 on 0/1 values: every partial
sum is an integer ≤ 512, exact in float32 (and in TF32 accumulation), so
the distances are bit-exact. kNN-2 + Lowe ratio semantics, the 3.0e38
invalid sentinel and the lowest-index tie-break follow the JAX package
bit for bit.

A DB of more than `block` rows takes the big-DB branch of `knn_match`:
the CUDA kNN-2 kernel (ops/kernels/match_kernel.py) on the card, and
`knn2_blockwise`, its plain twin, on the CPU or when `kernel="scan"`.
"""

from __future__ import annotations

import torch

from cubesat_apds_tpu_torch.core.config import DESC_BITS_PADDED
from cubesat_apds_tpu_torch.core.types import Matches

INVALID_DIST = 3.0e38               # float32(3.0e38) sentinel
_INVALID_KEY = 2**31 - 1


def unpack_bits(packed):
    """uint8 [..., N, 61] packed (LSB-first per byte) → int8 [..., N, 512]
    in {0,1}, zero-padded past bit 486."""
    packed = packed.to(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    bits = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,))
    pad = DESC_BITS_PADDED - bits.shape[-1]
    if pad > 0:
        bits = torch.cat([bits, bits.new_zeros(bits.shape[:-1] + (pad,))],
                         dim=-1)
    return bits.to(torch.int8)


def pack_bits(bits):
    """{0,1} [..., N, B] → packed uint8 [..., N, ceil(B/8)] (LSB-first)."""
    n_bits = bits.shape[-1]
    n_bytes = (n_bits + 7) // 8
    b = bits.to(torch.uint8)
    pad = n_bytes * 8 - n_bits
    if pad:
        b = torch.cat([b, b.new_zeros(b.shape[:-1] + (pad,))], dim=-1)
    b = b.reshape(b.shape[:-1] + (n_bytes, 8))
    shifts = torch.arange(8, dtype=torch.uint8, device=b.device)
    return (b << shifts).sum(-1).to(torch.uint8)


def hamming_matrix(q_bits, db_bits):
    """q_bits {0,1} [Q, B], db_bits {0,1} [M, B] → int32 [Q, M]."""
    qf = q_bits.to(torch.float32)
    df = db_bits.to(torch.float32)
    dot = (qf @ df.T).to(torch.int32)
    pop_q = q_bits.sum(-1, dtype=torch.int32)
    pop_db = db_bits.sum(-1, dtype=torch.int32)
    return pop_q[:, None] + pop_db[None, :] - 2 * dot


def _top2_with_index(dist, db_valid=None):
    """Per-row two smallest distances + best index, lowest index winning
    among equal distances (int32 keys d·M + i, as in the JAX package)."""
    m = dist.shape[1]
    if 512 * (m + 1) >= _INVALID_KEY:
        raise ValueError(f"DB block of {m} rows too large for int32 keys")
    d_i = dist.clamp(min=0).to(torch.int32)
    idx = torch.arange(m, dtype=torch.int32, device=dist.device)
    key = d_i * m + idx[None, :]
    if db_valid is not None:
        key = torch.where(db_valid[None, :], key, _INVALID_KEY)
    best_key = key.amin(dim=1)
    invalid0 = best_key == _INVALID_KEY
    i0 = torch.where(invalid0, 0, best_key % m).to(torch.int32)
    d0 = torch.where(invalid0, INVALID_DIST,
                     torch.div(best_key, m, rounding_mode="floor")
                     .to(torch.float32))
    key2 = torch.where(key == best_key[:, None], _INVALID_KEY, key)
    second_key = key2.amin(dim=1)
    invalid1 = second_key == _INVALID_KEY
    d1 = torch.where(invalid1, INVALID_DIST,
                     torch.div(second_key, m, rounding_mode="floor")
                     .to(torch.float32))
    return d0, d1, i0


def knn2(q_bits, db_bits, q_valid=None, db_valid=None):
    """(d0, d1, i0) for each query against the whole DB (one block)."""
    d0, d1, i0 = _top2_with_index(hamming_matrix(q_bits, db_bits), db_valid)
    if q_valid is not None:
        d0 = torch.where(q_valid, d0, INVALID_DIST)
        d1 = torch.where(q_valid, d1, INVALID_DIST)
    return d0, d1, i0


def _ratio_matches(d0, d1, i0, ratio: float) -> Matches:
    """Lowe ratio gate: keep m0 iff d0 < d1·ratio."""
    ratio32 = torch.tensor(ratio, dtype=torch.float32, device=d0.device)
    good = (d0 < d1 * ratio32) & (d0 < INVALID_DIST)
    return Matches(
        query_idx=torch.arange(d0.shape[0], dtype=torch.int32,
                               device=d0.device),
        train_idx=i0,
        distance=d0,
        valid=good,
    )


def knn2_blockwise(q_bits, db_bits, block: int, db_valid=None):
    """Streaming top-2 merge over DB blocks: the plain twin of the kNN-2
    kernel (a Python loop in place of the JAX package's lax.scan).

    db_bits: [M, 512] unpacked int8 bits, OR [M, ≤64] packed uint8 rows,
    unpacked one block at a time. If M is not a multiple of `block` the
    DB is padded here with invalid rows. Only O(Q) state is kept between
    blocks; each block is one dense product and `_top2_with_index`.
    """
    m = db_bits.shape[0]
    # Packed or unpacked is told by ROW WIDTH, not dtype alone: unpacked
    # 0/1 bits passed as uint8 must not be unpacked a second time.
    if db_bits.shape[1] <= DESC_BITS_PADDED // 8:
        packed = True
    elif db_bits.shape[1] == DESC_BITS_PADDED:
        packed = db_bits.dtype == torch.uint8
        if packed:
            raise ValueError(
                "ambiguous db_bits: width 512 uint8 — pass unpacked bits "
                "as int8 {0,1} or packed rows as uint8 [M, 61]")
    else:
        raise ValueError(f"bad db_bits width {db_bits.shape[1]}: expected "
                         f"packed ≤{DESC_BITS_PADDED // 8} or unpacked "
                         f"{DESC_BITS_PADDED}")
    dev = q_bits.device
    if db_valid is None:
        db_valid = torch.ones(m, dtype=torch.bool, device=dev)
    q = q_bits.shape[0]
    d0 = torch.full((q,), INVALID_DIST, dtype=torch.float32, device=dev)
    d1 = torch.full((q,), INVALID_DIST, dtype=torch.float32, device=dev)
    i0 = torch.zeros(q, dtype=torch.int32, device=dev)
    for start in range(0, m, block):
        blk = db_bits[start:start + block]
        vblk = db_valid[start:start + block]
        pad = block - blk.shape[0]
        if pad:                                  # ragged tail: invalid rows
            blk = torch.cat([blk, blk.new_zeros((pad, blk.shape[1]))])
            vblk = torch.cat([vblk, vblk.new_zeros(pad)])
        if packed:
            blk = unpack_bits(blk)
        bd0, bd1, bi0 = _top2_with_index(hamming_matrix(q_bits, blk), vblk)
        bi0 = bi0 + start
        # Merge {(d0, i0), d1} with {(bd0, bi0), bd1}: the new best is the
        # smaller (lower index on a tie), the new second-best the least of
        # the other three.
        take_new = (bd0 < d0) | ((bd0 == d0) & (bi0 < i0))
        loser = torch.where(take_new, d0, bd0)
        d0 = torch.where(take_new, bd0, d0)
        i0 = torch.where(take_new, bi0, i0)
        d1 = torch.minimum(torch.minimum(d1, bd1), loser)
    return d0, d1, i0


def knn_match(q_desc_packed, db_desc_packed, ratio: float = 0.3,
              q_valid=None, db_valid=None, block: int | None = None,
              kernel: str = "auto", db_layout=None) -> Matches:
    """k=2 kNN + Lowe ratio on packed uint8 descriptors → Matches of size Q.

    A DB of at most `block` rows (or any DB when `block` is None) is one
    dense product. A larger one takes the big-DB branch: `kernel` "auto"
    or "fused" runs `knn2_fused` (the CUDA kernel on CUDA tensors, its
    plain twin on CPU tensors); "scan" runs the twin `knn2_blockwise` on
    either device. All are bit-identical. `db_layout` is an optional
    `layout_db_blocks` result for this (DB, db_valid), made once per DB
    by serving paths; the scan ignores it. In this branch `q_valid` masks
    d0 only, as in the JAX package.
    """
    if block is not None and db_desc_packed.shape[0] > block:
        if kernel in ("auto", "fused"):
            from cubesat_apds_tpu_torch.ops.kernels.match_kernel import (
                knn2_fused, pack_words)
            q_words = pack_words(q_desc_packed)
            if db_layout is not None:
                d0, d1, i0 = knn2_fused(q_words, db_layout, block=block)
            else:
                d0, d1, i0 = knn2_fused(q_words, pack_words(db_desc_packed),
                                        db_valid, block=block)
        elif kernel == "scan":
            d0, d1, i0 = knn2_blockwise(unpack_bits(q_desc_packed),
                                        db_desc_packed, block, db_valid)
        else:
            raise ValueError(f"knn_match: unknown kernel {kernel!r}")
        if q_valid is not None:
            d0 = torch.where(q_valid, d0, INVALID_DIST)
    else:
        d0, d1, i0 = knn2(unpack_bits(q_desc_packed),
                          unpack_bits(db_desc_packed), q_valid, db_valid)
    return _ratio_matches(d0, d1, i0, ratio)


def knn_match_bits(q_bits, db_bits, ratio: float = 0.3,
                   q_valid=None, db_valid=None,
                   q_block: int | None = None) -> Matches:
    """knn_match on unpacked bit arrays, optionally in chunks of `q_block`
    queries (bounds the [q_block, M] distance matrix)."""
    q = q_bits.shape[0]
    if q_block is None or q <= q_block:
        d0, d1, i0 = knn2(q_bits, db_bits, q_valid, db_valid)
    else:
        parts = [knn2(q_bits[s:s + q_block], db_bits,
                      None if q_valid is None else q_valid[s:s + q_block],
                      db_valid)
                 for s in range(0, q, q_block)]
        d0, d1, i0 = (torch.cat([p[j] for p in parts]) for j in range(3))
    return _ratio_matches(d0, d1, i0, ratio)


def knn_matches_k(q_desc_packed, db_desc_packed, k: int,
                  q_valid=None, db_valid=None):
    """General k-nearest-neighbour search: (distances [Q, k] float32,
    indices [Q, k] int32), ordered by (distance, index). Entries past the
    number of valid DB rows carry the invalid sentinel and index 0."""
    dist = hamming_matrix(unpack_bits(q_desc_packed),
                          unpack_bits(db_desc_packed))
    m = dist.shape[1]
    if 512 * (m + 1) >= _INVALID_KEY:
        raise ValueError(f"DB of {m} rows too large for int32 keys")
    idx = torch.arange(m, dtype=torch.int32, device=dist.device)
    key = dist * m + idx[None, :]
    if db_valid is not None:
        key = torch.where(db_valid[None, :], key, _INVALID_KEY)
    top_key = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    invalid = top_key == _INVALID_KEY
    d = torch.where(invalid, INVALID_DIST,
                    torch.div(top_key, m, rounding_mode="floor")
                    .to(torch.float32))
    i = torch.where(invalid, 0, top_key % m).to(torch.int32)
    if q_valid is not None:
        d = torch.where(q_valid[:, None], d, INVALID_DIST)
    return d, i


def crosscheck_match(q_desc_packed, db_desc_packed,
                     q_valid=None, db_valid=None) -> Matches:
    """Mutual nearest neighbours (BFMatcher NORM_HAMMING with crosscheck)."""
    dist = hamming_matrix(unpack_bits(q_desc_packed),
                          unpack_bits(db_desc_packed))
    d0, _, i0 = _top2_with_index(dist, db_valid)
    _, _, i0_r = _top2_with_index(dist.T, q_valid)     # each train's best query
    q = dist.shape[0]
    arange_q = torch.arange(q, dtype=torch.int32, device=dist.device)
    ok = (i0_r[i0.long()] == arange_q) & (d0 < INVALID_DIST)
    if q_valid is not None:
        ok = ok & q_valid
    return Matches(query_idx=arange_q, train_idx=i0, distance=d0, valid=ok)


def matched_points(kp_query_xy, kp_train_xy, matches: Matches):
    """Matched point pairs (fixed capacity; use matches.valid)."""
    return (kp_query_xy[matches.query_idx.long()],
            kp_train_xy[matches.train_idx.long()])
