"""Kernel 4: Hamming kNN-2 of packed descriptors (csrc/knn2_hamming.cu), with
the layout it reads and the dispatch to its plain twin.

For Q query descriptors against M DB rows, each 61 packed bytes read as 16
little-endian int32 words (bit 32·w + b of a descriptor is bit b of word w;
bytes 61–63 are zero), it returns the best Hamming distance d0, the global
index i0 of the best row (lowest index on a tie) and the second-best
distance d1, which excludes only the winning row. Invalid rows never
match; with no valid row d0 = d1 = 3.0e38 and i0 = 0. These are the
semantics of `ops.match.knn2_blockwise`, the plain twin, bit for bit.

The DB layout (`layout_db_blocks`, made once per DB) is the row-major
[M, 16] int32 word table plus one int32 plane `vpop`: popcount(row) for a
valid row, a sentinel ≥ 2^29 for an invalid one, so the kernel's per-pair
value vpop − 2·popcount(q AND row) is the distance minus popcount(q) for
a valid row and ≥ 2^29 for an invalid one. The DB stays packed in device
memory: the kernel unpacks each tile of it into shared memory (one byte
per bit) and computes popcount(q AND row) as an int8 tensor-core product.

`knn2_fused` dispatches on the device of its tensors: CPU tensors go to
the twin, CUDA tensors to the kernel, anything else raises.
"""

from __future__ import annotations

import ctypes

import torch

from cubesat_apds_tpu_torch.core.config import DESC_BITS_PADDED
from cubesat_apds_tpu_torch.ops.kernels import build

WORDS = DESC_BITS_PADDED // 32          # 16 int32 words per descriptor
VPOP_INVALID = (1 << 29) + 1024         # vpop of an invalid row
BIG = 1 << 29                           # per-pair values ≥ BIG are invalid
QUERIES_PER_BLOCK = 128                 # KNN_QB in knn2_hamming.cu
ROWS_PER_TILE = 128                     # KNN_TILE in knn2_hamming.cu
STAGES = 2                              # KNN_STAGES in knn2_hamming.cu
# KNN_SMEM_BYTES: each stage holds a tile unpacked to one byte per bit and
# its rows' keys; then 5 mbarriers.
SMEM_BYTES = STAGES * ROWS_PER_TILE * (DESC_BITS_PADDED + 4) + 5 * 8
SMEM_LIMIT = 232448                     # an H100 block's shared-memory cap
BLOCKS_PER_SM = 8                       # the split aims at this many per SM
MAX_CHUNK_ROWS = 1 << 20                # KNN_MAX_CHUNK: a key's index field


def pack_words(packed):
    """uint8 [N, ≤64] packed rows → int32 [N, 16] little-endian words
    (rows zero-padded to 64 bytes)."""
    packed = packed.to(torch.uint8)
    n, nb = packed.shape
    pad = WORDS * 4 - nb
    if pad < 0:
        raise ValueError(f"packed rows wider than {WORDS * 4} bytes: {nb}")
    if pad:
        packed = torch.cat([packed, packed.new_zeros((n, pad))], dim=1)
    return packed.contiguous().view(torch.int32)


def _popcount_rows(words):
    """int32 [N, 16] → int32 [N] set bits per row (SWAR on the bytes)."""
    b = words.contiguous().view(torch.uint8)
    b = b - ((b >> 1) & 0x55)
    b = (b & 0x33) + ((b >> 2) & 0x33)
    b = (b + (b >> 4)) & 0x0F
    return b.sum(dim=1, dtype=torch.int32)


def layout_db_blocks(db_words, db_valid=None):
    """The kernel's DB layout, made once per DB: (words int32 [M, 16]
    contiguous, vpop int32 [M]) with vpop = popcount(row) for a valid row
    and VPOP_INVALID for an invalid one."""
    if db_words.dtype != torch.int32 or db_words.dim() != 2 \
            or db_words.shape[1] != WORDS:
        raise ValueError(f"layout_db_blocks: words must be int32 [M, {WORDS}]"
                         f", got {db_words.dtype} {tuple(db_words.shape)}")
    vpop = _popcount_rows(db_words)
    if db_valid is not None:
        vpop = torch.where(db_valid.to(vpop.device), vpop, VPOP_INVALID)
    return db_words.contiguous(), vpop.to(torch.int32).contiguous()


def split_plan(q: int, m: int, sm_count: int):
    """(n_query_blocks, n_split, chunk_rows): the DB is cut into n_split
    contiguous chunks of chunk_rows rows (a multiple of the shared-memory
    tile, at most MAX_CHUNK_ROWS), enough that n_query_blocks · n_split
    blocks fill every SM BLOCKS_PER_SM deep."""
    nqb = -(-q // QUERIES_PER_BLOCK)
    n_tiles = max(-(-m // ROWS_PER_TILE), 1)
    want = max(-(-sm_count * BLOCKS_PER_SM // nqb), 1)
    chunk_tiles = min(max(-(-n_tiles // want), 1),
                      MAX_CHUNK_ROWS // ROWS_PER_TILE)
    n_split = -(-n_tiles // chunk_tiles)
    return nqb, n_split, chunk_tiles * ROWS_PER_TILE


def kernel_info():
    """Kernel 4's chunk kernel as compiled for the current card: tile
    shape, shared memory, registers, spills and resident blocks per SM."""
    info = (ctypes.c_int * 8)()
    build.check_launch("apds_knn2_info",
                       build.load_kernels().lib.apds_knn2_info(info))
    keys = ("queries_per_block", "rows_per_tile", "threads", "smem_bytes",
            "registers", "spill_bytes", "blocks_per_sm", "stages")
    return dict(zip(keys, list(info)))


def knn2_hamming_cuda(q_words, db_words, vpop):
    """Kernel 4 on CUDA tensors: q_words int32 [Q, 16], db_words int32
    [M, 16], vpop int32 [M] (from `layout_db_blocks`) → (d0 f32 [Q],
    d1 f32 [Q], i0 int32 [Q])."""
    dev = q_words.device
    if dev.type != "cuda":
        raise ValueError(f"knn2_hamming_cuda: queries on {dev}, not CUDA")
    q, m = q_words.shape[0], db_words.shape[0]
    want = {"q_words": (q_words, (q, WORDS)), "db_words": (db_words, (m, WORDS)),
            "vpop": (vpop, (m,))}
    for name, (t, shape) in want.items():
        if t.device != dev or t.dtype != torch.int32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"knn2_hamming_cuda: {name} must be a contiguous int32 "
                f"{shape} tensor on {dev}, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"knn2_hamming_cuda: {name} must be 16-byte "
                             "aligned")
    d0 = torch.empty(q, dtype=torch.float32, device=dev)
    d1 = torch.empty(q, dtype=torch.float32, device=dev)
    i0 = torch.empty(q, dtype=torch.int32, device=dev)
    if q == 0:
        return d0, d1, i0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nqb, n_split, chunk = split_plan(q, m, sms)
    partial = torch.empty((n_split, 3, q), dtype=torch.int32, device=dev)
    lib = build.load_kernels().lib
    counter = build.launch_counter("knn2_hamming", dev)
    with build.on_device(dev):
        err = lib.apds_knn2_hamming(
            build.ptr(q_words), build.ptr(db_words), build.ptr(vpop),
            build.ptr(partial), build.ptr(d0), build.ptr(d1), build.ptr(i0),
            q, m, n_split, chunk, build.ptr(counter),
            build.stream_of(q_words))
    build.check_launch("apds_knn2_hamming", err)
    return d0, d1, i0


def device_launches(dev) -> int:
    """Kernel 4's launches on `dev` so far, as the device counted them
    (eager or replayed from a CUDA graph); a synchronising call."""
    return build.device_launches("knn2_hamming", dev)


def knn2_fused(q_words, db_words, db_valid=None, *, block: int = 65536):
    """(d0, d1, i0) of `ops.match.knn2_blockwise` semantics.

    q_words:  int32 [Q, 16] packed query words (`pack_words`). (The JAX
              package's knn2_fused takes unpacked query bits; the port
              packs the queries the same way as the DB.)
    db_words: int32 [M, 16] packed words, OR a (words, vpop) layout from
              `layout_db_blocks` (then db_valid must be None).
    block:    the twin's DB block (CPU tensors only).

    CUDA tensors launch kernel 4; CPU tensors run the plain twin.
    """
    if isinstance(db_words, tuple):
        if db_valid is not None:
            raise ValueError("knn2_fused: validity is baked into the layout")
        words, vpop = db_words
    else:
        words, vpop = None, None
    dev = q_words.device
    if dev.type == "cpu":
        from cubesat_apds_tpu_torch.ops.match import knn2_blockwise, unpack_bits
        if words is not None:
            db_valid = vpop < BIG
            db_words = words
        q_bits = unpack_bits(q_words.contiguous().view(torch.uint8))
        db_bytes = db_words.contiguous().view(torch.uint8)
        return knn2_blockwise(q_bits, db_bytes, block, db_valid)
    if dev.type != "cuda":
        raise ValueError(f"knn2_fused: unsupported device {dev}")
    if words is None:
        words, vpop = layout_db_blocks(db_words, db_valid)
    return knn2_hamming_cuda(q_words.contiguous(), words, vpop)
