"""Descriptor-DB tensor parallelism: the kNN-2 over a tp-sharded DB (port
of parallel/sharded_match.py).

The DB's rows are cut into the mesh's tp shards; each shard's slot
computes the top-2 of every query against its rows, and the [tp, Q]
partials merge into the global (d0, d1, i0): the lowest distance, the
lowest global index on a tie, and the second-best over all other rows.
Communication is O(Q·tp), never O(M).

Three makers, as in the JAX package, each bit-identical to a single
kNN-2 over the whole DB:

  * `make_sharded_knn2`: a dense step per shard on unpacked bits;
  * `make_sharded_knn2_blockwise`: the plain blockwise scan per shard on
    packed rows;
  * `make_sharded_knn2_fused`: kernel 4 (csrc/knn2_hamming.cu) per shard
    on a CUDA slot, its plain twin on a CPU slot; each shard's kernel
    layout is made once, when the DB is placed (`.place`).

A call computes one dp row (row 0 unless the serve step names another).
The local work is two functions of tensors on one device:
`shard_partials` (each shard's top-2) and `merge_partials` (their
top-2 merge), composed as `group_top2`. On the card each group of the
row's slots that shares a device runs `group_top2` as one CUDA graph a
key (parallel.mesh.run_graph; the JAX package jits each maker's step).
When one process holds the whole row on one device, that graph is the
call. Otherwise the groups' results move to the row's first local slot
and merge there (eagerly: a top-2 merge of merged groups gives the bits
of one merge of every shard), and in a multi-process mesh the processes
then meet in two `all_reduce(MIN)`s: one over the int32 keys, one over
the second-best candidates. Placing the DB (`place`, kernel 4's
layouts) and the host's row-count check stay outside every graph.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from cubesat_apds_tpu_torch.core.types import Matches
from cubesat_apds_tpu_torch.ops import match as M
from cubesat_apds_tpu_torch.parallel.mesh import (
    Mesh, Placed, run_graph, shard_db)

INVALID_KEY = 2**31 - 1


def check_merge_rows(m_total: int):
    """The merge's int32 keys d·m_total + i reach 513·m_total − 1."""
    if 513 * m_total > 2**31:
        raise ValueError(f"merge keys overflow int32 beyond ~4.18M total "
                         f"rows (got {m_total})")


def _merge_partials(d0_all, d1_all, i0_all, m_total: int):
    """Top-2 merge of [S, Q] per-shard partials (i0 already global):
    the lowest (distance, global index) key wins; the second-best is the
    least of every shard's d1 and the other shards' d0. The 3e38
    sentinel of a shard with no valid row maps to int32-max before the
    integer keys are formed."""
    check_merge_rows(m_total)
    invalid = d0_all >= M.INVALID_DIST
    d_i = torch.where(invalid, 0.0, d0_all).to(torch.int32)
    key = d_i * m_total + i0_all.to(torch.int32)
    key = torch.where(invalid, INVALID_KEY, key)
    best = key.argmin(0, keepdim=True)                         # [1, Q]
    best_d0 = d0_all.gather(0, best)[0]
    best_i0 = i0_all.to(torch.int32).gather(0, best)[0]
    shard = torch.arange(d0_all.shape[0], device=d0_all.device)[:, None]
    d0_masked = torch.where(shard == best, M.INVALID_DIST, d0_all)
    best_d1 = torch.minimum(d1_all.amin(0), d0_masked.amin(0))
    return best_d0, best_d1, best_i0


def _merge_processes(d0, d1, i0, m_total: int):
    """Cross-process merge of each process's merged (d0, d1, i0): two
    all_reduce(MIN)s, one over the int32 keys and one over the
    second-best candidates (this process's d1, and its d0 where another
    process holds the winner)."""
    invalid = d0 >= M.INVALID_DIST
    key = torch.where(invalid, 0.0, d0).to(torch.int32) * m_total + i0
    key = torch.where(invalid, INVALID_KEY, key)
    mine = key.clone()
    dist.all_reduce(key, op=dist.ReduceOp.MIN)
    cand = torch.where(key == mine, d1, torch.minimum(d1, d0))
    dist.all_reduce(cand, op=dist.ReduceOp.MIN)
    none = key == INVALID_KEY
    d0 = torch.where(none, M.INVALID_DIST,
                     torch.div(key, m_total, rounding_mode="floor")
                     .to(torch.float32))
    i0 = torch.where(none, 0, key % m_total).to(torch.int32)
    return d0, cand, i0


def shard_partials(q_bits, local, block, inputs) -> tuple:
    """Each shard's top-2 of `q_bits` on one device: `local(q_bits, shard
    input, block)` for each of `inputs` (in column order) → a tuple of
    (d0, d1, i0 local to the shard)."""
    return tuple(local(q_bits, s, block) for s in inputs)


def merge_partials(partials, offsets, m_total: int):
    """The top-2 merge of per-shard (d0, d1, i0) on one device, shard k's
    indices offset by `offsets[k]` (its first global row, a Python int;
    0 for indices already global) → (d0, d1, i0 global)."""
    d0_all = torch.stack([p[0] for p in partials])
    d1_all = torch.stack([p[1] for p in partials])
    i0_all = torch.stack([p[2].to(torch.int32) + off
                          for p, off in zip(partials, offsets)])
    return _merge_partials(d0_all, d1_all, i0_all, m_total)


def group_top2(q_bits, local, block, inputs, offsets, m_total: int):
    """The merged top-2 of the shards `inputs` that share one device
    (`shard_partials`, then `merge_partials`): the function a device
    group's graph captures."""
    return merge_partials(shard_partials(q_bits, local, block, inputs),
                          offsets, m_total)


def _invalid_top2(q: int, dev):
    return (torch.full((q,), M.INVALID_DIST, device=dev),
            torch.full((q,), M.INVALID_DIST, device=dev),
            torch.zeros(q, dtype=torch.int32, device=dev))


def merge_columns(tp: int, partials: dict, m_shard: int, q: int, dev,
                  across_processes: bool = False):
    """The global top-2 from this process's per-column partials
    {t: (d0, d1, i0 local to shard t)} of a tp-column DB: merged on `dev`,
    then, with `across_processes`, across every process (each calls this
    with the same tp and q, one that holds no column too). Eager: the
    reference the graphed calls are held to."""
    m_total = m_shard * tp
    check_merge_rows(m_total)
    if partials:
        cols = sorted(partials)
        d0, d1, i0 = merge_partials(
            [tuple(x.to(dev) for x in partials[t]) for t in cols],
            [t * m_shard for t in cols], m_total)
    else:
        d0, d1, i0 = _invalid_top2(q, dev)
    if across_processes:
        d0, d1, i0 = _merge_processes(d0, d1, i0, m_total)
    return d0, d1, i0


class ShardedKnn2:
    """fn(q_bits, db, db_valid=None, row=0) → (d0, d1, i0) of dp row `row`'s
    slots, merged on the row's first local slot: `db` a global tensor
    (placed on every call) or a `Placed` from `fn.place(db, db_valid)`.
    In a multi-process mesh every process calls it for the row, and
    every process gets the merged result.

    `local(q_bits, shard input, block)` is one shard's top-2, a
    module-level function (it is part of a graph's key, as is `block`)."""

    def __init__(self, mesh: Mesh, prepare, local, block=None):
        self.mesh = mesh
        self._prepare = prepare      # (db shard, valid shard) → shard input
        self.local = local
        self.block = block

    def place(self, db, db_valid=None) -> Placed:
        """The per-shard inputs on every local slot, sharded over tp and
        replicated over dp; slots that share a device share one input."""
        check_merge_rows(db.shape[0])
        if db_valid is None:
            db_valid = torch.ones(db.shape[0], dtype=torch.bool,
                                  device=db.device)
        db_p, valid_p = shard_db(self.mesh, (db, db_valid))
        made, parts = {}, {}
        for slot, d in db_p.parts.items():
            if id(d) not in made:
                made[id(d)] = self._prepare(d, valid_p.parts[slot])
            parts[slot] = made[id(d)]
        return dataclasses.replace(db_p, parts=parts)

    def group_args(self, placed: Placed, row: int, cols) -> tuple:
        """`group_top2`'s arguments after the queries for the columns
        `cols` of the row: (local, block, their shard inputs, their global
        row offsets, the DB's rows)."""
        m_shard = placed.shape[0] // self.mesh.shape["tp"]
        return (self.local, self.block,
                tuple(placed.parts[(row, t)] for t in cols),
                tuple(t * m_shard for t in cols), placed.shape[0])

    def partials(self, q_bits, placed: Placed, row: int = 0) -> dict:
        """{t: (d0, d1, i0 local to shard t)} of this process's slots of
        the row, eagerly."""
        return {t: self.local(q_bits.to(self.mesh.devices[row, t]),
                              placed.parts[(row, t)], self.block)
                for t in range(self.mesh.shape["tp"])
                if self.mesh.is_local(row, t)}

    def __call__(self, q_bits, db, db_valid=None, row: int = 0):
        mesh = self.mesh
        placed = db if isinstance(db, Placed) else self.place(db, db_valid)
        m_total = placed.shape[0]            # a tp multiple, checked at place
        groups = mesh.row_groups(row)
        tops = [run_graph(group_top2, q_bits.to(dev),
                          *self.group_args(placed, row, cols))
                for dev, cols in groups]
        if mesh.row_device(row) is not None:
            return tops[0]
        dev = groups[0][0] if groups else mesh.home
        if len(tops) > 1:
            top = merge_partials([tuple(x.to(dev) for x in t) for t in tops],
                                 [0] * len(tops), m_total)
        else:
            top = tops[0] if tops else _invalid_top2(q_bits.shape[0], dev)
        if mesh.multiprocess:
            top = _merge_processes(*top, m_total)
        return top


# The dense step's largest [queries, shard rows] distance tile: the JAX
# serve step's query-chunk bound at its default db_block (4096 · 2048).
_DENSE_TILE = 4096 * 2048


def _dense_local(q, shard, block=None):
    """One shard's top-2 by the dense product, in query chunks whose
    distance tile stays within _DENSE_TILE (the bits do not depend on
    the chunking)."""
    db_bits, valid = shard
    q_block = max(_DENSE_TILE // max(db_bits.shape[0], 1), 128)
    if q.shape[0] <= q_block:
        return M.knn2(q, db_bits, db_valid=valid)
    parts = [M.knn2(q[s:s + q_block], db_bits, db_valid=valid)
             for s in range(0, q.shape[0], q_block)]
    return tuple(torch.cat([p[k] for p in parts]) for k in range(3))


def make_sharded_knn2(mesh: Mesh, axis: str = "tp") -> ShardedKnn2:
    """Sharded top-2 on unpacked bits: (q_bits [Q, 512], db_bits [M, 512]
    {0,1}, db_valid [M]) → (d0, d1, i0); a dense product per shard."""
    _check_axis(axis)
    return ShardedKnn2(mesh, _as_shard, _dense_local)


def _as_shard(db, valid):
    return db, valid


def _blockwise_local(q, shard, block):
    return M.knn2_blockwise(q, shard[0], block, shard[1])


def _fused_local(q_bits, layout, block):
    from cubesat_apds_tpu_torch.ops.kernels.match_kernel import (
        knn2_fused, pack_words)

    return knn2_fused(pack_words(M.pack_bits(q_bits)), layout, block=block)


def make_sharded_knn2_blockwise(mesh: Mesh, block: int = 65536,
                                axis: str = "tp") -> ShardedKnn2:
    """Sharded top-2 on PACKED rows ([M, 61] uint8): each shard streams
    its rows through the plain blockwise scan (`ops.match.knn2_blockwise`,
    a block unpacked at a time)."""
    _check_axis(axis)
    return ShardedKnn2(mesh, _as_shard, _blockwise_local, block)


def make_sharded_knn2_fused(mesh: Mesh, db_block: int = 4096,
                            axis: str = "tp") -> ShardedKnn2:
    """Sharded top-2 with kernel 4 per shard on PACKED rows: each shard's
    (words, vpop) layout is made once at `.place`, and every call launches
    the kernel once per shard on a CUDA slot (its plain twin, the
    blockwise scan with blocks of `db_block` rows, on a CPU slot)."""
    from cubesat_apds_tpu_torch.ops.kernels.match_kernel import (
        layout_db_blocks, pack_words)

    _check_axis(axis)
    return ShardedKnn2(
        mesh, lambda db, valid: layout_db_blocks(pack_words(db), valid),
        _fused_local, db_block)


def _check_axis(axis: str):
    if axis != "tp":
        raise ValueError(f"the DB shards over the 'tp' axis, not {axis!r}")


def sharded_knn_match(mesh: Mesh, q_desc_packed, db_desc_packed,
                      ratio: float = 0.3, q_valid=None, db_valid=None,
                      axis: str = "tp") -> Matches:
    """Mesh-parallel knn_match (the reference's get_knn_matches): the DB's
    leading dim must divide by the tp size; pad with db_valid=False."""
    qb = M.unpack_bits(torch.as_tensor(q_desc_packed))
    db = M.unpack_bits(torch.as_tensor(db_desc_packed))
    d0, d1, i0 = make_sharded_knn2(mesh, axis)(qb, db, db_valid)
    if q_valid is not None:
        d0 = torch.where(q_valid.to(d0.device), d0, M.INVALID_DIST)
    return M._ratio_matches(d0, d1, i0, ratio)
