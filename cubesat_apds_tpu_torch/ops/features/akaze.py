"""AKAZE detect-and-compute over a batch of images (port of
ops/features/akaze.py:detect_and_compute and detect_and_compute_batch).

Scale space (kernel A per FED cycle on CUDA, one launch per level for
the batch) → det-Hessian detection → bf16 channel-packed level stacks →
orientation and MLDB descriptors, both sampled through kernel B on CUDA
(one launch each for the batch). The approximate descriptor modes
("fast", "hybrid") also build three blur-matched stacks, one per MLDB
grid, and sample each through its own kernel-B launch. The per-keypoint
stages run on a rung of the capacity ladder (`_bucket_sizes`), the
smallest prefix that holds the batch's largest live count, as the JAX
package's `lax.switch` picks it: on the card a CUDA graph picks the rung
on the device (ops/features/ladder.py), so a call reads nothing back to
the host; on the CPU the count is read on the host. Invalid slots come
out as zeros either way, so every rung gives the same bits. One image is
a batch of one.

On the card the front half (`_front_end`: the scale space, detection
and the level stacks) replays one CUDA graph a key, the counterpart of
the JAX package's jit of `detect_and_compute_batch` (core/step_graph.py
captures it; the key holds the shapes, dtypes and devices of the images
and of `kcontrast`, the configuration, the capacity and the stream). Up
to `FRONT_GRAPHS` of them stay cached; `clear_front_graphs()` drops
them and frees their pools. `_front_end` stays callable eagerly, as the
graph's reference.

`detect_and_compute_tiled` covers images past one scale space with
overlapping tiles, a global contrast factor and a seam dedup.
"""

from __future__ import annotations

import numpy as np
import torch

from cubesat_apds_tpu_torch.core import step_graph
from cubesat_apds_tpu_torch.core.config import AkazeConfig
from cubesat_apds_tpu_torch.core.graph_cache import GraphCache, close_all
from cubesat_apds_tpu_torch.core.types import (
    Features, Keypoints, device_const, select, upload)
from cubesat_apds_tpu_torch.ops.features.detect import detect_keypoints
from cubesat_apds_tpu_torch.ops.features.ladder import run_ladder
from cubesat_apds_tpu_torch.ops.features.mldb import (
    approx_blur_sigmas_fn, approx_mldb_fn, mldb_descriptors)
from cubesat_apds_tpu_torch.ops.features.orientation import (
    compute_orientations)
from cubesat_apds_tpu_torch.ops.features.scale_space import build_scale_space
from cubesat_apds_tpu_torch.ops.kernels.sample_kernel import patch_sampler
from cubesat_apds_tpu_torch.ops.resample import gaussian_blur

FRONT_GRAPHS = 8
_FRONT = GraphCache(FRONT_GRAPHS)


def clear_front_graphs() -> int:
    """Drop every cached front-half graph and free its memory pool;
    returns how many there were."""
    entries = _FRONT.clear()
    close_all(entries)
    return len(entries)


def front_graphs() -> list:
    """The cached front-half graphs, least recently used first (their
    `key`, `nodes`, `pool_bytes`, `warmup_s`, `capture_s` and
    `warmup_launches`)."""
    return _FRONT.entries()


def _packed_stack(lt, lx, ly) -> torch.Tensor:
    """[B, L, H, W, 4] channel-packed (Lt, Lx, Ly, 0) stacks in bfloat16
    (round to nearest even, as JAX's astype), each level zero-padded to
    the largest. Each level is written into its channel of the output
    directly, so no float32 stack of all the levels is ever made."""
    hmax = max(a.shape[-2] for a in lt)
    wmax = max(a.shape[-1] for a in lt)
    out = lt[0].new_zeros((lt[0].shape[0], len(lt), hmax, wmax, 4),
                          dtype=torch.bfloat16)
    for c, levels in enumerate((lt, lx, ly)):
        for i, a in enumerate(levels):
            out[:, i, :a.shape[-2], :a.shape[-1], c] = a
    return out


def _grid_stacks(ss, lx, ly, config: AkazeConfig):
    """The approximate modes' blur-matched stacks: for each MLDB grid g a
    [B, L, H, W, 4] packed stack of every level's (Lt, Lx, Ly) blurred
    together with that level's matched σ (approx_blur_sigmas_fn). The JAX
    package concatenates the three along the level axis ([3L, H, W, 4]);
    here each grid keeps its own tensor, so each is one contiguous
    kernel-B stack. None in exact mode."""
    if config.descriptor_mode == "exact":
        return None
    sigmas_fn = approx_blur_sigmas_fn(config)
    base3 = [torch.stack([ss.Lt[i], lx[i], ly[i]], dim=1)
             for i in range(len(ss.Lt))]                     # [B, 3, h, w]
    grids = []
    for g in range(3):
        blurred = [gaussian_blur(base3[i], sigmas_fn(m.sigma_size)[g])
                   for i, m in enumerate(ss.meta)]
        grids.append(_packed_stack([b[:, 0] for b in blurred],
                                   [b[:, 1] for b in blurred],
                                   [b[:, 2] for b in blurred]))
    return tuple(grids)


def _bucket_sizes(capacity: int, n: int) -> tuple:
    """Linear capacity ladder: rungs every max(capacity/n, 256) slots,
    rounded up to a multiple of 128 (smallest first, last == capacity);
    n <= 1 gives the one rung `capacity`. A copy of the JAX package's
    ops/features/akaze.py:_bucket_sizes."""
    if n <= 1:
        return (capacity,)
    spacing = max(-(-capacity // n), 256)
    spacing = -(-spacing // 128) * 128
    sizes = set(range(spacing, capacity, spacing))
    sizes.add(capacity)
    return tuple(sorted(sizes))


def rung_index(count, buckets):
    """The ladder rung that holds `count` live slots: Σ_b (count > b) over
    every rung but the last, the JAX package's switch index, as int32
    torch ops on count's device (no host read)."""
    idx = torch.zeros_like(count, dtype=torch.int32)
    for b in buckets[:-1]:
        idx = idx + (count > b).to(torch.int32)
    return idx


def detect_and_compute_batch(imgs, config: AkazeConfig = AkazeConfig(),
                             capacity: int | None = None,
                             kcontrast=None) -> Features:
    """imgs: [B, H, W] float32 grayscale in [0, 1] (tensor; its device
    picks the path) → Features [B, capacity], each image's keypoints
    response-sorted and capacity-padded: the same bits as
    `detect_and_compute` on each image alone.

    The front end runs on the whole batch (one kernel-A launch per level):
    on the card through this key's CUDA graph (captured at the key's
    first call, which may synchronise), on the CPU eagerly. The
    per-keypoint stages run once for the batch, on the capacity
    ladder's rung for the batch's largest live count
    (`adaptive_orient_describe`; at `config.adaptive_buckets` <= 1 on all
    `capacity` slots): on the card the rung is picked on the device, so
    a warmed call reads nothing back to the host and only queues work.
    `kcontrast` (a number, or one per image) overrides the images'
    contrast factors. The detector's top-K is exact whatever
    `config.detect_topk` says, and `config.sampler` is ignored: on CUDA
    both per-keypoint stages sample through kernel B, on CPU through the
    plain gather.
    `config.descriptor_mode` and `config.orientation_mode` select the
    JAX package's exact, fast and hybrid sampling.
    """
    capacity = capacity or config.capacity
    imgs = torch.as_tensor(imgs, dtype=torch.float32)
    if imgs.dim() != 3:
        raise ValueError(f"detect_and_compute_batch: [B, H, W] images, got "
                         f"{tuple(imgs.shape)}")
    if kcontrast is not None:
        kcontrast = upload(kcontrast, imgs.device, torch.float32)
    kps, packed, level_hw, grids = front_half(imgs, config, capacity,
                                              kcontrast)
    angle, desc = adaptive_orient_describe(kps, packed, level_hw, config,
                                           grids)
    kps = Keypoints(xy=kps.xy, size=kps.size, angle=angle,
                    response=kps.response, octave=kps.octave,
                    class_id=kps.class_id, valid=kps.valid)
    return Features(keypoints=kps, descriptors=desc)


def front_half(imgs, config: AkazeConfig, capacity: int, kcontrast):
    """`_front_end(imgs, config, capacity, kcontrast)`: on the card
    through this key's CUDA graph (its pool starts as one block of the
    warm-up's peak), on the CPU eagerly. `kcontrast` is None or a float32
    tensor on the images' device."""
    return step_graph.run(_FRONT, _front_end, imgs, config, capacity,
                          kcontrast, prime_pool=True)


def _front_end(imgs, config: AkazeConfig, capacity: int, kcontrast):
    """Scale space, detection and the packed level stacks of a batch:
    (keypoints without angles, packed [B, L, H, W, 4], level_hw [L, 2],
    the approximate modes' grid stacks or None). Eager: the function the
    front half's graph captures, and its reference on the card."""
    ss = build_scale_space(imgs, config, kcontrast)
    kps, lx_list, ly_list = detect_keypoints(ss, config, capacity)
    packed = _packed_stack(ss.Lt, lx_list, ly_list)
    level_hw = device_const([list(a.shape[-2:]) for a in ss.Lt],
                            torch.int32, imgs.device)
    return kps, packed, level_hw, _grid_stacks(ss, lx_list, ly_list, config)


def _stage(xy, size, class_id, octave, valid, packed, level_hw, n: int,
           config: AkazeConfig, grids):
    """Orientation and MLDB descriptors of the first `n` slots of every
    image → (angle [B, n], desc [B, n, 61]): the body of each ladder rung.
    Both stages sample through one `patch_sampler` (kernel B on the card)
    over the batch's stacks; in the approximate descriptor modes `grids`
    holds `_grid_stacks`' three stacks, each sampled on its own (one
    kernel-B launch a grid on the card)."""
    bsz = valid.shape[0]
    lvl = class_id[:, :n].clamp(0, packed.shape[1] - 1)
    xy, size, class_id, octave, valid = (
        t[:, :n].reshape((bsz * n,) + t.shape[2:])
        for t in (xy, size, class_id, octave, valid))
    sample_fn = patch_sampler(packed, level_hw, lvl)
    # Both stages sample through sample_fn, so they get one image's
    # stack only for its shape.
    a = compute_orientations(packed[0], level_hw, xy, size, class_id,
                             octave, valid, sample_fn=sample_fn,
                             mode=config.orientation_mode)
    if config.descriptor_mode == "exact":
        d = mldb_descriptors(packed[0], level_hw, xy, size, a, class_id,
                             octave, valid, sample_fn=sample_fn)
    else:
        d = approx_mldb_fn(config)(grids, level_hw, xy, size, a, class_id,
                                   octave, valid)
    return a.reshape(bsz, n), d.reshape(bsz, n, 61)


def orient_describe(kps: Keypoints, packed, level_hw, n: int,
                    config: AkazeConfig = AkazeConfig(), grids=None):
    """Orientation and MLDB descriptors of the first `n` slots of every
    image of the batch → (angle [B, capacity], desc [B, capacity, 61]),
    zero past slot n. Invalid slots come out as zeros from both stages'
    masks, and the valid keypoints are a response-sorted prefix, so any
    n at or above the batch's largest live count gives the same bits."""
    bsz, capacity = kps.valid.shape
    dev = kps.xy.device
    angle = torch.zeros((bsz, capacity), dtype=torch.float32, device=dev)
    desc = torch.zeros((bsz, capacity, 61), dtype=torch.uint8, device=dev)
    if n == 0:
        return angle, desc
    angle[:, :n], desc[:, :n] = _stage(
        kps.xy, kps.size, kps.class_id, kps.octave, kps.valid, packed,
        level_hw, n, config, grids)
    return angle, desc


def adaptive_orient_describe(kps: Keypoints, packed, level_hw,
                             config: AkazeConfig = AkazeConfig(),
                             grids=None):
    """`orient_describe` on the smallest rung of
    `_bucket_sizes(capacity, config.adaptive_buckets)` that holds the
    batch's largest live count: the JAX package's
    `_adaptive_orient_describe_batched` (a batch of one gets its per-image
    ladder's rung, the same one). On the card the device picks the rung,
    in a CUDA graph with one switch branch a rung (`ladder.run_ladder`);
    on the CPU the count is read on the host. One rung
    (`adaptive_buckets` <= 1) runs every capacity slot, as the JAX
    package's plain path does."""
    capacity = kps.valid.shape[1]
    buckets = _bucket_sizes(capacity, config.adaptive_buckets)
    if len(buckets) == 1:
        return orient_describe(kps, packed, level_hw, capacity, config,
                               grids)
    dev = packed.device
    if dev.type == "cuda":
        return run_ladder(_stage, rung_index,
                          [kps.xy, kps.size, kps.class_id, kps.octave,
                           kps.valid, packed, level_hw, *(grids or ())],
                          config, buckets)
    if dev.type != "cpu":
        raise ValueError(f"adaptive_orient_describe: unsupported device "
                         f"{dev}")
    n = buckets[int(rung_index(kps.valid.sum(-1).max(), buckets))]
    return orient_describe(kps, packed, level_hw, n, config, grids)


def detect_and_compute(img, config: AkazeConfig = AkazeConfig(),
                       capacity: int | None = None,
                       kcontrast=None, batched: bool = False) -> Features:
    """img: [H, W] float32 grayscale in [0, 1] → Features, keypoints
    response-sorted and capacity-padded: `detect_and_compute_batch` of a
    batch of one. `batched` is accepted and ignored: on the TPU it only
    budgets memory for the FED cycle's strip plan under vmap."""
    img = torch.as_tensor(img, dtype=torch.float32)
    return select(detect_and_compute_batch(img[None], config, capacity,
                                           kcontrast), 0)


# ---- tiled extraction for images too large for one scale space ------------

def _upload(a, dev):
    """A small host array on `dev`; from pageable memory the copy is
    staged at once and does not wait on the device."""
    return torch.as_tensor(a).to(dev, non_blocking=True)


def _slice_tile_batch(img, offsets, th: int, tw: int):
    """[B, th, tw] tiles of the device-resident image at host offsets
    [(x, y), ...]: the image is uploaded once, never per tile."""
    return torch.stack([img[y:y + th, x:x + tw] for x, y in offsets])


def _own_and_shift(feats: Features, offsets, bounds) -> Features:
    """Shift each tile's keypoints to full-image coordinates and drop
    those outside the tile's ownership rectangle (their response becomes
    −∞, so the global merge never selects them). offsets [B, 2] (x, y);
    bounds [B, 4] (x0, x1, y0, y1)."""
    kp = feats.keypoints
    gx = kp.xy[..., 0] + offsets[:, None, 0]
    gy = kp.xy[..., 1] + offsets[:, None, 1]
    own = ((gx >= bounds[:, None, 0]) & (gx < bounds[:, None, 1])
           & (gy >= bounds[:, None, 2]) & (gy < bounds[:, None, 3]))
    keep = kp.valid & own
    return Features(
        keypoints=Keypoints(
            xy=torch.stack([gx, gy], dim=-1), size=kp.size, angle=kp.angle,
            response=torch.where(keep, kp.response, -torch.inf),
            octave=kp.octave, class_id=kp.class_id, valid=keep),
        descriptors=feats.descriptors)


def _tiled_merge(xy, size, angle, response, octave, class_id, desc, valid,
                 img_h: int, img_w: int, capacity: int) -> Features:
    """Global top-K and seam dedup over all tiles' candidates, on their
    device.

    Two tiles can localize the same extremum to sub-pixel positions on
    either side of an ownership boundary, possibly on adjacent levels.
    Each 1×1-px cell exposes its two strongest alive candidates; a
    candidate dies when a winner of any of its 3×3 neighbour cells is
    stronger, within 0.5 px and ≤ 1 level apart. The kill set is
    recomputed each round from the previous round's survivors (greedy
    rank-order semantics: a candidate whose only killer dies is
    revived); seam chains hold at most 4 candidates, so 3 rounds reach
    the greedy fixpoint. The cell tables live in candidate space
    (occupied cells compacted by `torch.unique`, neighbours found by
    binary search), so cost grows with the candidate count, not the
    image area. As in the JAX package, images past the int32 cell grid
    are refused.
    """
    if img_h * img_w > 2**31 - 1:
        raise ValueError(
            f"detect_and_compute_tiled: {img_w}x{img_h} exceeds the "
            "int32 seam-dedup cell grid (~46,340 px per side); split "
            "the mosaic into sub-images first")
    n = xy.shape[0]
    dev = xy.device
    resp = torch.where(valid, response, -torch.inf)
    order = torch.argsort(-resp, stable=True)                # rank → cand
    rank_of = torch.empty(n, dtype=torch.int64, device=dev)
    rank_of[order] = torch.arange(n, device=dev)             # cand → rank
    int_max = 2**31 - 1
    ix = xy[:, 0].to(torch.int32).clamp(0, img_w - 1).long()
    iy = xy[:, 1].to(torch.int32).clamp(0, img_h - 1).long()
    lin = iy * img_w + ix
    # Occupied cells, sorted, padded to n with a value past every cell.
    cells, cell_of = torch.unique(lin, sorted=True, return_inverse=True)
    cells = torch.cat([cells, cells.new_full((n - cells.shape[0],),
                                             img_h * img_w)])
    kill = torch.zeros(n, dtype=torch.bool, device=dev)
    for _round in range(3):
        alive_rank = torch.where(valid & ~kill, rank_of, int_max)
        # Empty cells hold int_max, segment_min's identity.
        win1 = torch.full((n,), int_max, dtype=torch.int64,
                          device=dev).scatter_reduce(
            0, cell_of, alive_rank, "amin")
        is_winner = win1[cell_of] == alive_rank
        win2 = torch.full((n,), int_max, dtype=torch.int64,
                          device=dev).scatter_reduce(
            0, cell_of, torch.where(is_winner, int_max, alive_rank), "amin")
        new_kill = torch.zeros(n, dtype=torch.bool, device=dev)
        for table in (win1, win2):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    ny = (iy + dy).clamp(0, img_h - 1)
                    nx = (ix + dx).clamp(0, img_w - 1)
                    nlin = ny * img_w + nx
                    jc = torch.searchsorted(cells, nlin).clamp(0, n - 1)
                    occupied = cells[jc] == nlin
                    wrank = torch.where(occupied, table[jc], int_max)
                    has = wrank < int_max
                    widx = order[wrank.clamp(0, n - 1)]
                    d2 = ((xy[widx, 0] - xy[:, 0]) ** 2
                          + (xy[widx, 1] - xy[:, 1]) ** 2)
                    new_kill = new_kill | (has & (wrank < rank_of)
                                           & (d2 < 0.25)
                                           & ((class_id[widx]
                                               - class_id).abs() <= 1))
        kill = new_kill
    resp2 = torch.where(kill, -torch.inf, resp)
    top = torch.argsort(-resp2, stable=True)[:capacity]
    v = torch.isfinite(resp2[top])
    return Features(
        keypoints=Keypoints(
            xy=torch.where(v[:, None], xy[top], 0.0),
            size=torch.where(v, size[top], 0.0),
            angle=torch.where(v, angle[top], 0.0),
            response=torch.where(v, resp2[top], 0.0),
            octave=torch.where(v, octave[top], 0).to(torch.int32),
            class_id=torch.where(v, class_id[top], -1).to(torch.int32),
            valid=v),
        descriptors=torch.where(v[:, None], desc[top], 0).to(torch.uint8))


def _tile_bounds(offsets, tile: int, total: int):
    """Tile i owns [b[i], b[i+1]): boundaries at the midpoint of each
    actual overlap (an edge-shifted last tile overlaps more), so every
    keypoint has exactly one owner."""
    b = [-1.0]
    for i in range(len(offsets) - 1):
        b.append((offsets[i + 1] + offsets[i] + tile) / 2.0)
    b.append(total + 1.0)
    return b


def detect_and_compute_tiled(img, config: AkazeConfig = AkazeConfig(),
                             capacity: int | None = None,
                             tile: int = 1024, overlap: int = 64,
                             tile_batch: int = 1, device=None) -> Features:
    """AKAZE over an image too large for one scale space, through
    overlapping tiles (port of the JAX package's detect_and_compute_tiled).

    One global contrast factor, from the image decimated to ≤ 2048 px,
    drives every tile's diffusion, so responses compare across seams; a
    keypoint is kept only by the tile that owns it, and `_tiled_merge`
    takes the global top-`capacity` with the seam dedup. The image is
    uploaded once; every tile batch's features stay on the device and one
    Features comes back, in full-image coordinates, response-sorted.

    `img` [H, W] float32 in [0, 1]: a tensor runs on its own device, a
    host array on `device` (the card unless the caller names another).
    """
    from cubesat_apds_tpu_torch.ops.features.scale_space import (
        compute_k_percentile)

    capacity = capacity or config.capacity
    if isinstance(img, torch.Tensor) and device is None:
        arr = img.to(torch.float32)
    else:
        arr = torch.as_tensor(np.asarray(img, np.float32)).to(
            torch.device("cuda" if device is None else device))
    H, W = arr.shape
    if H <= tile and W <= tile:
        return detect_and_compute(arr, config, capacity)
    dev = arr.device

    dec = max(max(H, W) // 2048, 1)
    kcontrast = compute_k_percentile(
        arr[::dec, ::dec], config.kcontrast_percentile, 1.0,
        config.kcontrast_nbins)

    step = tile - overlap
    xs = list(range(0, max(W - tile, 0), step)) + [max(W - tile, 0)]
    ys = list(range(0, max(H - tile, 0), step)) + [max(H - tile, 0)]
    xb = _tile_bounds(xs, tile, W)
    yb = _tile_bounds(ys, tile, H)
    offs = [(xi, yi) for yi in range(len(ys)) for xi in range(len(xs))]
    per_tile_cap = max(capacity // max(len(offs) // 2, 1), 256)

    th, tw = min(tile, H), min(tile, W)
    parts: list[Features] = []
    for start in range(0, len(offs), tile_batch):
        chunk = offs[start:start + tile_batch]
        offsets = [(xs[xi], ys[yi]) for xi, yi in chunk]
        bounds = [(xb[xi], xb[xi + 1], yb[yi], yb[yi + 1])
                  for xi, yi in chunk]
        if len(chunk) < tile_batch and len(offs) > tile_batch:
            # Pad with repeats of the first tile; padded rows own nothing
            # (bounds −2 fail every ownership test).
            pad = tile_batch - len(chunk)
            offsets += offsets[:1] * pad
            bounds += [(-2.0,) * 4] * pad
        batch = _slice_tile_batch(arr, offsets, th, tw)
        feats = detect_and_compute_batch(batch, config, per_tile_cap,
                                         kcontrast)
        parts.append(_own_and_shift(
            feats, _upload(np.asarray(offsets, np.float32), dev),
            _upload(np.asarray(bounds, np.float32), dev)))

    def flat(get):
        return torch.cat([get(p).reshape((-1,) + get(p).shape[2:])
                          for p in parts])

    return _tiled_merge(
        flat(lambda p: p.keypoints.xy), flat(lambda p: p.keypoints.size),
        flat(lambda p: p.keypoints.angle),
        flat(lambda p: p.keypoints.response),
        flat(lambda p: p.keypoints.octave),
        flat(lambda p: p.keypoints.class_id), flat(lambda p: p.descriptors),
        flat(lambda p: p.keypoints.valid), H, W, capacity)
