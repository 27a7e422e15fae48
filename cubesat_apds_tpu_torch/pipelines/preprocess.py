"""Offline DB build: mosaic → LoD tile grid → AKAZE → store (port of
pipelines/preprocess.py).

The preprocessor binary rebuilt (reference: preprocessor/src/main.rs:70-327).
Host window reads (io/mosaic) feed a batch of tiles resampled, merged and
converted to gray on the mosaic's device; `detect_and_compute_batch`
runs on the whole batch (kernels A and B once per level and stage on the
card); the features come back to the host once per batch and land in a
FeatureStore as plain array appends.

LoD math matches level_of_detail.rs: per-AXIS tile size dim/2^(L−1),
per-LoD grid of columns×rows, keypoint coordinates upscaled to the
reference frame as x·2^lod + offset (main.rs:296-304). Ragged
right/bottom strips are covered by edge-shifted tiles, and each keypoint
is stored by the one tile that owns it.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from cubesat_apds_tpu_torch.core.config import PipelineConfig
from cubesat_apds_tpu_torch.io.mosaic import MosaicDataset
from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute_batch
from cubesat_apds_tpu_torch.ops.image import (
    calculate_amount_of_levels, lod_tile_grid, rgb_to_gray)
from cubesat_apds_tpu_torch.store.feature_store import FeatureStore


@dataclasses.dataclass
class PreprocessStats:
    lods: int = 0
    tiles: int = 0
    keypoints: int = 0


class _Checkpointer:
    """Crash-safe partial-store persistence for `preprocess`.

    Two alternating slot directories + an atomically-replaced
    cursor.json. The cursor (which names its slot) is committed only
    AFTER that slot finished writing, so the previous checkpoint stays
    loadable throughout a save — a crash at any instant leaves either
    the old or the new checkpoint intact, never a torn one.
    """

    def __init__(self, root: Optional[str], every: int):
        self.root = root
        self.every = max(int(every), 1)
        self._slot = 0
        self._done = 0

    def _cursor_path(self) -> str:
        return os.path.join(self.root, "cursor.json")

    def read_cursor(self) -> Optional[dict]:
        if self.root is None or not os.path.exists(self._cursor_path()):
            return None
        with open(self._cursor_path()) as f:
            return json.load(f)

    def load_store(self, cursor: dict) -> FeatureStore:
        return FeatureStore.load(os.path.join(self.root, cursor["slot"]))

    def validate(self, cursor: dict, params: dict) -> None:
        got = {k: cursor.get(k) for k in params}
        if got != params:
            raise ValueError(
                f"checkpoint was written by a different run: {got} vs "
                f"this run's {params} — delete {self.root} to start over")
        # Next save goes to the OTHER slot, preserving the one loaded.
        self._slot = {"slot_a": 1, "slot_b": 0}[cursor["slot"]]

    def maybe_save(self, store: FeatureStore, params: dict,
                   lod: int, start: int) -> None:
        """Checkpoint after the (lod, start) batch completed, every
        `every` completed batches."""
        if self.root is None:
            return
        self._done += 1
        if self._done % self.every:
            return
        slot = f"slot_{'ab'[self._slot]}"
        self._slot ^= 1
        store.save(os.path.join(self.root, slot))
        tmp = self._cursor_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dict(params, lod=lod, start=start, slot=slot), f)
        os.replace(tmp, self._cursor_path())

    def cleanup(self) -> None:
        """Remove the checkpoint after a successful full run."""
        if self.root is None or not os.path.isdir(self.root):
            return
        import shutil

        for name in ("slot_a", "slot_b"):
            shutil.rmtree(os.path.join(self.root, name), ignore_errors=True)
        for f_ in ("cursor.json", "cursor.json.tmp"):
            try:
                os.remove(os.path.join(self.root, f_))
            except OSError:
                pass
        try:
            os.rmdir(self.root)
        except OSError:
            pass


def preprocess(
    dataset: MosaicDataset,
    store: Optional[FeatureStore] = None,
    config: PipelineConfig = PipelineConfig(),
    amount_lod: Optional[int] = None,
    tile_batch: int = 8,
    elevation_path: Optional[str] = None,
    progress: Optional[Callable[[str], None]] = None,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 16,
    resume: bool = False,
) -> tuple[FeatureStore, PreprocessStats]:
    """Build a FeatureStore from a mosaic (main.rs:70-124 flow), on the
    mosaic's device (`dataset.device`).

    `checkpoint_dir` enables mid-run checkpoint/resume: every
    `checkpoint_every` tile batches the partial store is saved to an
    alternating slot and a cursor (last completed batch + run parameters)
    is committed atomically AFTER the save, so a crash at any instant
    leaves a loadable checkpoint. `resume=True` picks up from the cursor
    (a missing cursor just starts fresh); the run parameters must match
    or it refuses. On success the checkpoint is removed.

    `mesh` (parallel.mesh.make_mesh) splits each tile batch over the
    mesh's dp rows, row i's tiles extracted on its first slot; the batch
    width rounds up to a dp multiple. Every process gets the whole
    batch's features and ingests them into its own store: the store is
    element-wise the single-device build's.
    """
    if mesh is not None:
        dp = mesh.shape["dp"]
        tile_batch = max(dp * ((tile_batch + dp - 1) // dp), dp)
    _ckpt = _Checkpointer(checkpoint_dir, checkpoint_every)
    cursor = _ckpt.read_cursor() if resume else None
    if cursor is not None:
        if store is not None:
            raise ValueError("resume=True loads the store from the "
                             "checkpoint; don't pass `store` too")
        store = _ckpt.load_store(cursor)
    else:
        # A fresh run discards any stale checkpoint — otherwise a later
        # resume could pick up a cursor from a DIFFERENT previous run.
        _ckpt.cleanup()
    store = store or FeatureStore()
    # Stamp descriptor provenance: sampling modes don't mix, so the store
    # records which tag built it (checked at serve time).
    tag = config.akaze.descriptor_tag
    if store.descriptor_mode is not None and store.descriptor_mode != tag:
        raise ValueError(
            f"store holds descriptor_mode='{store.descriptor_mode}' "
            f"descriptors but the config produces '{tag}' — "
            "mixed-mode descriptors don't match; use a matching config "
            "or a fresh store")
    store.descriptor_mode = tag
    stats = PreprocessStats()
    log = progress or (lambda s: None)

    width, height = dataset.get_dimensions()
    if amount_lod is None:
        amount_lod = calculate_amount_of_levels(width * height)
    stats.lods = amount_lod

    # The batch iteration order is deterministic in these parameters, so
    # a cursor naming the last completed (lod, start) fully determines
    # the remaining work — but only for the SAME parameters.
    params = {"width": width, "height": height, "amount_lod": amount_lod,
              "tile_batch": tile_batch, "descriptor_mode": tag}
    if cursor is not None:
        _ckpt.validate(cursor, params)
        stats.tiles = len(store._images)
        stats.keypoints = len(store)
        log(f"resuming after LoD {cursor['lod']} batch {cursor['start']}: "
            f"{stats.keypoints} keypoints, {stats.tiles} tiles so far")

    # Mosaic geotransform is dataset id 1; elevation handling mirrors
    # add_elevation (main.rs:128-140): store both geotransforms + raster.
    store.set_geotransform(1, dataset.geotransform)
    if elevation_path is not None:
        dataset.set_elevation_dataset(elevation_path)
    if dataset.elevation is not None:
        e = dataset.elevation
        store.set_geotransform(2, e.geotransform)
        # The store persists the full elevation raster. A lazily-attached
        # elevation mosaic is streamed in row chunks so only the
        # destination array is ever fully resident.
        if hasattr(e, "read_window"):
            raster = np.empty((e.height, e.width), np.float32)
            for y0 in range(0, e.height, 1024):
                hh = min(1024, e.height - y0)
                raster[y0:y0 + hh] = e.read_window(0, y0, e.width, hh,
                                                   (1,))[0]
                np.nan_to_num(raster[y0:y0 + hh], copy=False)
        else:
            # Eager raster: the band is the dataset's own array — don't
            # mutate it.
            raster = np.nan_to_num(e.bands[0])
        store.set_elevation(raster, e.geotransform)

    grid = lod_tile_grid(width, height, amount_lod)
    dev = dataset.device

    for lod in range(amount_lod):
        tile_w, tile_h, step_x, step_y, off_x, off_y, bx, by = grid[lod]
        columns, rows = len(off_x), len(off_y)
        log(f"LoD {lod}: {columns}x{rows} tiles of {step_x}x{step_y} px "
            f"-> {tile_w}x{tile_h}")

        tiles_meta = [(r, c) for r in range(rows) for c in range(columns)]
        for start in range(0, len(tiles_meta), tile_batch):
            if cursor is not None and \
                    (lod, start) <= (cursor["lod"], cursor["start"]):
                continue               # completed before the crash
            batch_meta = tiles_meta[start:start + tile_batch]
            grays = [tile_gray(dataset, off_x[c], off_y[r], step_x, step_y,
                               tile_w, tile_h) for r, c in batch_meta]
            # Ragged final batches keep the fixed batch width (as the JAX
            # package does, whose compiled step has one batch shape); under
            # a mesh the batch always fills to its dp multiple.
            while len(grays) < tile_batch and (len(tiles_meta) > tile_batch
                                               or mesh is not None):
                grays.append(torch.zeros_like(grays[0]))
            if mesh is None:
                host = _host_arrays(detect_and_compute_batch(
                    torch.stack(grays), config.akaze))
            else:
                host = _mesh_host_arrays(mesh, grays, config)
            for bi, (r, c) in enumerate(batch_meta):
                # Tile record in REFERENCE-frame coordinates
                # (InsertImage, main.rs:280-293).
                iid = store.create_image(
                    off_x[c], off_y[r], off_x[c] + step_x, off_y[r] + step_y,
                    lod)
                stats.tiles += 1
                rows = tile_rows(host, bi, lod, off_x[c], off_y[r],
                                 (bx[c], bx[c + 1], by[r], by[r + 1]))
                if rows is not None:
                    store.add_keypoints(iid, *rows)
                    stats.keypoints += len(rows[0])
            _ckpt.maybe_save(store, params, lod, start)
        log(f"LoD {lod} done: {len(store)} keypoints total")
    _ckpt.cleanup()
    return store, stats


def _host_arrays(feats) -> dict:
    """A batch's Features on the host, one copy per field."""
    kp = feats.keypoints
    return {k: t.cpu().numpy() for k, t in (
        ("xy", kp.xy), ("size", kp.size), ("angle", kp.angle),
        ("response", kp.response), ("octave", kp.octave),
        ("class_id", kp.class_id), ("valid", kp.valid),
        ("desc", feats.descriptors))}


_FIELDS = ("xy", "size", "angle", "response", "octave", "class_id", "valid",
           "desc")


def _mesh_host_arrays(mesh, grays, config: PipelineConfig) -> dict:
    """A tile batch split over the mesh's dp rows: row i's tiles extracted
    on its first slot by the process that owns it, then every row's host
    arrays on every process (broadcast across processes)."""
    from cubesat_apds_tpu_torch.parallel.mesh import broadcast_tensors

    dp = mesh.shape["dp"]
    lb = len(grays) // dp
    rows = []
    for i in range(dp):
        h = None
        if mesh.is_local(i, 0):
            chunk = torch.stack(grays[i * lb:(i + 1) * lb])
            h = _host_arrays(detect_and_compute_batch(
                chunk.to(mesh.devices[i, 0]), config.akaze))
        if mesh.multiprocess:
            sent = None if h is None else [torch.from_numpy(h[k])
                                           for k in _FIELDS]
            got = broadcast_tensors(sent, int(mesh.ranks[i, 0]),
                                    len(_FIELDS), mesh.home)
            h = {k: t.cpu().numpy() for k, t in zip(_FIELDS, got)}
        rows.append(h)
    return {k: np.concatenate([h[k] for h in rows]) for k in _FIELDS}


def tile_rows(host: dict, bi: int, lod: int, off_x: int, off_y: int,
              bounds):
    """Store rows of tile `bi` of a batch (host arrays of its Features):
    the valid keypoints upscaled to the reference frame as x·2^lod +
    offset (main.rs:296-304) and kept where the tile owns them (`bounds`
    x0, x1, y0, y1 from lod_tile_grid: edge-shifted ragged tiles overlap
    their neighbours, and each keypoint is stored by exactly one tile).
    Returns add_keypoints' arguments (x, y, size, angle, response,
    octave, class_id, descriptors), or None when the tile owns none."""
    v = host["valid"][bi]
    scale = float(2 ** lod)
    gx = host["xy"][bi, v, 0] * scale + off_x
    gy = host["xy"][bi, v, 1] * scale + off_y
    x0, x1, y0, y1 = bounds
    own = (gx >= x0) & (gx < x1) & (gy >= y0) & (gy < y1)
    if not own.any():
        return None
    vv = np.where(v)[0][own]
    return (gx[own], gy[own]) + tuple(
        host[k][bi, vv] for k in ("size", "angle", "response", "octave",
                                  "class_id", "desc"))


def tile_gray(dataset: MosaicDataset, x: int, y: int, w: int, h: int,
              out_w: int, out_h: int) -> torch.Tensor:
    """One LoD tile as the build extracts it: the mosaic window
    [x, x+w) × [y, y+h) resampled to out_w × out_h RGBA8 (`to_rgb`), then
    its RGB as float32 gray in [0, 1] on the mosaic's device."""
    rgba = dataset.to_rgb((x, y), (w, h), (out_w, out_h))
    return rgb_to_gray(torch.from_numpy(rgba[..., :3]).to(dataset.device))
