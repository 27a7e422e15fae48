"""Memory-mapped binary feature store with a native C++ query engine (a
copy of the JAX package's store/binary_store.py: the writer and the read
path; the on-disk format is the same).

Columnar .npy files opened with np.memmap (zero-copy) + the C++ scan
kernels in store/native (response-ranked windowed selection with the
reference's ORDER BY response DESC LIMIT 2^18−1 semantics,
keypointdb.rs:12,67-90). Reads never load the full store into RAM: the
only materialized row data are the four columns every query SCANS
linearly (x, y, lod, image_id) plus the order index (~20 B/row); the
remaining five columns and the 61 B/row descriptors stay per-segment
mmaps, touched page-wise by result gathers only.

The keypoint table is a list of immutable SEGMENTS with a merged
response-descending order index spanning them and an alive bitmap
(manifest v2; v1 is one implicit segment at the store root). This module
reads every such store and writes segment 0 of a new one; appending,
compacting and deleting (with the store's write lock) are still to port.
A store's native engine is `_lib`; with `_lib = None` the queries run
their numpy twin.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from cubesat_apds_tpu_torch.core.config import DESC_BYTES, MAX_POINTS
from cubesat_apds_tpu_torch.store.feature_store import (
    ELEVATION_DATASET_ID, MOSAIC_DATASET_ID, FeatureStore, ImageRecord,
    device_block)
from cubesat_apds_tpu_torch.store.native import get_lib

_COLS = ("x", "y", "size", "angle", "response", "octave", "class_id",
         "image_id")


def _fsync_dir(dirpath: str) -> None:
    """fsync a directory so a just-replaced entry survives power loss."""
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_save(path: str, arr: np.ndarray) -> None:
    """np.save via tmp + fsync + os.replace — all-or-nothing on disk."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


def _atomic_json(path: str, obj) -> None:
    """json.dump via tmp + fsync + os.replace — the commit operation."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


def _epoch_file(path: str, base: str, epoch: int) -> str:
    """alive/order snapshot filename for a manifest epoch. Epoch 0 keeps
    the unsuffixed names."""
    name = f"{base}.npy" if epoch == 0 else f"{base}.{epoch}.npy"
    return os.path.join(path, name)


def _write_segment(seg_dir: str, store: FeatureStore) -> int:
    """Write one immutable keypoint segment from a FeatureStore's rows;
    returns the number of rows written."""
    os.makedirs(seg_dir, exist_ok=True)
    n = len(store)
    for c in _COLS:
        _atomic_save(os.path.join(seg_dir, f"{c}.npy"),
                     np.ascontiguousarray(store._kp[c]))
    _atomic_save(os.path.join(seg_dir, "desc.npy"),
                 np.ascontiguousarray(store._desc))
    # Denormalized per-keypoint LoD (joins are a luxury of SQL).
    lod_of_image = {r.id: r.level_of_detail for r in store._images.values()}
    lod = np.array([lod_of_image.get(int(i), -1)
                    for i in store._kp["image_id"]], np.int32)
    _atomic_save(os.path.join(seg_dir, "lod.npy"), lod)
    _fsync_dir(os.path.dirname(seg_dir) or ".")
    return n


def _merged_order(path: str, segments: List[dict]) -> np.ndarray:
    """Global response-descending (stable) permutation over all rows,
    from the response columns alone."""
    parts = [np.asarray(np.load(os.path.join(path, seg["name"],
                                             "response.npy"), mmap_mode="r"),
                        np.float32) for seg in segments]
    if not parts:
        return np.zeros(0, np.int32)
    resp = np.ascontiguousarray(np.concatenate(parts))
    order = np.empty(len(resp), np.int32)
    if len(resp):
        get_lib().argsort_response_desc(resp, len(resp), order)
    return order


def write_binary_store(store: FeatureStore, path: str):
    """Persist a FeatureStore as a mmap-friendly binary directory
    (segment 0 of a segmented store). The manifest is written LAST and
    atomically — a crash mid-write leaves no manifest (the store never
    existed) rather than a torn one."""
    os.makedirs(path, exist_ok=True)
    n = _write_segment(os.path.join(path, "seg0"), store)
    _atomic_save(os.path.join(path, "alive.npy"), np.ones(n, bool))
    manifest = {
        "version": 2,
        "epoch": 0,
        "segments": [{"name": "seg0", "n": n}],
        "desc_bytes": DESC_BYTES,
        "next_image_id": store._next_image_id,
        "images": [
            {"id": r.id, "x_start": r.x_start, "y_start": r.y_start,
             "x_end": r.x_end, "y_end": r.y_end,
             "level_of_detail": r.level_of_detail}
            for r in store._images.values()
        ],
        "geotransforms": {str(k): v.tolist()
                          for k, v in store._geotransforms.items()},
        "has_elevation": store._elevation is not None,
        "descriptor_mode": store.descriptor_mode,
    }
    _atomic_save(os.path.join(path, "order.npy"),
                 _merged_order(path, manifest["segments"]))
    if store._elevation is not None:
        _atomic_save(os.path.join(path, "elevation.npy"), store._elevation)
        _atomic_save(os.path.join(path, "elevation_gt.npy"),
                     store._elevation_gt)
    _atomic_json(os.path.join(path, "manifest.json"), manifest)


class BinaryFeatureStore:
    """mmap-backed store with the reference's query semantics."""

    def __init__(self, path: str):
        self.path = path
        # A committed manifest only references immutable files; the one
        # race is a writer committing and cleaning its OLD epoch files
        # between our manifest read and the file opens — retry once
        # against the new (consistent) epoch.
        for attempt in (0, 1):
            try:
                self._load(path)
                return
            except FileNotFoundError:
                if attempt:
                    raise

    def _load(self, path: str):
        with open(os.path.join(path, "manifest.json")) as f:
            self.manifest = json.load(f)
        if self.manifest.get("version", 1) >= 2:
            self.segments = self.manifest["segments"]
            seg_dirs = [os.path.join(path, s["name"]) for s in self.segments]
        else:
            # v1 layout: single implicit segment at the store root.
            self.segments = [{"name": ".", "n": self.manifest["n"]}]
            seg_dirs = [path]
        self.n = sum(s["n"] for s in self.segments)
        self._offsets = np.cumsum([0] + [s["n"] for s in self.segments])
        # Provenance (see FeatureStore.descriptor_mode); None = unknown.
        self.descriptor_mode = self.manifest.get("descriptor_mode")

        def segs(name):
            return [np.load(os.path.join(d, name), mmap_mode="r")
                    for d in seg_dirs]

        # ALL row data stays per-segment mmaps — never concatenated into
        # RAM; _select routes global indices to segment-local gathers
        # (page-wise reads). Only the scan columns below are pinned.
        self._col_segs: Dict[str, List[np.ndarray]] = {
            c: segs(f"{c}.npy") for c in _COLS}
        self._col_segs["lod"] = segs("lod.npy")
        self._desc_segs = segs("desc.npy")
        epoch = int(self.manifest.get("epoch", 0))
        self.order = np.load(_epoch_file(path, "order", epoch),
                             mmap_mode="r")
        alive_p = _epoch_file(path, "alive", epoch)
        self.alive = (np.load(alive_p) if os.path.exists(alive_p)
                      else np.ones(self.n, bool))
        self.images = {r["id"]: ImageRecord(**r)
                       for r in self.manifest["images"]}
        self.geotransforms = {
            int(k): np.asarray(v)
            for k, v in self.manifest["geotransforms"].items()}
        has_el = self.manifest["has_elevation"]
        self._elevation = (np.load(os.path.join(path, "elevation.npy"),
                                   mmap_mode="r") if has_el else None)
        self._elevation_gt = (np.load(os.path.join(path, "elevation_gt.npy"))
                              if has_el else None)
        self._lib = get_lib()
        # Every query WALKS these four columns + the order index linearly
        # (the C kernels need C-contiguous concrete arrays; the numpy twin
        # does full-array masking) — pin them once, ~20 B/row.
        self._xc = self._pin("x", np.float32)
        self._yc = self._pin("y", np.float32)
        self._lodc = self._pin("lod", np.int32)
        self._imgc = self._pin("image_id", np.int32)
        self._orderc = np.ascontiguousarray(self.order, np.int32)

    def _pin(self, name: str, dtype) -> np.ndarray:
        """One contiguous in-RAM copy of a scan column (all segments)."""
        parts = self._col_segs[name]
        if len(parts) == 1:
            return np.ascontiguousarray(parts[0], dtype)
        return np.concatenate([np.asarray(p, dtype) for p in parts])

    def __len__(self):
        """Live keypoint count (deleted rows excluded)."""
        return int(self.alive.sum()) if not self.alive.all() else self.n

    # ---- queries (reference semantics) ---------------------------------

    def read_keypoints_from_lod(self, lod: int, limit: int = MAX_POINTS):
        out = np.empty(min(limit, self.n), np.int32)
        if self._lib is not None:
            m = self._lib.query_lod(self._lodc, self._orderc,
                                    len(self._orderc), lod, limit, out)
            idx = out[:m]
        else:
            order = self._orderc
            idx = order[self._lodc[order] == lod][:limit]
        return self._select(idx)

    def read_keypoints_from_coordinates(self, x_start, x_end, y_start,
                                        y_end, lod: int,
                                        limit: int = MAX_POINTS):
        out = np.empty(min(limit, self.n), np.int32)
        if self._lib is not None:
            m = self._lib.query_window(
                self._xc, self._yc, self._lodc, self._orderc,
                len(self._orderc),
                float(x_start), float(x_end), float(y_start), float(y_end),
                lod, limit, out)
            idx = out[:m]
        else:
            x, y = self._xc, self._yc
            mask = ((self._lodc == lod) & (x >= x_start)
                    & (x <= x_end) & (y >= y_start) & (y <= y_end))
            order = self._orderc
            idx = order[mask[order]][:limit]
        return self._select(idx)

    def read_keypoints_from_image_id(self, image_id: int,
                                     limit: int = MAX_POINTS):
        out = np.empty(min(limit, self.n), np.int32)
        if self._lib is not None:
            m = self._lib.query_image(self._imgc, self._orderc,
                                      len(self._orderc),
                                      image_id, limit, out)
            idx = out[:m]
        else:
            order = self._orderc
            idx = order[self._imgc[order] == image_id][:limit]
        return self._select(idx)

    def _gather_desc(self, idx: np.ndarray) -> np.ndarray:
        """Gather descriptor rows by GLOBAL index across segment mmaps."""
        if len(self._desc_segs) == 1:
            seg = self._desc_segs[0]
            if self._lib is not None and len(idx):
                desc = np.empty((len(idx), DESC_BYTES), np.uint8)
                self._lib.gather_descriptors(
                    np.ascontiguousarray(seg), DESC_BYTES,
                    np.ascontiguousarray(idx, np.int32), len(idx), desc)
                return desc
            return np.asarray(seg)[idx]
        desc = np.empty((len(idx), DESC_BYTES), np.uint8)
        seg_of = np.searchsorted(self._offsets, idx, side="right") - 1
        for si, seg in enumerate(self._desc_segs):
            sel = seg_of == si
            if sel.any():
                desc[sel] = np.asarray(seg)[idx[sel] - self._offsets[si]]
        return desc

    def _gather_one(self, name: str, idx: np.ndarray) -> np.ndarray:
        """Gather one column by GLOBAL index across segment mmaps."""
        parts = self._col_segs[name]
        if len(parts) == 1:
            return np.asarray(parts[0])[idx]
        seg_of = np.searchsorted(self._offsets, idx, side="right") - 1
        out = np.empty(len(idx), parts[0].dtype)
        for si, p in enumerate(parts):
            sel = seg_of == si
            if sel.any():
                out[sel] = np.asarray(p)[idx[sel] - self._offsets[si]]
        return out

    def _select(self, idx: np.ndarray):
        return ({c: self._gather_one(c, idx) for c in _COLS},
                self._gather_desc(idx))

    # ---- geo (parity with FeatureStore) ---------------------------------

    @property
    def _geotransforms(self):
        return self.geotransforms

    def world_dataset_id(self) -> Optional[int]:
        """See FeatureStore.world_dataset_id — same convention."""
        ids = sorted(k for k in self.geotransforms
                     if k != ELEVATION_DATASET_ID)
        if not ids:
            return None
        if ids != [MOSAIC_DATASET_ID]:
            raise ValueError(
                f"ambiguous world mapping: geotransforms registered for "
                f"datasets {ids}; keypoint coordinates are in the mosaic "
                f"(dataset {MOSAIC_DATASET_ID}) reference frame only")
        return MOSAIC_DATASET_ID

    def get_world_coordinates(self, dataset_id: int, px, py) -> np.ndarray:
        """pixel → ECEF (elevationdb.rs:64-104 semantics), vectorized."""
        from cubesat_apds_tpu_torch.core import geodesy as G

        gt = self.geotransforms[dataset_id]
        wx, wy = G.geotransform_apply(gt, np.asarray(px, np.float64),
                                      np.asarray(py, np.float64))
        ex, ey = G.world_to_pixel(self._elevation_gt, wx, wy)
        h, w = self._elevation.shape
        exi = np.clip(np.asarray(np.floor(ex), np.int64), 0, w - 1)
        eyi = np.clip(np.asarray(np.floor(ey), np.int64), 0, h - 1)
        height = np.asarray(self._elevation)[eyi, exi]
        return np.asarray(G.geodetic_to_ecef(wx, wy, height))

    # ---- device export --------------------------------------------------

    def export_device_block(self, lod: Optional[int] = None,
                            pad_multiple: int = 2048,
                            limit: int = MAX_POINTS):
        """See FeatureStore.export_device_block — same block."""
        if lod is None:
            cols, desc = self._select(np.asarray(self.order)[:limit])
        else:
            cols, desc = self.read_keypoints_from_lod(lod, limit)
        return device_block(cols, desc, pad_multiple)

