"""Array-backed feature store — the feature_database (Postgres) replacement
(a copy of the JAX package's store/feature_store.py, numpy only; the
on-disk format is the same, so a store either package saves loads in the
other).

The reference persists tiles ("ref_image"), keypoints + descriptors,
geotransforms and an elevation raster in Postgres and queries them with
diesel (reference: feature_database/src/schema.rs:3-61, imagedb.rs,
keypointdb.rs, elevationdb.rs). TPU-native redesign: columnar numpy arrays
on the host, exported as padded device blocks for matching; queries become
vectorized masks + response-ranked slicing with EXACTLY the reference's
semantics:

  * every keypoint read is ORDER BY response DESC LIMIT 2^18−1
    (keypointdb.rs:12,45,60,85 — OPENCV_KEYPOINT_LIMIT);
  * spatial window query = bbox overlap test per LoD
    (keypointdb.rs:67-90, imagedb.rs:38-54);
  * images are rectangles (x_start..x_end, y_start..y_end) per LoD
    (migrations/2024-03-21-110256_image/up.sql:2-9);
  * world-coordinate lookup combines geotransform + elevation + ECEF
    (elevationdb.rs:64-104).

Persistence is a directory of .npz shards + JSON manifest — the durable
artifact that gives the same "resume from store" semantics as the
reference's Postgres DB (SURVEY.md §5 checkpoint/resume).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np

from cubesat_apds_tpu_torch.core.config import DESC_BYTES, MAX_POINTS

_KP_FIELDS = ("x", "y", "size", "angle", "response", "octave", "class_id",
              "image_id")

# Geotransform registry convention (preprocess mirrors the reference's
# create_geotransform call order, preprocessor main.rs:128-140): the
# mosaic's transform is dataset 1, the elevation raster's is dataset 2.
MOSAIC_DATASET_ID = 1
ELEVATION_DATASET_ID = 2


@dataclasses.dataclass
class ImageRecord:
    """A tile record (= ref_image row, schema.rs:29-38)."""

    id: int
    x_start: int
    y_start: int
    x_end: int
    y_end: int
    level_of_detail: int


class FeatureStore:
    """Host-side keypoint/tile/geo store with reference query semantics."""

    def __init__(self):
        self._images: Dict[int, ImageRecord] = {}
        self._next_image_id = 1
        # Columnar keypoint storage: capacity buffers grown geometrically
        # (×2 on overflow) with `_n` live rows — batch insert is amortized
        # O(batch), not O(total) per call.
        self._buf: Dict[str, np.ndarray] = {
            "x": np.empty(0, np.float32),
            "y": np.empty(0, np.float32),
            "size": np.empty(0, np.float32),
            "angle": np.empty(0, np.float32),
            "response": np.empty(0, np.float32),
            "octave": np.empty(0, np.int32),
            "class_id": np.empty(0, np.int32),
            "image_id": np.empty(0, np.int32),
        }
        self._desc_buf = np.empty((0, DESC_BYTES), np.uint8)
        self._n = 0
        self._geotransforms: Dict[int, np.ndarray] = {}   # dataset_id → [6]
        self._elevation: Optional[np.ndarray] = None      # [H, W] float32
        self._elevation_gt: Optional[np.ndarray] = None   # [6]
        # Provenance: which AKAZE descriptor_mode produced the stored
        # descriptors ("exact"/"fast"). Descriptors across modes don't
        # mix — the serving path refuses a store/config mismatch instead
        # of silently matching garbage. None = unknown (pre-provenance
        # store).
        self.descriptor_mode: Optional[str] = None

    @property
    def _kp(self) -> Dict[str, np.ndarray]:
        """Live keypoint columns (views of the capacity buffers)."""
        return {f: self._buf[f][:self._n] for f in _KP_FIELDS}

    @property
    def _desc(self) -> np.ndarray:
        return self._desc_buf[:self._n]

    # ---- images (imagedb.rs trait) -------------------------------------

    def create_image(self, x_start, y_start, x_end, y_end,
                     level_of_detail) -> int:
        """create_image (imagedb.rs:14-29) → new id (serial semantics)."""
        iid = self._next_image_id
        self._next_image_id += 1
        self._images[iid] = ImageRecord(iid, int(x_start), int(y_start),
                                        int(x_end), int(y_end),
                                        int(level_of_detail))
        return iid

    def read_image_from_id(self, image_id: int) -> ImageRecord:
        return self._images[image_id]

    def find_images_from_lod(self, lod: int) -> List[ImageRecord]:
        return [r for r in self._images.values() if r.level_of_detail == lod]

    def find_images_from_dimensions(self, x_start, x_end, y_start, y_end,
                                    lod) -> List[ImageRecord]:
        """bbox-overlap query (imagedb.rs:38-54): images whose rectangle
        intersects [x_start,x_end]×[y_start,y_end] at the given LoD."""
        out = []
        for r in self._images.values():
            if r.level_of_detail != lod:
                continue
            if r.x_start <= x_end and r.x_end >= x_start and \
               r.y_start <= y_end and r.y_end >= y_start:
                out.append(r)
        return out

    def delete_image(self, image_id: int):
        """delete_image (imagedb.rs:66-72); cascades to keypoints like the
        FK ON DELETE CASCADE in the schema."""
        self._images.pop(image_id, None)
        keep = self._kp["image_id"] != image_id
        m = int(keep.sum())
        for f in _KP_FIELDS:
            self._buf[f][:m] = self._buf[f][:self._n][keep]
        self._desc_buf[:m] = self._desc_buf[:self._n][keep]
        self._n = m

    # ---- keypoints (keypointdb.rs trait) -------------------------------

    def add_keypoints(self, image_id: int, x, y, size, angle, response,
                      octave, class_id, descriptors):
        """create_keypoint Multiple-batch insert (keypointdb.rs:15-26)."""
        n = len(x)
        d = np.asarray(descriptors, np.uint8)
        assert d.shape == (n, DESC_BYTES), d.shape
        self._reserve(self._n + n)
        cols = dict(x=x, y=y, size=size, angle=angle, response=response,
                    octave=octave, class_id=class_id,
                    image_id=np.full(n, image_id, np.int32))
        for f in _KP_FIELDS:
            self._buf[f][self._n:self._n + n] = np.asarray(cols[f])
        self._desc_buf[self._n:self._n + n] = d
        self._n += n

    def _reserve(self, need: int):
        """Grow the capacity buffers geometrically to hold `need` rows."""
        cap = len(self._desc_buf)
        if need <= cap:
            return
        new_cap = max(need, cap * 2, 1024)
        for f in _KP_FIELDS:
            buf = np.empty(new_cap, self._buf[f].dtype)
            buf[:self._n] = self._buf[f][:self._n]
            self._buf[f] = buf
        dbuf = np.empty((new_cap, DESC_BYTES), np.uint8)
        dbuf[:self._n] = self._desc_buf[:self._n]
        self._desc_buf = dbuf

    def __len__(self):
        return self._n

    def _ranked(self, mask: np.ndarray, limit: int):
        """Apply the reference's universal read ordering: response DESC,
        LIMIT 2^18−1 (keypointdb.rs:12)."""
        idx = np.nonzero(mask)[0]
        order = np.argsort(-self._kp["response"][idx], kind="stable")
        return idx[order][:limit]

    def read_keypoints_from_image_id(self, image_id: int,
                                     limit: int = MAX_POINTS):
        mask = self._kp["image_id"] == image_id
        return self._select(self._ranked(mask, limit))

    def read_keypoints_from_lod(self, lod: int, limit: int = MAX_POINTS):
        """read_keypoints_from_lod (keypointdb.rs:50-65): keypoints of all
        images at this LoD, response-ranked, capped."""
        ids = {r.id for r in self.find_images_from_lod(lod)}
        mask = np.isin(self._kp["image_id"], list(ids))
        return self._select(self._ranked(mask, limit))

    def read_keypoints_from_coordinates(self, x_start, x_end, y_start, y_end,
                                        lod: int, limit: int = MAX_POINTS):
        """Spatial window per LoD (keypointdb.rs:67-90): keypoints of
        images overlapping the window, with keypoint coords inside it."""
        imgs = self.find_images_from_dimensions(x_start, x_end,
                                                y_start, y_end, lod)
        ids = [r.id for r in imgs]
        mask = np.isin(self._kp["image_id"], ids)
        mask &= (self._kp["x"] >= x_start) & (self._kp["x"] <= x_end)
        mask &= (self._kp["y"] >= y_start) & (self._kp["y"] <= y_end)
        return self._select(self._ranked(mask, limit))

    def _select(self, idx: np.ndarray):
        cols = {f: self._kp[f][idx] for f in _KP_FIELDS}
        return cols, self._desc[idx]

    # ---- geotransform + elevation (elevationdb.rs) ---------------------

    def set_geotransform(self, dataset_id: int, gt):
        """create_geotransform (elevationdb.rs:21-36)."""
        gt = np.asarray(gt, np.float64)
        assert gt.shape == (6,)
        self._geotransforms[dataset_id] = gt

    def get_geotransform(self, dataset_id: int) -> np.ndarray:
        return self._geotransforms[dataset_id]

    def world_dataset_id(self) -> Optional[int]:
        """The dataset id whose geotransform maps keypoint reference-frame
        pixels to world coordinates.

        Keypoint xy are stored in the mosaic reference frame; preprocess
        registers the mosaic geotransform as dataset 1 and the elevation
        raster's as dataset 2 (mirroring the reference's create_geotransform
        call order, elevationdb.rs:21-36 / preprocessor main.rs:128-140).
        Returns None when no mosaic geotransform exists; raises if extra
        geotransforms make the keypoint→world mapping ambiguous.
        """
        ids = sorted(k for k in self._geotransforms
                     if k != ELEVATION_DATASET_ID)
        if not ids:
            return None
        if ids != [MOSAIC_DATASET_ID]:
            raise ValueError(
                f"ambiguous world mapping: geotransforms registered for "
                f"datasets {ids}; keypoint coordinates are in the mosaic "
                f"(dataset {MOSAIC_DATASET_ID}) reference frame only")
        return MOSAIC_DATASET_ID

    def set_elevation(self, raster, gt):
        """add_elevation_data (elevationdb.rs:191-232): full-raster store
        (kept as a 2-D array, not row-per-pixel)."""
        self._elevation = np.asarray(raster, np.float32)
        self._elevation_gt = np.asarray(gt, np.float64)

    def get_elevation(self, x: int, y: int) -> float:
        """get_elevation (elevationdb.rs:234-245): single-pixel read."""
        return float(self._elevation[int(y), int(x)])

    def get_world_coordinates(self, dataset_id: int, px, py) -> np.ndarray:
        """pixel → ECEF (elevationdb.rs:64-104): mosaic geotransform →
        world lon/lat → elevation-pixel → height → EPSG:4978. Vectorized
        over arrays of pixels (the reference loops one at a time)."""
        from cubesat_apds_tpu_torch.core import geodesy as G

        gt = self._geotransforms[dataset_id]
        wx, wy = G.geotransform_apply(gt, np.asarray(px, np.float64),
                                      np.asarray(py, np.float64))
        ex, ey = G.world_to_pixel(self._elevation_gt, wx, wy)
        h, w = self._elevation.shape
        exi = np.clip(np.asarray(np.floor(ex), np.int64), 0, w - 1)
        eyi = np.clip(np.asarray(np.floor(ey), np.int64), 0, h - 1)
        height = self._elevation[eyi, exi]
        return np.asarray(G.geodetic_to_ecef(wx, wy, height))

    # ---- device export -------------------------------------------------

    def export_device_block(self, lod: Optional[int] = None,
                            pad_multiple: int = 2048,
                            limit: int = MAX_POINTS):
        """Padded (descriptors, xy, valid, image_id) block for on-device
        matching: response-ranked, capped at `limit` rows (the reference's
        2^18−1 unless the caller asks for more), zero-padded to a multiple
        of `pad_multiple` so shapes are reusable across DB growth."""
        if lod is None:
            idx = self._ranked(np.ones(len(self), bool), limit)
            cols, desc = self._select(idx)
        else:
            cols, desc = self.read_keypoints_from_lod(lod, limit)
        return device_block(cols, desc, pad_multiple)

    # ---- persistence ---------------------------------------------------

    def save(self, path: str):
        os.makedirs(path, exist_ok=True)
        np.savez_compressed(
            os.path.join(path, "keypoints.npz"),
            desc=self._desc, **self._kp)
        manifest = {
            "version": 1,
            "next_image_id": self._next_image_id,
            "images": [dataclasses.asdict(r) for r in self._images.values()],
            "geotransforms": {str(k): v.tolist()
                              for k, v in self._geotransforms.items()},
            "has_elevation": self._elevation is not None,
            "descriptor_mode": self.descriptor_mode,
        }
        if self._elevation is not None:
            np.savez_compressed(os.path.join(path, "elevation.npz"),
                                raster=self._elevation, gt=self._elevation_gt)
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f)

    @classmethod
    def load(cls, path: str) -> "FeatureStore":
        store = cls()
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(path, "keypoints.npz"))
        for f_ in _KP_FIELDS:
            store._buf[f_] = np.ascontiguousarray(data[f_])
        store._desc_buf = np.ascontiguousarray(data["desc"])
        store._n = len(store._desc_buf)
        store._next_image_id = manifest["next_image_id"]
        for r in manifest["images"]:
            store._images[r["id"]] = ImageRecord(**r)
        for k, v in manifest["geotransforms"].items():
            store._geotransforms[int(k)] = np.asarray(v, np.float64)
        if manifest["has_elevation"]:
            el = np.load(os.path.join(path, "elevation.npz"))
            store._elevation = el["raster"]
            store._elevation_gt = el["gt"]
        store.descriptor_mode = manifest.get("descriptor_mode")
        return store


def device_block(cols, desc, pad_multiple: int):
    """Query result → (descriptors, xy, valid, image_id), zero-padded to a
    multiple of `pad_multiple` rows."""
    n = len(desc)
    m = max(pad_multiple, ((n + pad_multiple - 1) // pad_multiple)
            * pad_multiple)
    desc_p = np.zeros((m, DESC_BYTES), np.uint8)
    desc_p[:n] = desc
    xy = np.zeros((m, 2), np.float32)
    xy[:n, 0] = cols["x"]
    xy[:n, 1] = cols["y"]
    img_id = np.zeros(m, np.int32)
    img_id[:n] = cols["image_id"]
    valid = np.zeros(m, bool)
    valid[:n] = True
    return desc_p, xy, valid, img_id
