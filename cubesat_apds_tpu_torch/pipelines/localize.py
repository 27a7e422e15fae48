"""Online localization: camera frame → features → match → pose (port of
pipelines/localize.py, the main path).

AKAZE on the frame, kNN-2 ratio match against the DB descriptors, RANSAC
homography, and optionally PnP-RANSAC against the DB's world points.
Everything runs on the device of the DB's tensors; `Localizer` keeps one
DB resident on its device (the card unless the caller names another) for
repeated frames. A DB past `MatchConfig.db_block` rows matches through the
kNN-2 kernel, with its layout made once per DB.

The pruned serving path (`make_pruned_db`, `localize_frame_pruned`) keeps
the DB sorted by spatial cell and matches each frame against the rows
inside a window found from a coarse DB, with no O(M) work per frame.

A stored DB (store/*, opened with `store.open_store`) loads one LoD at a
time: `load_device_db`, `load_pruned_device_db`, `Localizer` given a
store, and the two-stage `localize_coarse_to_fine`. World points are the
store's ECEF coordinates, computed in float64 on the host at load.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cubesat_apds_tpu_torch.core.config import (
    MAX_POINTS, MatchConfig, PipelineConfig)
from cubesat_apds_tpu_torch.core.types import (
    CameraModel, Correspondences, Features, HomographyResult, Keypoints,
    Matches, PoseSolution, to_device)
from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute
from cubesat_apds_tpu_torch.ops.geometry.homography import (
    find_homography_ransac)
from cubesat_apds_tpu_torch.ops.geometry.pnp import solve_pnp_ransac
from cubesat_apds_tpu_torch.ops.geometry.rodrigues import rodrigues_to_matrix
from cubesat_apds_tpu_torch.ops.match import knn_match, matched_points
from cubesat_apds_tpu_torch.store.feature_store import device_block


@dataclasses.dataclass
class DeviceDb:
    """Device-resident descriptor DB block (one LoD).

    `world_frame` tags obj_points: "ecef" enables PnP's above-terrain
    gate (up ≈ centroid direction), "local" disables it. `match_layout`
    optionally holds the kNN-2 kernel's layout of this DB
    (ops/kernels/match_kernel.layout_db_blocks), so repeated frames skip
    the repack; `Localizer` fills it for a big DB on the card.
    """

    descriptors: torch.Tensor   # [M, 61] uint8
    xy: torch.Tensor            # [M, 2] float32 — reference-frame coords
    valid: torch.Tensor         # [M] bool
    obj_points: torch.Tensor    # [M, 3] float32 (zeros if no elevation)
    has_world: bool = False
    match_layout: Optional[tuple] = None
    world_frame: str = "local"

    @property
    def device(self) -> torch.device:
        return self.descriptors.device


def _maybe_match_layout(desc, valid, match_config: MatchConfig):
    """The kNN-2 kernel's layout of a DB when the big-DB kernel path would
    be taken for it (CUDA tensors, more than db_block rows, kernel not
    forced to the scan); None otherwise."""
    if (match_config.kernel == "scan"
            or desc.shape[0] <= match_config.db_block
            or desc.device.type != "cuda"):
        return None
    from cubesat_apds_tpu_torch.ops.kernels.match_kernel import (
        layout_db_blocks, pack_words)
    return layout_db_blocks(pack_words(desc), valid)


def _world_points(store, xy, valid, has_world: bool):
    """[M, 3] float32 ECEF points of the rows at reference-frame `xy`
    (zeros where not valid, or everywhere without a world mapping)."""
    if not has_world:
        return np.zeros((len(xy), 3), np.float32)
    obj = store.get_world_coordinates(store.world_dataset_id(), xy[:, 0],
                                      xy[:, 1])
    return np.where(valid[:, None], obj, 0.0).astype(np.float32)


def _device_db(desc, xy, valid, obj, has_world, match_config, device):
    """A DeviceDb of host arrays on `device`, with the kNN-2 layout made
    there where the big-DB kernel path would take it."""
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
         for a in (desc, xy, valid, obj)]
    return DeviceDb(descriptors=t[0], xy=t[1], valid=t[2], obj_points=t[3],
                    has_world=has_world,
                    match_layout=_maybe_match_layout(
                        t[0], t[2], match_config or MatchConfig()),
                    # get_world_coordinates always emits EPSG:4978 ECEF.
                    world_frame="ecef" if has_world else "local")


def load_device_db(store, lod: int = 0, pad_multiple: int = 2048,
                   match_config: Optional[MatchConfig] = None,
                   device="cuda", limit: int = MAX_POINTS) -> DeviceDb:
    """One LoD of a store (either backend) as a DeviceDb on `device` (the
    card unless the caller names another), with ECEF world points where
    the store has elevation data, and the kNN-2 layout made once where
    the DB exceeds `match_config.db_block` on the card.

    The rows are the store's LoD query: response-ranked and capped at
    `limit` (the reference's 2^18−1 unless the caller asks for more),
    zero-padded to a multiple of `pad_multiple`.
    """
    desc, xy, valid, _ = store.export_device_block(lod, pad_multiple, limit)
    world_id = store.world_dataset_id()
    has_world = store._elevation is not None and world_id is not None
    return _device_db(desc, xy, valid,
                      _world_points(store, xy, valid, has_world), has_world,
                      match_config, device)


def check_descriptor_mode(store, config: PipelineConfig):
    """Refuse a store/config descriptor-mode mismatch.

    Exact and fast MLDB sampling produce incompatible bit patterns; a
    frame described in one mode matched against a DB built in the other
    collapses to near-zero ratio matches with no other symptom. Stores
    record their mode at build time (None = pre-provenance store,
    accepted as-is)."""
    mode = getattr(store, "descriptor_mode", None)
    want = config.akaze.descriptor_tag
    if mode is not None and mode != want:
        raise ValueError(
            f"store was built with descriptor_mode='{mode}' but the "
            f"pipeline config produces '{want}' — descriptors across "
            f"modes don't match; pass a config matching '{mode}' "
            "or rebuild the store")


def _store_lods(store):
    images = store.images if hasattr(store, "images") else store._images
    return sorted({r.level_of_detail for r in images.values()})


@dataclasses.dataclass
class LocalizationResult:
    homography: HomographyResult
    pose: Optional[PoseSolution]
    num_matches: torch.Tensor
    num_keypoints: torch.Tensor
    keypoints: Optional[Keypoints] = None
    matches: Optional[Matches] = None


def solve_pose_recentered(db_obj_points, img_points, matches: Matches,
                          camera: CameraModel, pnp_config,
                          world_frame: str = "ecef",
                          r=None) -> PoseSolution:
    """PnP against matched world points, recentred on the valid-match
    centroid (ECEF magnitudes ~6.4e6 m starve float32 otherwise):
    cam = R·obj + (t − R·centroid). For world_frame="ecef" the local up
    (≈ centroid direction) gates hypothesis selection."""
    obj = db_obj_points[matches.train_idx.long()]
    w = matches.valid.to(torch.float32)[:, None]
    centroid = (obj * w).sum(0) / w.sum().clamp(min=1.0)
    corr = Correspondences(obj_points=(obj - centroid).to(torch.float32),
                           img_points=img_points, valid=matches.valid)
    up = None
    if world_frame == "ecef":
        up = centroid / torch.linalg.vector_norm(centroid).clamp(min=1e-6)
    pose = solve_pnp_ransac(corr, camera, pnp_config, up=up, r=r)
    R = rodrigues_to_matrix(pose.rvec)
    # R @ centroid as an elementwise multiply and sum, as the JAX package.
    r_c = (R * centroid.to(torch.float32)[None, :]).sum(1)
    return PoseSolution(rvec=pose.rvec, tvec=pose.tvec - r_c,
                        inliers=pose.inliers,
                        num_inliers=pose.num_inliers, ok=pose.ok)


def localize_from_features(feats: Features, db: DeviceDb,
                           camera: CameraModel, config: PipelineConfig,
                           solve_pose: bool) -> LocalizationResult:
    """Match + geometry on already-extracted features."""
    kp = feats.keypoints
    matches = knn_match(feats.descriptors, db.descriptors,
                        ratio=config.match.ratio, q_valid=kp.valid,
                        db_valid=db.valid, block=config.match.db_block,
                        kernel=config.match.kernel, db_layout=db.match_layout)
    q_pts, t_pts = matched_points(kp.xy, db.xy, matches)
    homog = find_homography_ransac(q_pts, t_pts, valid=matches.valid,
                                   config=config.ransac)
    pose = None
    if solve_pose:
        pose = solve_pose_recentered(db.obj_points, q_pts, matches, camera,
                                     config.pnp, world_frame=db.world_frame)
    return LocalizationResult(homography=homog, pose=pose,
                              num_matches=matches.count(),
                              num_keypoints=kp.count(), keypoints=kp,
                              matches=matches)


def localize_frame(frame, db: DeviceDb, camera: CameraModel,
                   config: PipelineConfig = PipelineConfig(),
                   solve_pose: bool = False) -> LocalizationResult:
    """frame [H, W] float32 grayscale → homography (+ pose) against `db`,
    on the DB's device (the counterpart of localize_frame_jit)."""
    frame = torch.as_tensor(frame, dtype=torch.float32).to(db.device)
    feats = detect_and_compute(frame, config.akaze)
    return localize_from_features(feats, db, to_device(camera, db.device),
                                  config, solve_pose)


def resident_db(db: DeviceDb, config: PipelineConfig, device) -> DeviceDb:
    """`db` on `device`, with the kNN-2 layout made there once where the
    big-DB kernel path would take it."""
    db = to_device(db, device)
    if db.match_layout is None:
        db = dataclasses.replace(db, match_layout=_maybe_match_layout(
            db.descriptors, db.valid, config.match))
    return db


class Localizer:
    """Serving-path localizer with a DB kept resident on one device.

    Given a DeviceDb (built from arrays, e.g. with convert.device_db_from),
    the DB and the camera move to `device` once — the card ("cuda")
    unless the caller names another; without a card that raises — and a
    big DB's kNN-2 layout is made there once. Given a store, it checks the
    store's descriptor mode and loads each LoD once, on first use, with
    `load_device_db`. Every `localize` call then runs just the pipeline.
    """

    def __init__(self, db, camera: CameraModel,
                 config: PipelineConfig = PipelineConfig(), device=None,
                 pad_multiple: int = 2048):
        self.device = torch.device("cuda" if device is None else device)
        self.camera = to_device(camera, self.device)
        self.config = config
        self.pad_multiple = pad_multiple
        self._dbs: dict = {}
        self.store = None
        if isinstance(db, DeviceDb):
            self._dbs[0] = resident_db(db, config, self.device)
        else:
            check_descriptor_mode(db, config)
            self.store = db

    def device_db(self, lod: int = 0) -> DeviceDb:
        if lod not in self._dbs:
            if self.store is None:
                raise KeyError(f"Localizer holds one DeviceDb (LoD 0), not "
                               f"LoD {lod}")
            self._dbs[lod] = load_device_db(self.store, lod, self.pad_multiple,
                                            self.config.match, self.device)
        return self._dbs[lod]

    @property
    def db(self) -> DeviceDb:
        return self.device_db(0)

    def localize(self, frame, lod: int = 0,
                 solve_pose: Optional[bool] = None) -> LocalizationResult:
        db = self.device_db(lod)
        if solve_pose is None:
            solve_pose = db.has_world
        return localize_frame(frame, db, self.camera, self.config,
                              solve_pose)


# ---- spatially pruned serving ---------------------------------------------
#
# The full DB is sorted by spatial cell once (a _GRID × _GRID grid over the
# reference frame, row-major), so a frame's window is a few contiguous runs
# of rows: per intersected cell row, one [start, end) range from the CSR
# offsets. The runs are compacted into a [window_capacity] position vector
# by index arithmetic, then ONE gather of packed int32 rows (descriptor | xy
# | obj) brings the window's rows together, and the exact bbox test masks
# them. No O(M) work per frame.

_ROW_WORDS = 22  # 16 desc (61 B → 64 B) + 2 xy + 3 obj + 1 pad, int32
_GRID = 64       # cells per axis of the spatial grid


def _pack_prune_rows(desc, xy, obj):
    """[M, 22] int32 row table: one gather brings a row's descriptor
    bytes, reference-frame xy and object point together."""
    m = desc.shape[0]
    desc = desc.to(torch.uint8)
    desc_w = torch.cat([desc, desc.new_zeros((m, 3))], 1).view(torch.int32)
    xy_w = xy.to(torch.float32).contiguous().view(torch.int32)
    obj_w = obj.to(torch.float32).contiguous().view(torch.int32)
    pad = torch.zeros((m, _ROW_WORDS - 21), dtype=torch.int32,
                      device=desc.device)
    return torch.cat([desc_w, xy_w, obj_w, pad], dim=1)


def _unpack_prune_rows(rows):
    desc = rows[:, :16].contiguous().view(torch.uint8)[:, :61]
    xy = rows[:, 16:18].contiguous().view(torch.float32)
    obj = rows[:, 18:21].contiguous().view(torch.float32)
    return desc, xy, obj


@dataclasses.dataclass
class PrunedDeviceDb:
    """Serving DB with spatial pruning state.

    rows:   [M, 22] int32 packed (desc | xy | obj), SORTED by spatial cell
            (row-major over the _GRID × _GRID grid)
    order:  [M] int32 — global row id of each sorted row
    starts: [_GRID² + 1] int32 CSR offsets: the sorted rows of cell c are
            [starts[c], starts[c + 1])
    grid:   [4] float32 (x0, y0, inv_cell_w, inv_cell_h)
    coarse: small DeviceDb (a coarser LoD, or any subsample covering the
            reference frame) for the first-stage fix
    """

    rows: torch.Tensor
    order: torch.Tensor
    starts: torch.Tensor
    grid: torch.Tensor
    coarse: DeviceDb
    window_capacity: int = 16384
    has_world: bool = False
    world_frame: str = "local"

    @property
    def device(self) -> torch.device:
        return self.rows.device


def _grid_cell(v, origin, inv_cell):
    """Cell index of coordinates v along one axis, clipped to [0, _GRID).
    The float clamp first makes the int32 cast well defined for any input
    (a cast truncates toward zero; NaN lands in cell 0)."""
    f = ((v - origin) * inv_cell).clamp(-1.0, float(_GRID))
    return torch.nan_to_num(f, nan=0.0).to(torch.int32).clamp(0, _GRID - 1)


def _build_prune_index(desc, xy, obj, valid):
    """Sort rows by spatial cell; invalid rows sort to a sentinel cell past
    the grid (their range is never selected). One-time build cost."""
    x, y = xy[:, 0], xy[:, 1]
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=xy.device)

    def masked(v, fill):                    # nanmin/nanmax over valid rows
        return torch.where(valid & ~torch.isnan(v), v, fill)

    x0 = masked(x, inf).amin()
    y0 = masked(y, inf).amin()
    x1 = masked(x, -inf).amax()
    y1 = masked(y, -inf).amax()
    x0 = torch.where(torch.isfinite(x0), x0, 0.0)
    y0 = torch.where(torch.isfinite(y0), y0, 0.0)
    inv_cw = _GRID / (torch.where(torch.isfinite(x1), x1, 1.0) - x0).clamp(
        min=1e-6)
    inv_ch = _GRID / (torch.where(torch.isfinite(y1), y1, 1.0) - y0).clamp(
        min=1e-6)
    gx = _grid_cell(x, x0, inv_cw)
    gy = _grid_cell(y, y0, inv_ch)
    cell = torch.where(valid, gy * _GRID + gx, _GRID * _GRID)
    order = torch.argsort(cell, stable=True)
    cell_sorted = cell[order].contiguous()
    rows = _pack_prune_rows(desc[order], xy[order], obj[order])
    starts = torch.searchsorted(
        cell_sorted, torch.arange(_GRID * _GRID + 1, dtype=torch.int32,
                                  device=cell.device), side="left")
    grid = torch.stack([x0, y0, inv_cw, inv_ch]).to(torch.float32)
    return (rows, order.to(torch.int32), starts.to(torch.int32), grid)


def make_pruned_db(db: DeviceDb, coarse: DeviceDb,
                   window_capacity: int = 16384) -> PrunedDeviceDb:
    """Build the pruning state from a resident full DB and a coarse DB, on
    the full DB's device."""
    rows, order, starts, grid = _build_prune_index(
        db.descriptors, db.xy, db.obj_points, db.valid)
    return PrunedDeviceDb(rows=rows, order=order, starts=starts, grid=grid,
                          coarse=to_device(coarse, db.device),
                          window_capacity=window_capacity,
                          has_world=db.has_world, world_frame=db.world_frame)


def load_pruned_device_db(store, fine_lod: int = 0,
                          coarse_lod: Optional[int] = None,
                          window_capacity: int = 16384,
                          pad_multiple: int = 2048,
                          match_config: Optional[MatchConfig] = None,
                          device="cuda",
                          limit: int = MAX_POINTS) -> PrunedDeviceDb:
    """Store → PrunedDeviceDb on `device` (the card unless the caller
    names another): the fine LoD sorted by spatial cell, and the coarse
    LoD (the coarsest one by default) as the first-stage fix DB. `limit`
    caps each LoD's rows as in load_device_db."""
    if coarse_lod is None:
        coarse_lod = _store_lods(store)[-1]
    fine = load_device_db(store, fine_lod, pad_multiple, match_config,
                          device, limit)
    coarse = load_device_db(store, coarse_lod, pad_multiple, match_config,
                            device, limit)
    return make_pruned_db(fine, coarse, window_capacity)


@dataclasses.dataclass
class PrunedLocalizationResult:
    result: LocalizationResult       # the fine-stage result
    coarse_ok: torch.Tensor          # bool — coarse fix succeeded
    window: torch.Tensor             # [4] f32 (x0, x1, y0, y1) ref frame
    n_window: torch.Tensor           # int32 — rows inside the window
    overflow: torch.Tensor           # bool — more rows than the capacity
    sel: torch.Tensor                # [C] int32 global row ids (M = none)


@dataclasses.dataclass
class WindowRows:
    """The rows of a window, gathered into window_capacity slots."""

    desc: torch.Tensor       # [C, 61] uint8
    xy: torch.Tensor         # [C, 2] float32
    obj: torch.Tensor        # [C, 3] float32
    valid: torch.Tensor      # [C] bool — slot holds a row inside the window
    sel: torch.Tensor        # [C] int32 global row id, M where not valid
    n_window: torch.Tensor   # int32
    overflow: torch.Tensor   # bool — the cells held more than C rows


def window_rows(pdb: PrunedDeviceDb, window) -> WindowRows:
    """Rows of the pruned DB inside window = (x0, x1, y0, y1).

    The window's cells form ≤ _GRID contiguous runs of sorted rows (one
    per intersected cell row); slot k of the [C] vector takes the k-th row
    of the concatenated runs (rows past C are dropped, and `overflow`
    says so). Cells are a superset of the window, so the exact bbox test
    on the gathered rows sets `valid`."""
    lo = window[0::2]
    hi = window[1::2]
    g = pdb.grid
    gx0 = _grid_cell(lo[0], g[0], g[2])
    gx1 = _grid_cell(hi[0], g[0], g[2])
    gy0 = _grid_cell(lo[1], g[1], g[3])
    gy1 = _grid_cell(hi[1], g[1], g[3])
    dev = pdb.rows.device
    gys = torch.arange(_GRID, dtype=torch.int32, device=dev)
    band_in = (gys >= gy0) & (gys <= gy1)
    band_start = pdb.starts[(gys * _GRID + gx0).long()]
    band_len = torch.where(
        band_in, pdb.starts[(gys * _GRID + gx1 + 1).long()] - band_start, 0)
    offs = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                      torch.cumsum(band_len, 0, dtype=torch.int32)])
    total = offs[-1]
    m_total = pdb.rows.shape[0]
    c = pdb.window_capacity
    k = torch.arange(c, dtype=torch.int32, device=dev)
    # Band of slot k = the number of run ends at or before k.
    band_of = torch.searchsorted(offs[1:].contiguous(), k, side="right",
                                 out_int32=True).clamp(0, _GRID - 1)
    pos = band_start[band_of.long()] + (k - offs[band_of.long()])
    sel_ok = k < torch.clamp(total, max=c)
    pos = torch.where(sel_ok, pos.clamp(0, max(m_total - 1, 0)), 0)
    desc_s, xy_s, obj_s = _unpack_prune_rows(pdb.rows[pos.long()])
    sel_ok = (sel_ok
              & (xy_s[:, 0] >= lo[0]) & (xy_s[:, 0] <= hi[0])
              & (xy_s[:, 1] >= lo[1]) & (xy_s[:, 1] <= hi[1]))
    return WindowRows(
        desc=desc_s, xy=xy_s, obj=obj_s, valid=sel_ok,
        sel=torch.where(sel_ok, pdb.order[pos.long()], m_total),
        n_window=sel_ok.sum(dtype=torch.int32), overflow=total > c)


def _pruned_back_half(feats: Features, frame_hw, pdb: PrunedDeviceDb,
                      camera: CameraModel, config: PipelineConfig,
                      solve_pose: bool, margin: float
                      ) -> PrunedLocalizationResult:
    """Coarse fix, window, fine match and geometry on extracted features."""
    kp = feats.keypoints

    # Stage 1: coarse fix against the small DB.
    cm = knn_match(feats.descriptors, pdb.coarse.descriptors,
                   ratio=config.match.ratio, q_valid=kp.valid,
                   db_valid=pdb.coarse.valid, block=config.match.db_block,
                   kernel=config.match.kernel,
                   db_layout=pdb.coarse.match_layout)
    cq, ct = matched_points(kp.xy, pdb.coarse.xy, cm)
    coarse_h = find_homography_ransac(cq, ct, valid=cm.valid,
                                      config=config.ransac)

    # Reference-frame window = the frame's corners through the coarse H,
    # grown by `margin` of its extent on each side.
    h, w = frame_hw
    corners = torch.tensor([[0.0, 0.0, 1.0], [w, 0.0, 1.0], [0.0, h, 1.0],
                            [w, h, 1.0]], dtype=torch.float32,
                           device=kp.xy.device)
    proj = corners @ coarse_h.H.T
    den = proj[:, 2:3]
    pxy = proj[:, :2] / torch.where(den.abs() < 1e-9, 1e-9, den)
    lo = pxy.amin(0)
    hi = pxy.amax(0)
    pad = margin * (hi - lo)
    lo = lo - pad
    hi = hi + pad
    window = torch.stack([lo[0], hi[0], lo[1], hi[1]])

    # Stage 2: the window's rows. Stage 3: fine match + geometry on them.
    win = window_rows(pdb, window)
    fm = knn_match(feats.descriptors, win.desc, ratio=config.match.ratio,
                   q_valid=kp.valid, db_valid=win.valid,
                   block=config.match.db_block, kernel=config.match.kernel)
    q_pts, t_pts = matched_points(kp.xy, win.xy, fm)
    homog = find_homography_ransac(q_pts, t_pts, valid=fm.valid,
                                   config=config.ransac)
    pose = None
    if solve_pose:
        pose = solve_pose_recentered(win.obj, q_pts, fm, camera, config.pnp,
                                     world_frame=pdb.world_frame)
    fine = LocalizationResult(homography=homog, pose=pose,
                              num_matches=fm.count(),
                              num_keypoints=kp.count(), keypoints=kp,
                              matches=fm)
    return PrunedLocalizationResult(
        result=fine, coarse_ok=coarse_h.ok, window=window,
        n_window=win.n_window, overflow=win.overflow, sel=win.sel)


def localize_frame_pruned(frame, pdb: PrunedDeviceDb, camera: CameraModel,
                          config: PipelineConfig = PipelineConfig(),
                          solve_pose: bool = False,
                          margin: float = 0.25) -> PrunedLocalizationResult:
    """Pruned localization on the pruned DB's device: detect once, coarse
    fix, spatial window, fine match on the window's rows (the counterpart
    of localize_frame_pruned_jit).

    When the coarse fix fails, `coarse_ok` is False and the fine result is
    meaningless: callers fall back to `localize_frame_pruned_fallback`.
    If more rows fall in the window's cells than `window_capacity`,
    `overflow` is set and the excess rows are dropped in row order.
    """
    frame = torch.as_tensor(frame, dtype=torch.float32).to(pdb.device)
    feats = detect_and_compute(frame, config.akaze)
    return _pruned_back_half(feats, tuple(frame.shape), pdb,
                             to_device(camera, pdb.device), config,
                             solve_pose, margin)


def localize_frame_pruned_fallback(frame, pdb: PrunedDeviceDb,
                                   camera: CameraModel,
                                   config: PipelineConfig = PipelineConfig(),
                                   solve_pose: bool = False
                                   ) -> LocalizationResult:
    """Full-DB localization rebuilt from the pruned ROW TABLE (the rare
    coarse-miss / overflow fallback): the DB in sorted order, valid below
    starts[-1], so no second resident copy of the full DB is kept."""
    desc, xy, obj = _unpack_prune_rows(pdb.rows)
    valid = torch.arange(pdb.rows.shape[0], dtype=torch.int32,
                         device=pdb.device) < pdb.starts[-1]
    db = DeviceDb(descriptors=desc, xy=xy, valid=valid, obj_points=obj,
                  has_world=pdb.has_world, world_frame=pdb.world_frame)
    return localize_frame(frame, db, camera, config, solve_pose)


def localize_coarse_to_fine(frame, store, camera: CameraModel,
                            config: PipelineConfig = PipelineConfig(),
                            coarse_lod: Optional[int] = None,
                            margin: float = 0.25,
                            pad_multiple: int = 2048,
                            solve_pose: Optional[bool] = None,
                            coarse_db: Optional[DeviceDb] = None,
                            device="cuda"):
    """Two-stage localization over a store's LoD pyramid, through the
    HOST store: match against the coarse LoD's DB, project the frame's
    corners through the coarse homography to a reference-frame window
    grown by `margin`, then match against the LoD-0 keypoints the store's
    window query returns (keypointdb.rs:67-90 semantics). Without a
    coarse fix the fine stage takes the whole LoD-0 DB.

    The fine DB is padded to pad_multiple·2^k rows, the smallest that
    holds the window, as the JAX package's ladder of shapes does. Runs on
    `device` (the card unless the caller names another); `coarse_db`, if
    given, is used as the coarse DB instead of loading it. Returns
    (fine_result, coarse_result, window or None).
    """
    check_descriptor_mode(store, config)
    lods = _store_lods(store)
    if coarse_lod is None:
        coarse_lod = lods[-1]
    if coarse_db is None:
        coarse_db = load_device_db(store, coarse_lod, pad_multiple,
                                   config.match, device)
    frame = torch.as_tensor(frame, dtype=torch.float32)
    if solve_pose is None:
        solve_pose = coarse_db.has_world
    coarse = localize_frame(frame, coarse_db, camera, config, False)

    H = coarse.homography.H.cpu().numpy().astype(np.float64)
    h, w = frame.shape
    corners = np.array([[0, 0, 1], [w, 0, 1], [0, h, 1], [w, h, 1]],
                       np.float64)
    proj = corners @ H.T
    proj = proj[:, :2] / np.clip(proj[:, 2:3], 1e-9, None)
    x0, y0 = proj.min(axis=0)
    x1, y1 = proj.max(axis=0)
    mx = margin * (x1 - x0)
    my = margin * (y1 - y0)
    window = (x0 - mx, x1 + mx, y0 - my, y1 + my)

    if not bool(coarse.homography.ok):
        fine_db = load_device_db(store, lods[0], pad_multiple, config.match,
                                 device)
        fine = localize_frame(frame, fine_db, camera, config, solve_pose)
        return fine, coarse, None

    cols, desc = store.read_keypoints_from_coordinates(
        window[0], window[1], window[2], window[3], lods[0])
    n = len(desc)
    m = pad_multiple
    while m < n:
        m *= 2
    desc_p, xy_p, valid_p, _ = device_block(cols, desc, m)
    has_world = coarse_db.has_world
    fine_db = _device_db(
        desc_p, xy_p, valid_p,
        _world_points(store, xy_p, valid_p, has_world and n > 0),
        has_world, config.match, device)
    fine = localize_frame(frame, fine_db, camera, config,
                          solve_pose and has_world)
    return fine, coarse, window
