"""The back half in plain PyTorch: match, RANSAC homography and
PnP-RANSAC, batch-first, and the spatially pruned path (the prune index,
the window, the coarse fix and the fine match). A frozen copy of the
port's pipelines/localize.py functions that the card runs as CUDA graphs
(`localize_from_features`, `_pruned_back_half`) and of the pruned DB's
build (`make_pruned_db`), with no graph and no kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from apds_bench.reference.config import (
    PipelineConfig)
from apds_bench.reference.types_ import (
    CameraModel, Correspondences, Features, HomographyResult, Keypoints,
    Matches, PoseSolution, device_const, fold_lead, to_device, unfold_lead)
from apds_bench.reference.homography import (
    find_homography_ransac)
from apds_bench.reference.linalg_small import bmm
from apds_bench.reference.pnp import solve_pnp_ransac
from apds_bench.reference.rodrigues import rodrigues_to_matrix
from apds_bench.reference.match import (
    db_rows, knn_match, matched_points)


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


@dataclasses.dataclass
class LocalizationResult:
    """A frame's result; every field leads with the batch's dimensions
    when the back half ran a batch."""

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
    (≈ centroid direction) gates hypothesis selection.

    matches and img_points [..., Q(, 2)] may lead with a batch: each frame
    gets its own centroid and up vector; db_obj_points [M, 3] is one DB,
    [..., M, 3] one per frame."""
    obj = db_rows(db_obj_points, matches.train_idx)
    w = matches.valid.to(torch.float32)[..., None]
    centroid = (obj * w).sum(-2) / w.sum(-2).clamp(min=1.0)
    corr = Correspondences(
        obj_points=(obj - centroid[..., None, :]).to(torch.float32),
        img_points=img_points, valid=matches.valid)
    up = None
    if world_frame == "ecef":
        up = centroid / torch.linalg.vector_norm(
            centroid, dim=-1, keepdim=True).clamp(min=1e-6)
    pose = solve_pnp_ransac(corr, camera, pnp_config, up=up, r=r)
    R = rodrigues_to_matrix(pose.rvec)
    # R @ centroid as an elementwise multiply and sum, as the JAX package.
    r_c = (R * centroid.to(torch.float32)[..., None, :]).sum(-1)
    return PoseSolution(rvec=pose.rvec, tvec=pose.tvec - r_c,
                        inliers=pose.inliers,
                        num_inliers=pose.num_inliers, ok=pose.ok)


def localize_from_features(feats: Features, db: DeviceDb,
                           camera: CameraModel, config: PipelineConfig,
                           solve_pose: bool) -> LocalizationResult:
    """Match + geometry on already-extracted features: one frame, or a
    batch (leading dimensions) in one pass — one match of all its
    queries, one RANSAC and one PnP-RANSAC."""
    kp = feats.keypoints
    matches = knn_match(feats.descriptors, db.descriptors,
                        ratio=config.match.ratio, q_valid=kp.valid,
                        db_valid=db.valid, block=config.match.db_block,
                        kernel=config.match.kernel, db_layout=db.match_layout)
    return localize_from_matches(kp, matches, db.xy, db.obj_points,
                                 db.world_frame, camera, config, solve_pose)


def localize_from_matches(kp: Keypoints, matches: Matches, db_xy, db_obj,
                          world_frame: str, camera: CameraModel,
                          config: PipelineConfig,
                          solve_pose: bool) -> LocalizationResult:
    """The geometry of a frame, or of a batch of frames in one pass, from
    its matches: RANSAC homography and, if asked, PnP against the DB's
    world points."""
    q_pts, t_pts = matched_points(kp.xy, db_xy, matches)
    homog = find_homography_ransac(q_pts, t_pts, valid=matches.valid,
                                   config=config.ransac)
    pose = None
    if solve_pose:
        pose = solve_pose_recentered(db_obj, q_pts, matches, camera,
                                     config.pnp, world_frame=world_frame)
    return LocalizationResult(homography=homog, pose=pose,
                              num_matches=matches.count(),
                              num_keypoints=kp.count(), keypoints=kp,
                              matches=matches)


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
    """[..., 22] int32 rows → (desc [..., 61] uint8, xy [..., 2], obj
    [..., 3])."""
    desc = rows[..., :16].contiguous().view(torch.uint8)[..., :61]
    xy = rows[..., 16:18].contiguous().view(torch.float32)
    obj = rows[..., 18:21].contiguous().view(torch.float32)
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


@dataclasses.dataclass
class PrunedLocalizationResult:
    """The pruned step's result (fields lead with the batch's dimensions
    when the back half ran a batch)."""

    result: LocalizationResult       # the fine-stage result
    coarse_ok: torch.Tensor          # bool — coarse fix succeeded
    window: torch.Tensor             # [4] f32 (x0, x1, y0, y1) ref frame
    n_window: torch.Tensor           # int32 — rows inside the window
    overflow: torch.Tensor           # bool — more rows than the capacity
    sel: torch.Tensor                # [C] int32 global row ids (M = none)


@dataclasses.dataclass
class WindowRows:
    """The rows of a window, gathered into window_capacity slots (fields
    lead with the windows' batch dimensions)."""

    desc: torch.Tensor       # [C, 61] uint8
    xy: torch.Tensor         # [C, 2] float32
    obj: torch.Tensor        # [C, 3] float32
    valid: torch.Tensor      # [C] bool — slot holds a row inside the window
    sel: torch.Tensor        # [C] int32 global row id, M where not valid
    n_window: torch.Tensor   # int32
    overflow: torch.Tensor   # bool — the cells held more than C rows


def window_rows(pdb: PrunedDeviceDb, window) -> WindowRows:
    """Rows of the pruned DB inside window = (x0, x1, y0, y1), [..., 4]:
    one window per frame of a batch (leading dimensions), each with its
    own window_capacity slots.

    The window's cells form ≤ _GRID contiguous runs of sorted rows (one
    per intersected cell row); slot k of the [C] vector takes the k-th row
    of the concatenated runs (rows past C are dropped, and `overflow`
    says so). Cells are a superset of the window, so the exact bbox test
    on the gathered rows sets `valid`."""
    lead = window.shape[:-1]
    window = fold_lead(window, len(lead))                    # [B, 4]
    lo = window[:, 0::2]
    hi = window[:, 1::2]
    g = pdb.grid
    gx0 = _grid_cell(lo[:, 0], g[0], g[2])[:, None]          # [B, 1]
    gx1 = _grid_cell(hi[:, 0], g[0], g[2])[:, None]
    gy0 = _grid_cell(lo[:, 1], g[1], g[3])[:, None]
    gy1 = _grid_cell(hi[:, 1], g[1], g[3])[:, None]
    dev = pdb.rows.device
    gys = torch.arange(_GRID, dtype=torch.int32, device=dev)
    band_in = (gys >= gy0) & (gys <= gy1)                    # [B, G]
    band_start = pdb.starts[(gys * _GRID + gx0).long()]
    band_len = torch.where(
        band_in, pdb.starts[(gys * _GRID + gx1 + 1).long()] - band_start, 0)
    offs = torch.cat([torch.zeros_like(band_len[:, :1]),
                      torch.cumsum(band_len, -1, dtype=torch.int32)], -1)
    total = offs[:, -1:]                                     # [B, 1]
    m_total = pdb.rows.shape[0]
    c = pdb.window_capacity
    k = torch.arange(c, dtype=torch.int32, device=dev)
    # Band of slot k = the number of run ends at or before k.
    band_of = torch.searchsorted(
        offs[:, 1:].contiguous(), k.expand(window.shape[0], c).contiguous(),
        side="right", out_int32=True).clamp(0, _GRID - 1).long()
    pos = (torch.take_along_dim(band_start, band_of, -1)
           + (k - torch.take_along_dim(offs, band_of, -1)))
    sel_ok = k < torch.clamp(total, max=c)
    pos = torch.where(sel_ok, pos.clamp(0, max(m_total - 1, 0)), 0)
    desc_s, xy_s, obj_s = _unpack_prune_rows(pdb.rows[pos.long()])
    sel_ok = (sel_ok
              & (xy_s[..., 0] >= lo[:, 0:1]) & (xy_s[..., 0] <= hi[:, 0:1])
              & (xy_s[..., 1] >= lo[:, 1:2]) & (xy_s[..., 1] <= hi[:, 1:2]))
    return unfold_lead(WindowRows(
        desc=desc_s, xy=xy_s, obj=obj_s, valid=sel_ok,
        sel=torch.where(sel_ok, pdb.order[pos.long()], m_total),
        n_window=sel_ok.sum(-1, dtype=torch.int32),
        overflow=total[:, 0] > c), lead)


def _pruned_back_half(feats: Features, frame_hw, pdb: PrunedDeviceDb,
                      camera: CameraModel, config: PipelineConfig,
                      solve_pose: bool, margin: float
                      ) -> PrunedLocalizationResult:
    """Coarse fix, window, fine match and geometry on extracted features:
    one frame, or a batch (leading dimensions) in one pass — one coarse
    match and RANSAC, one window per frame, one fine match of every
    frame's queries against its own window's rows, then the geometry."""
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
    corners = device_const([[0.0, 0.0, 1.0], [w, 0.0, 1.0], [0.0, h, 1.0],
                             [w, h, 1.0]], torch.float32, kp.xy.device)
    proj = bmm(corners, coarse_h.H.transpose(-1, -2))        # [..., 4, 3]
    den = proj[..., 2:3]
    pxy = proj[..., :2] / torch.where(den.abs() < 1e-9, 1e-9, den)
    lo = pxy.amin(-2)
    hi = pxy.amax(-2)
    pad = margin * (hi - lo)
    lo = lo - pad
    hi = hi + pad
    window = torch.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]],
                         dim=-1)

    # Stage 2: the window's rows. Stage 3: fine match + geometry on them.
    win = window_rows(pdb, window)
    fm = knn_match(feats.descriptors, win.desc, ratio=config.match.ratio,
                   q_valid=kp.valid, db_valid=win.valid,
                   block=config.match.db_block, kernel=config.match.kernel)
    fine = localize_from_matches(kp, fm, win.xy, win.obj, pdb.world_frame,
                                 camera, config, solve_pose)
    return PrunedLocalizationResult(
        result=fine, coarse_ok=coarse_h.ok, window=window,
        n_window=win.n_window, overflow=win.overflow, sel=win.sel)


def fallback_db(pdb: PrunedDeviceDb) -> DeviceDb:
    """The full DB rebuilt from the pruned row table, as the coarse-miss /
    overflow fallback serves it: the rows in sorted order, valid below
    starts[-1]."""
    desc, xy, obj = _unpack_prune_rows(pdb.rows)
    valid = torch.arange(pdb.rows.shape[0], dtype=torch.int32,
                         device=pdb.device) < pdb.starts[-1]
    return DeviceDb(descriptors=desc, xy=xy, valid=valid, obj_points=obj,
                    has_world=pdb.has_world, world_frame=pdb.world_frame)
