"""Ground-truth accuracy runner — the mission metric — on the port (port of
benchmarks/bench_accuracy.py's `run` and `run_terrain`).

Renders camera frames with KNOWN pose (K, R, t in ECEF) from a synthetic
mosaic + DEM (utils/synthetic.py), builds the DB with `preprocess`
(amount_lod=1), localizes every frame with a `Localizer` on `device` (the
card unless the caller names another), and reports the end-task numbers
the reference never measures (its pose solvers stop at rvec/tvec,
homographier mod.rs:320-369):

  * attitude error (degrees, geodesic angle vs the true camera rotation)
  * position error (meters, ECEF camera-center distance)
  * homography-only ground-footprint error (meters)

across nadir / oblique / rotated / noisy / illumination-shifted
conditions, and over non-planar fractal terrain (per-pixel ray–DEM
rendering) at several relief magnitudes, where the homography model
degrades with parallax while 2D–3D PnP holds.

The seeds, conditions and sizes are the reference runner's (seed 2026, a
1024² mosaic at 1 m GSD, 512² frames, focal 1500 px, altitude 1500 m,
capacity 2048, ratio 0.75, 256 homography and 128 PnP hypotheses).
`mosaic_size`, `frame_size` and `capacity` shrink a run for a quick check;
the look-at margin scales with the frame. `modes` runs any of the
exact, fast and hybrid descriptor modes, each with its own DB build.
"""

from __future__ import annotations

import sys
import time
import zlib

import numpy as np
import torch

from cubesat_apds_tpu_torch.utils import synthetic as S

CONDITIONS = {
    # name: (camera kwargs, render kwargs)
    "nominal": ({}, {}),
    "oblique10": (dict(off_nadir_deg=10.0, azimuth_deg=30.0), {}),
    "oblique20": (dict(off_nadir_deg=20.0, azimuth_deg=-60.0), {}),
    "rot45": (dict(yaw_deg=45.0), {}),
    "noise": ({}, dict(noise_sigma=0.03)),
    "illum": ({}, dict(gain=0.75, gamma=1.3)),
    "combo": (dict(off_nadir_deg=10.0, yaw_deg=20.0),
              dict(noise_sigma=0.02, gain=0.85)),
}

ALTITUDE = 1500.0   # m — frame GSD ≈ mosaic GSD (1 m) at focal 1500 px
FOCAL = 1500.0
MOSAIC = 1024
FRAME = 512
MARGIN = 360.0      # look-at margin from the mosaic edge at FRAME

TERRAIN_RELIEFS = (20.0, 60.0, 120.0)
TERRAIN_CONDITIONS = {
    "nadir": {},
    "oblique20": dict(off_nadir_deg=20.0, azimuth_deg=-60.0),
}


def _stderr(s):
    print(s, file=sys.stderr)


def _cond_rng(seed: int, cond: str, extra: int = 0):
    """Process-stable per-condition RNG (crc32, not the per-process
    randomized hash() of strings), so every run samples the same
    scenes."""
    return np.random.default_rng(
        (zlib.crc32(cond.encode()) ^ (seed * 2654435761) ^ extra)
        % 2**32)


MODES = {
    "exact": dict(descriptor_mode="exact", orientation_mode="exact"),
    "fast": dict(descriptor_mode="fast", orientation_mode="fast"),
    "hybrid": dict(descriptor_mode="hybrid", orientation_mode="exact"),
}


def mode_config(mode: str, capacity: int = 2048):
    """The runner's PipelineConfig for descriptor mode `mode` (exact,
    fast with fast orientation, or hybrid with exact orientation)."""
    from cubesat_apds_tpu_torch.core.config import (
        AkazeConfig, MatchConfig, PipelineConfig, PnPConfig, RansacConfig)

    if mode not in MODES:
        raise ValueError(f"unknown descriptor mode {mode!r}")
    return PipelineConfig(
        akaze=AkazeConfig(capacity=capacity, **MODES[mode]),
        match=MatchConfig(ratio=0.75),
        ransac=RansacConfig(num_hypotheses=256),
        pnp=PnPConfig(num_hypotheses=128))


def build_world(seed: int = 2026, texture: str = "rects", *, device=None,
                mosaic_size: int = MOSAIC):
    """Mosaic + plane DEM + MosaicDataset on `device` (one world for every
    mode)."""
    from cubesat_apds_tpu_torch.io.mosaic import MosaicDataset

    rng = np.random.default_rng(seed)
    plane = S.PlaneDem(h0=120.0, gu=0.02, gv=-0.01)
    mosaic = S.make_mosaic(rng, size=mosaic_size, texture=texture)
    dem = S.make_dem(plane, mosaic_size)
    ds = MosaicDataset([mosaic], device=device)
    ds.set_elevation_dataset(dem)
    return mosaic, plane, ds


def build_terrain_world(seed: int, relief_m: float, texture: str = "rects",
                        *, device=None, mosaic_size: int = MOSAIC):
    """Mosaic + fractal heightfield DEM + MosaicDataset on `device`. The
    store's raster DEM samples the same continuous surface at 256² (its
    floor-quantization is part of the measured error budget, as the
    reference's single-pixel elevation reads are)."""
    from cubesat_apds_tpu_torch.io.mosaic import MosaicDataset

    rng = np.random.default_rng(seed)
    mosaic = S.make_mosaic(rng, size=mosaic_size, texture=texture)
    dem = S.make_fractal_dem(rng, mosaic_size, relief_m=relief_m)
    dem_raster = S.make_dem(dem, mosaic_size, dem_size=256)
    ds = MosaicDataset([mosaic], device=device)
    ds.set_elevation_dataset(dem_raster)
    return mosaic, dem, ds


def build_db(ds, cfg, progress=_stderr, label: str = ""):
    """The DB of one LoD through `preprocess` on the dataset's device."""
    from cubesat_apds_tpu_torch.pipelines.preprocess import preprocess

    progress(f"{label} building DB (preprocess)...")
    t0 = time.perf_counter()
    store, stats = preprocess(ds, config=cfg, amount_lod=1)
    progress(f"{label} DB built: {stats.keypoints} keypoints in "
             f"{stats.tiles} tiles, {time.perf_counter() - t0:.2f} s")
    return store


def scene_camera(mosaic, surface, rng, cam_kw, frame_size: int = FRAME):
    """A ground-truth camera looking at a look-at point drawn from `rng`
    (a different window of the mosaic for every scene, the footprint
    inside it)."""
    size = mosaic.bands.shape[-1]
    margin = MARGIN * frame_size / FRAME
    tx, ty = rng.uniform(margin, size - margin, 2)
    return S.make_camera(mosaic.geotransform, surface, target_px=(tx, ty),
                         altitude_m=ALTITUDE, focal_px=FOCAL,
                         frame=frame_size, **cam_kw)


def camera_model(cam, device=None):
    from cubesat_apds_tpu_torch.core.types import CameraModel

    dev = torch.device("cuda" if device is None else device)
    return CameraModel(K=torch.as_tensor(cam.K, dtype=torch.float32).to(dev),
                       dist=torch.zeros(5, dtype=torch.float32, device=dev))


def _summary(rows, fp_rows, extra):
    att = np.array([r["att"] for r in rows if r["ok"]])
    pos = np.array([r["pos"] for r in rows if r["ok"]])
    fp = np.array(fp_rows)

    def stat(x, fn, nd):
        return round(float(fn(x)), nd) if len(x) else None

    agg = dict(
        ok_rate=round(float(np.mean([r["ok"] for r in rows])), 4),
        att_med=stat(att, np.median, 4),
        att_p90=stat(att, lambda a: np.percentile(a, 90), 4),
        pos_med=stat(pos, np.median, 2),
        pos_p90=stat(pos, lambda a: np.percentile(a, 90), 2),
        fp_med=stat(fp, np.median, 2),
    )
    agg.update(extra)
    return agg


def run(n_scenes: int = 12, modes=("exact",), seed: int = 2026,
        texture: str = "rects", progress=_stderr, *, device=None,
        mosaic_size: int = MOSAIC, frame_size: int = FRAME,
        capacity: int = 2048, scenes=None):
    """Planar-world accuracy: {mode: {condition: summary}} with the
    reference runner's summary keys (ok_rate, att_med, att_p90, pos_med,
    pos_p90, fp_med, inl_med). `scenes`, a list, receives every scene's
    row (mode, condition, ok, att, pos, fp, inl, pnp_inl)."""
    from cubesat_apds_tpu_torch.pipelines.localize import Localizer

    dev = torch.device("cuda" if device is None else device)
    for mode in modes:
        mode_config(mode, capacity)                 # refuse before work
    mosaic, plane, ds = build_world(seed, texture, device=dev,
                                    mosaic_size=mosaic_size)
    gray = mosaic.bands[0] / 255.0
    results: dict = {}
    for mode in modes:
        cfg = mode_config(mode, capacity)
        store = build_db(ds, cfg, progress, f"[{mode}]")
        results[mode] = {}
        loc = None          # one resident-DB Localizer per mode; K is the
        # same for every scene
        for cond, (cam_kw, rend_kw) in CONDITIONS.items():
            rng = _cond_rng(seed, cond)
            rows = []
            for _ in range(n_scenes):
                cam = scene_camera(mosaic, plane, rng, cam_kw, frame_size)
                frame, H_true = S.render_frame(
                    gray, mosaic.geotransform, plane, cam, rng=rng,
                    device=dev, **rend_kw)
                if loc is None:
                    loc = Localizer(store, camera_model(cam, dev), cfg,
                                    device=dev)
                res = loc.localize(frame, solve_pose=True)
                ok = bool(res.pose.ok.cpu()) and bool(res.homography.ok.cpu())
                att, pos = S.pose_errors(res.pose.rvec.cpu().numpy(),
                                         res.pose.tvec.cpu().numpy(), cam)
                fp = S.footprint_error_m(
                    res.homography.H.cpu().numpy().astype(np.float64),
                    H_true, cam)
                rows.append(dict(
                    mode=mode, cond=cond, ok=ok, att=att, pos=pos, fp=fp,
                    inl=int(res.homography.num_inliers.cpu()),
                    pnp_inl=int(res.pose.num_inliers.cpu())))
            agg = _summary(rows, [r["fp"] for r in rows if r["ok"]],
                           dict(inl_med=int(np.median([r["inl"]
                                                       for r in rows]))))
            results[mode][cond] = agg
            if scenes is not None:
                scenes.extend(rows)
            progress(f"[{mode}] {cond:10s} ok={agg['ok_rate']:.2f} "
                     f"att med/p90 = {agg['att_med']}/{agg['att_p90']} deg  "
                     f"pos med/p90 = {agg['pos_med']}/{agg['pos_p90']} m  "
                     f"fp med = {agg['fp_med']} m  inl={agg['inl_med']}")
    return results


def run_terrain(n_scenes: int = 6, modes=("exact",), seed: int = 2026,
                texture: str = "rects", reliefs=TERRAIN_RELIEFS,
                progress=_stderr, *, device=None,
                mosaic_size: int = MOSAIC, frame_size: int = FRAME,
                capacity: int = 2048, scenes=None):
    """Relief sweep: {"relief<m>": {mode: {condition: summary}}}, the PnP
    attitude/position error over non-planar terrain with the homography
    ground-footprint error beside it (summary keys: ok_rate, att_med,
    att_p90, pos_med, pos_p90, fp_med, pnp_inl_med). The homography model
    is wrong over relief (parallax): its footprint error should grow
    with relief while PnP holds. `scenes`, a list, receives every scene's
    row (relief, mode, condition, ok, att, pos, fp, pnp_inl)."""
    from cubesat_apds_tpu_torch.pipelines.localize import Localizer

    dev = torch.device("cuda" if device is None else device)
    for mode in modes:
        mode_config(mode, capacity)
    out: dict = {}
    for relief in reliefs:
        mosaic, dem, ds = build_terrain_world(seed, relief, texture,
                                              device=dev,
                                              mosaic_size=mosaic_size)
        gray = mosaic.bands[0] / 255.0
        out[f"relief{int(relief)}"] = {}
        for mode in modes:
            cfg = mode_config(mode, capacity)
            store = build_db(ds, cfg, progress,
                             f"[terrain {relief:.0f} m] [{mode}]")
            loc = None
            for cond, cam_kw in TERRAIN_CONDITIONS.items():
                rng = _cond_rng(seed, cond, int(relief))
                rows = []
                for _ in range(n_scenes):
                    cam = scene_camera(mosaic, dem, rng, cam_kw, frame_size)
                    frame = S.render_frame_terrain(
                        gray, mosaic.geotransform, dem, cam, rng=rng)
                    if loc is None:
                        loc = Localizer(store, camera_model(cam, dev), cfg,
                                        device=dev)
                    res = loc.localize(frame, solve_pose=True)
                    att, pos = S.pose_errors(res.pose.rvec.cpu().numpy(),
                                             res.pose.tvec.cpu().numpy(),
                                             cam)
                    fp = S.footprint_error_terrain_m(
                        res.homography.H.cpu().numpy().astype(np.float64),
                        cam, mosaic.geotransform, dem) \
                        if bool(res.homography.ok.cpu()) else None
                    rows.append(dict(relief=relief, mode=mode, cond=cond,
                                     ok=bool(res.pose.ok.cpu()), att=att,
                                     pos=pos, fp=fp,
                                     pnp_inl=int(res.pose.num_inliers.cpu())))
                agg = _summary(
                    rows, [r["fp"] for r in rows if r["fp"] is not None],
                    dict(pnp_inl_med=int(np.median([r["pnp_inl"]
                                                    for r in rows]))))
                out[f"relief{int(relief)}"].setdefault(mode, {})[cond] = agg
                if scenes is not None:
                    scenes.extend(rows)
                progress(f"[terrain {relief:.0f} m] [{mode}] {cond:10s} "
                         f"ok={agg['ok_rate']:.2f} att med/p90 = "
                         f"{agg['att_med']}/{agg['att_p90']} deg  pos "
                         f"med/p90 = {agg['pos_med']}/{agg['pos_p90']} m  "
                         f"homography fp med = {agg['fp_med']} m")
    return out
