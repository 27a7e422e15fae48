"""The comparison that decides `correct`.

After the window, the reference (`reference/`, plain PyTorch) runs again
over a seeded sample of the stream's batches, with the batches as the
stream formed them, from the same raw frames and DB; the program's
yielded results for those frames are then judged field by field. Each
number below is the worst over the sampled frames, and each has its
limit in `limits/<cell>.json`:

- missing        frames of the sample with no result from the program
- keypoints      |Δ num_keypoints|                          (features)
- matches        |Δ num_matches|                            (match)
- inliers        |Δ num_inliers| and |Δ pose_num_inliers|   (geometry)
- homography_px  the widest gap between the two homographies' images of
                 the frame's four corners, px; FLIP where homography_ok
                 differs
- pose_deg       the angle between the two rotations (rvec), degrees;
                 FLIP where pose_ok differs
- pose_pos       the distance between the two camera centres −Rᵀt, in
                 the DB's world units (reference-frame px)

Frames that both sides fail are compared by their counts only.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from apds_bench import inputs, spec
from apds_bench.spec import HERE

NUMBERS = ("missing", "keypoints", "matches", "inliers", "homography_px",
           "pose_deg", "pose_pos")
FLIP = 1.0e6


def limits(cell: str) -> dict:
    with open(HERE / "limits" / f"{cell}.json") as f:
        return json.load(f)["limits"]


def program_row(r) -> dict:
    """A StreamResult as the dict the reference's rows use."""
    row = {"homography": np.asarray(r.homography, np.float32),
           "homography_ok": bool(r.homography_ok),
           "num_inliers": int(r.num_inliers),
           "num_matches": int(r.num_matches),
           "num_keypoints": int(r.num_keypoints)}
    if r.pose_ok is not None:
        row.update(rvec=np.asarray(r.rvec, np.float32),
                   tvec=np.asarray(r.tvec, np.float32),
                   pose_ok=bool(r.pose_ok),
                   pose_num_inliers=int(r.pose_num_inliers))
    return row


def _rotation(rvec) -> np.ndarray:
    r = np.asarray(rvec, np.float64)
    th = float(np.linalg.norm(r))
    if th < 1e-12:
        return np.eye(3)
    k = r / th
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(th) * kx + (1 - math.cos(th)) * kx @ kx


def _corners_gap(h_a, h_b, hw) -> float:
    h, w = hw
    pts = np.array([[0, 0, 1], [w, 0, 1], [0, h, 1], [w, h, 1]], np.float64)

    def image(H):
        p = pts @ np.asarray(H, np.float64).T
        return p[:, :2] / p[:, 2:3]

    gap = np.linalg.norm(image(h_a) - image(h_b), axis=1).max()
    return float(gap) if np.isfinite(gap) else FLIP


def _pose_gaps(a, b) -> tuple:
    ra, rb = _rotation(a["rvec"]), _rotation(b["rvec"])
    # ‖Ra − Rb‖_F = 2√2·sin(θ/2): exact to rounding at small angles, where
    # an arccos of the trace is not.
    chord = float(np.linalg.norm(ra - rb)) / (2.0 * math.sqrt(2.0))
    deg = math.degrees(2.0 * math.asin(min(1.0, chord)))
    ca = -ra.T @ np.asarray(a["tvec"], np.float64)
    cb = -rb.T @ np.asarray(b["tvec"], np.float64)
    pos = float(np.linalg.norm(ca - cb))
    if not (math.isfinite(deg) and math.isfinite(pos)):
        return FLIP, FLIP
    return deg, pos


def compare(program: list, reference: list, frame_hw) -> dict:
    """The numbers over paired rows (program row or None, reference
    row)."""
    out = dict.fromkeys(NUMBERS, 0.0)
    for p, r in zip(program, reference):
        if p is None:
            out["missing"] += 1
            continue
        out["keypoints"] = max(out["keypoints"],
                               abs(p["num_keypoints"] - r["num_keypoints"]))
        out["matches"] = max(out["matches"],
                             abs(p["num_matches"] - r["num_matches"]))
        gaps = [abs(p["num_inliers"] - r["num_inliers"])]
        if "pose_ok" in r:
            gaps.append(abs(p["pose_num_inliers"] - r["pose_num_inliers"]))
        out["inliers"] = max(out["inliers"], *gaps)
        if p["homography_ok"] != r["homography_ok"]:
            out["homography_px"] = FLIP
        elif r["homography_ok"]:
            out["homography_px"] = max(out["homography_px"], _corners_gap(
                p["homography"], r["homography"], frame_hw))
        if "pose_ok" not in r:
            continue
        if p["pose_ok"] != r["pose_ok"]:
            out["pose_deg"] = out["pose_pos"] = FLIP
        elif r["pose_ok"]:
            deg, pos = _pose_gaps(p, r)
            out["pose_deg"] = max(out["pose_deg"], deg)
            out["pose_pos"] = max(out["pose_pos"], pos)
    return {k: float(v) for k, v in out.items()}


def judge(numbers: dict, lims: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): correct iff every number is
    at or under its limit."""
    table = {k: {"value": numbers[k], "limit": float(lims[k])}
             for k in NUMBERS}
    return all(v["value"] <= v["limit"] for v in table.values()), table


def sample_batches(n_batches: int, k: int, seed: int) -> list:
    """k distinct batch indices of n_batches, drawn from the seed, the
    last batch among them (the window's end), in order."""
    if n_batches <= 0:
        return []
    k = min(k, n_batches)
    rng = np.random.default_rng((seed, 2))
    rest = rng.choice(n_batches - 1, size=k - 1, replace=False) \
        if k > 1 else []
    return sorted({n_batches - 1, *map(int, rest)})


def reference_rows(cell, pool, raw, batches: list, batch: int, device,
                   precision: str = "float32") -> list:
    """The reference's rows of the given batches of the window (frames
    [b·batch, (b+1)·batch) of the pool's cycle), made from the raw frames
    and the raw DB as the stream batched them."""
    from apds_bench.reference.akaze import detect_and_compute_batch
    from apds_bench.serve.common import reference_camera

    cfg = cell.config
    serve = spec.serve_module(cell.traffic["serve"])
    rcfg = inputs.reference_config(cfg)
    rdb = serve.reference_db(raw, cfg, rcfg, device)
    camera = reference_camera(cfg, device)
    rows = []
    for b in batches:
        frames = np.stack([pool[i % len(pool)]
                           for i in range(b * batch, (b + 1) * batch)])
        x = inputs.as_float(torch.from_numpy(frames).to(device))
        feats = detect_and_compute_batch(x, rcfg.akaze, precision=precision)
        rows += serve.reference_rows(feats, rdb, camera, rcfg,
                                     tuple(x.shape[1:]), cfg["solve_pose"])
    return rows
