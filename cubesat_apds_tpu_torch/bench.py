"""Headline benchmark of the port: end-to-end frames/s of the main-path
step (detect → match → pose) on one card — the counterpart of the
repository's bench.py, and the step that `apds-torch bench` runs.

The scene is bench.py's, from seed 42 with numpy: a 512² corner-rich
frame; a 10,240-row DB of the port's features of the frame rolled by
(7, 13), tiled and perturbed past the first copy; capacity 2048 exact,
ratio 0.75, 256 homography and 64 PnP hypotheses;
CameraModel.ideal(500, 500, 256, 256). `scene` builds it (chip_smoke.py's
slice phase makes its scene with it).

The timing: 3 warm-up steps, then `reps` reps of `iters` steps through
localize_frame_jit(..., solve_pose=True). Each step's frame carries its
own additive salt, (base + i)·1e-7 as in bench.py, so every step does
bench.py's work on fresh inputs. torch.cuda.synchronize() closes each rep: it is the fence on the
card.

    python -m cubesat_apds_tpu_torch.bench

prints ONE JSON line {"metric", "value", "unit", "spread", "reps",
"device"}, `device` being the card's name and power limit as nvidia-smi
reports them. Progress goes to stderr.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from cubesat_apds_tpu_torch.core.config import (
    AkazeConfig, MatchConfig, PipelineConfig, PnPConfig, RansacConfig)
from cubesat_apds_tpu_torch.core.types import CameraModel, to_device
from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute
from cubesat_apds_tpu_torch.pipelines.localize import (
    DeviceDb, localize_frame_jit, resident_db)

SEED = 42
METRIC = "e2e_localize_512px_10kdb_fps"
DB_ROWS = 10240


def _note(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def make_frame(rng):
    """bench.py:_make_frame — corner-rich synthetic 512² satellite frame."""
    n = 512
    img = np.zeros((n, n), np.float32)
    for _ in range(120):
        cy, cx = rng.integers(10, n - 50, 2)
        s = int(rng.integers(8, 40))
        img[cy:cy + s, cx:cx + s] = rng.uniform(0.2, 1.0)
    return img


def bench_config() -> PipelineConfig:
    """bench.py's PipelineConfig."""
    return PipelineConfig(akaze=AkazeConfig(capacity=2048),
                          match=MatchConfig(ratio=0.75),
                          ransac=RansacConfig(num_hypotheses=256),
                          pnp=PnPConfig(num_hypotheses=64))


def scene(device):
    """bench.py's scene: (frame [512, 512] float32 numpy, DeviceDb of CPU
    tensors, CameraModel, PipelineConfig). The DB's features are
    extracted on `device`; callers place the DB where they serve it."""
    rng = np.random.default_rng(SEED)
    config = bench_config()
    frame = make_frame(rng)
    rolled = torch.from_numpy(np.roll(frame, (7, 13), axis=(0, 1)))
    feats = detect_and_compute(rolled.to(device), AkazeConfig(capacity=2048))
    desc = feats.descriptors.cpu().numpy()
    xy = feats.keypoints.xy.cpu().numpy()
    valid = feats.keypoints.valid.cpu().numpy()
    reps = DB_ROWS // len(desc) + 1
    desc_db = np.tile(desc, (reps, 1))[:DB_ROWS]
    xy_db = np.tile(xy, (reps, 1))[:DB_ROWS]
    valid_db = np.tile(valid, reps)[:DB_ROWS]
    # Perturb the tiled copies so the top-2 is not degenerate.
    flip = rng.integers(0, 256, desc_db.shape, dtype=np.uint8)
    flip[:len(desc)] = 0
    desc_db = desc_db ^ (flip & rng.integers(0, 2, desc_db.shape,
                                             dtype=np.uint8) * 255)
    obj = np.concatenate([xy_db, np.zeros((DB_ROWS, 1), np.float32)], axis=1)
    db = DeviceDb(descriptors=torch.from_numpy(desc_db),
                  xy=torch.from_numpy(xy_db.astype(np.float32)),
                  valid=torch.from_numpy(valid_db),
                  obj_points=torch.from_numpy(obj.astype(np.float32)),
                  has_world=True)
    return frame, db, CameraModel.ideal(500.0, 500.0, 256.0, 256.0), config


def device_name(device) -> str:
    """The card's name and power limit as nvidia-smi gives them ("cpu" for
    the CPU; the name alone where nvidia-smi cannot be read)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return f"{torch.cuda.get_device_name(device)}, power limit not read"


def result_line(fps_reps, device: str) -> dict:
    """The JSON line: the median of the reps' frames/s, their spread."""
    return {"metric": METRIC,
            "value": round(float(np.median(fps_reps)), 2),
            "unit": "frames/sec/chip",
            "spread": round(float(np.max(fps_reps) - np.min(fps_reps)), 2),
            "reps": [round(float(f), 2) for f in fps_reps],
            "device": device}


def run(iters: int = 80, reps: int = 5, device=None) -> dict:
    """Build the scene on `device` (the card unless the caller names
    another), warm up with 3 steps, then time `reps` reps of `iters`
    steps. Returns the JSON line as a dict."""
    dev = torch.device("cuda" if device is None else device)
    frame, db, camera, config = scene(dev)
    db = resident_db(db, config, dev)
    camera = to_device(camera, dev)
    frame_t = torch.from_numpy(frame).to(dev)
    entropy = np.float32(time.time() % 1000.0)

    def steps(n, base):
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(n):
            salt = float(np.float32(base + i) * np.float32(1e-7))
            r = localize_frame_jit(frame_t + salt, db, camera, config,
                                   solve_pose=True)
            acc += (r.homography.num_inliers + r.num_matches
                    + r.pose.num_inliers).to(torch.float32)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return acc

    _note(f"scene built on {dev}; warm-up (3 steps)")
    steps(3, entropy + 10_000.0)
    fps = []
    for rep in range(reps):
        t0 = time.perf_counter()
        steps(iters, entropy + rep * iters)
        fps.append(iters / (time.perf_counter() - t0))
        _note(f"rep {rep}: {fps[-1]:.2f} frames/s")
    return result_line(fps, device_name(dev))


def main(device=None) -> int:
    """bench.py's counts: 5 reps of 80 steps; prints the JSON line."""
    print(json.dumps(run(device=device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
