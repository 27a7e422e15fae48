"""Every input of a run, made from `--seed` and the cell's files: the
configurations of both sides, the frame pool and the DB.

The deployment's scene (the terrain the DB was built from) is the
configuration's `scene_seed`; the run's seed draws the traffic (each
frame's shift and sensor noise) and the DB's perturbations (the tiled
copies' bit flips, or the filler rows). The DB's real rows are the
reference extractor's features, never the program's: both sides get the
same raw tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def make_frame(rng, n: int = 512):
    """bench.py's `_make_frame`: a corner-rich synthetic n×n frame,
    float32 in [0, 1]."""
    img = np.zeros((n, n), np.float32)
    for _ in range(120):
        cy, cx = rng.integers(10, n - 50, 2)
        s = int(rng.integers(8, 40))
        img[cy:cy + s, cx:cx + s] = rng.uniform(0.2, 1.0)
    return img


def base_frame_u8(config: dict) -> np.ndarray:
    """The deployment's scene as the camera gives it: uint8 [n, n]."""
    f = make_frame(np.random.default_rng(config["scene_seed"]),
                   config["frame_size"])
    return np.rint(f * 255.0).astype(np.uint8)


def frame_pool(config: dict, traffic: dict, seed: int) -> np.ndarray:
    """uint8 [pool, n, n]: the scene rolled by a seeded shift in
    [-max_shift, max_shift]² px, plus seeded sensor noise of at most
    ±noise grey levels."""
    rng = np.random.default_rng((seed, 0))
    base = base_frame_u8(config)
    k, s, a = traffic["pool"], traffic["max_shift"], traffic["noise"]
    shifts = rng.integers(-s, s + 1, size=(k, 2))
    pool = np.empty((k,) + base.shape, np.uint8)
    for i in range(k):
        noise = rng.integers(-a, a + 1, size=base.shape, dtype=np.int16)
        rolled = np.roll(base, tuple(shifts[i]), axis=(0, 1)).astype(np.int16)
        pool[i] = np.clip(rolled + noise, 0, 255).astype(np.uint8)
    return pool


def as_float(frames: torch.Tensor) -> torch.Tensor:
    """uint8 frames → float32 in [0, 1], as the stream converts them."""
    return frames.to(torch.float32) / 255.0


@dataclasses.dataclass
class RawDb:
    """The DB as the benchmark made it (a deployment's rows): descriptors
    [M, 61] uint8, xy [M, 2] float32, valid [M] bool, obj [M, 3] float32."""

    descriptors: torch.Tensor
    xy: torch.Tensor
    valid: torch.Tensor
    obj: torch.Tensor

    def clone(self) -> "RawDb":
        return RawDb(*(t.clone() for t in dataclasses.astuple(self)))


def make_db(config: dict, seed: int, device) -> RawDb:
    """The DB on `device`: the reference extractor's features of the scene
    rolled by `db_roll`, then either tiled to `db_rows` with seeded bit
    flips past the first copy (bench.py's layout, `db: tiled`) or followed
    by seeded uniform filler rows made on the device (`db: filler`)."""
    from apds_bench.reference.akaze import detect_and_compute

    device = torch.device(device)
    base = base_frame_u8(config)
    rolled = np.roll(base, tuple(config["db_roll"]), axis=(0, 1))
    img = as_float(torch.from_numpy(rolled).to(device))
    feats = detect_and_compute(img, reference_config(config).akaze)
    desc = feats.descriptors
    xy = feats.keypoints.xy
    valid = feats.keypoints.valid
    m, n = config["db_rows"], desc.shape[0]
    if config["db"] == "tiled":
        reps = m // n + 1
        desc = desc.cpu().numpy()
        desc_db = np.tile(desc, (reps, 1))[:m]
        rng = np.random.default_rng((seed, 1))
        flip = rng.integers(0, 256, desc_db.shape, dtype=np.uint8)
        flip[:n] = 0
        desc_db = desc_db ^ (flip & rng.integers(0, 2, desc_db.shape,
                                                 dtype=np.uint8) * 255)
        desc = torch.from_numpy(desc_db).to(device)
        xy = xy.repeat(reps, 1)[:m].contiguous()
        valid = valid.repeat(reps)[:m].contiguous()
    elif config["db"] == "filler":
        gen = torch.Generator(device=device).manual_seed(int(seed))
        d = torch.randint(0, 256, (m, 61), generator=gen, device=device,
                          dtype=torch.uint8)
        pts = torch.rand((m, 2), generator=gen, device=device) \
            * float(config["filler_extent"])
        ok = torch.ones(m, dtype=torch.bool, device=device)
        d[:n] = desc
        pts[:n] = xy
        ok[:n] = valid
        desc, xy, valid = d, pts, ok
    else:
        raise ValueError(f"unknown DB layout {config['db']!r}")
    obj = torch.cat([xy, torch.zeros_like(xy[:, :1])], dim=1)
    return RawDb(descriptors=desc.contiguous(), xy=xy.contiguous(),
                 valid=valid.contiguous(), obj=obj.contiguous())


def _pipeline_config(mod, config: dict):
    a, m = config["akaze"], config["match"]
    return mod.PipelineConfig(
        akaze=mod.AkazeConfig(capacity=a["capacity"],
                              descriptor_mode=a["descriptor_mode"],
                              orientation_mode=a["orientation_mode"]),
        match=mod.MatchConfig(ratio=m["ratio"], db_block=m["db_block"]),
        ransac=mod.RansacConfig(
            num_hypotheses=config["ransac"]["num_hypotheses"]),
        pnp=mod.PnPConfig(num_hypotheses=config["pnp"]["num_hypotheses"]))


def program_config(config: dict):
    """The program's PipelineConfig for the configuration file."""
    from cubesat_apds_tpu_torch.core import config as mod
    return _pipeline_config(mod, config)


def reference_config(config: dict):
    """The reference's PipelineConfig for the configuration file."""
    from apds_bench.reference import config as mod
    return _pipeline_config(mod, config)


def camera_args(config: dict) -> tuple:
    c = config["camera"]
    return (c["fx"], c["fy"], c["cx"], c["cy"])
