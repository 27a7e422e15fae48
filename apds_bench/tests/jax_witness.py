"""A second witness for the reference: `apds_bench/reference/` against the
JAX package `cubesat_apds_tpu` on the same inputs, at toy size, on the
CPU. The reference is a frozen copy of the port's eager path; this holds
it against the package the port was ported from, which shares no code
with it, and against the shift each frame was made with.

It loads JAX, so it runs in a process of its own, started by
`test_apds_bench_witness.py`; nothing the benchmark runs imports it:

    JAX_PLATFORMS=cpu python3 -m apds_bench.tests.jax_witness [full] [pruned]

For each serving path it makes the toy cell's frames and DB from the
seed, runs the reference as the benchmark's check runs it
(`check.reference_rows`, batch by batch), runs the JAX package's
one-frame entry on each of those frames against the same DB, and prints
one JSON line of what it compared.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from apds_bench import check, inputs  # noqa: E402
from apds_bench.serve import common, pruned  # noqa: E402
from apds_bench.tests import toy  # noqa: E402

CELLS = {"full": "dunk-10k.backlog-b8", "pruned": "dunk-1m.pruned-b8"}
BATCHES = [0, 1]
CPU = torch.device("cpu")


def _jax_config(cfg: dict):
    from cubesat_apds_tpu.core import config as jc
    pc = inputs._pipeline_config(jc, cfg)
    # The reference detects by an exact top-k, as the port does.
    return dataclasses.replace(
        pc, akaze=dataclasses.replace(pc.akaze, detect_topk="exact"))


def _jax_db(raw, n: int | None = None):
    import jax.numpy as jnp
    from cubesat_apds_tpu.pipelines.localize import DeviceDb
    cut = slice(None) if n is None else slice(0, n)
    return DeviceDb(descriptors=jnp.asarray(raw.descriptors[cut].numpy()),
                    xy=jnp.asarray(raw.xy[cut].numpy()),
                    valid=jnp.asarray(raw.valid[cut].numpy()),
                    obj_points=jnp.asarray(raw.obj[cut].numpy()),
                    has_world=True, world_frame="local")


def _jax_row(res) -> dict:
    h, p = res.homography, res.pose
    return {"homography": np.asarray(h.H, np.float32),
            "homography_ok": bool(h.ok),
            "num_inliers": int(h.num_inliers),
            "num_matches": int(res.num_matches),
            "num_keypoints": int(res.num_keypoints),
            "rvec": np.asarray(p.rvec, np.float32),
            "tvec": np.asarray(p.tvec, np.float32),
            "pose_ok": bool(p.ok), "pose_num_inliers": int(p.num_inliers)}


def _keypoint_gaps(ref_kp, ref_desc, j_kp, j_desc) -> dict:
    """Keypoint sets (pairs on the same level within 1e-3 px) and the
    share of descriptor bits that differ between paired keypoints."""
    rv, jv = ref_kp.valid.numpy(), np.asarray(j_kp.valid)
    rxy, jxy = ref_kp.xy.numpy()[rv], np.asarray(j_kp.xy)[jv]
    rl, jl = ref_kp.class_id.numpy()[rv], np.asarray(j_kp.class_id)[jv]
    d = np.abs(jxy[:, None, :] - rxy[None, :, :]).max(-1)
    same = (d <= 1e-3) & (jl[:, None] == rl[None, :])
    paired = same.any(1)
    rd = ref_desc.numpy()[rv][same.argmax(1)[paired]]
    jd = np.asarray(j_desc)[jv][paired]
    bits = np.unpackbits(rd, axis=1) != np.unpackbits(jd, axis=1)
    return {"n_ref": int(rv.sum()), "n_jax": int(jv.sum()),
            "unpaired": float(1.0 - paired.mean()) if len(paired) else 1.0,
            "desc_bits": float(bits.mean()) if bits.size else 1.0}


def _centre(h, hw) -> np.ndarray:
    """The homography's image of the frame's centre, px (the corners,
    which check.py compares, extrapolate a refit's last digits)."""
    p = np.asarray(h, np.float64) @ np.array([hw[1] / 2.0, hw[0] / 2.0, 1.0])
    return p[:2] / p[2]


def _true_centres(cfg: dict, traffic: dict, frames: list, hw) -> list:
    """Where each frame's centre lies in the DB's frame: the scene is
    rolled by the frame's shift (frame_pool's first draw) in the frame,
    and by `db_roll` in the DB."""
    rng = np.random.default_rng((toy.SEED, 0))
    s = traffic["max_shift"]
    shifts = rng.integers(-s, s + 1, size=(traffic["pool"], 2))
    roll = np.asarray(cfg["db_roll"], np.float64)
    c = np.array([hw[1] / 2.0, hw[0] / 2.0])
    return [c + (roll - shifts[i])[::-1] for i in frames]


def _reference_windows(feats, rdb, cfg, rcfg, hw) -> list:
    """The reference's pruned step on a batch: (coarse_ok, overflow,
    n_window) a frame."""
    from apds_bench.reference.localize import _pruned_back_half
    pr = _pruned_back_half(feats, hw, rdb, common.reference_camera(cfg, CPU),
                           rcfg, True, pruned.MARGIN)
    return [(bool(o), bool(v), int(n)) for o, v, n in zip(
        pr.coarse_ok.reshape(-1), pr.overflow.reshape(-1),
        pr.n_window.reshape(-1))]


def witness(path: str) -> dict:
    import jax
    import jax.numpy as jnp
    from cubesat_apds_tpu.core.types import CameraModel as JCamera
    from cubesat_apds_tpu.ops.features.akaze import detect_and_compute
    from cubesat_apds_tpu.pipelines import localize as jloc

    from apds_bench.reference.akaze import detect_and_compute_batch
    from apds_bench.reference.types_ import select

    cell = toy.cell(CELLS[path])
    cfg, batch = cell.config, int(cell.traffic["batch"])
    pool = inputs.frame_pool(cfg, cell.traffic, toy.SEED)
    raw = inputs.make_db(cfg, toy.SEED, CPU)
    hw = tuple(pool.shape[1:])
    ref_rows = check.reference_rows(cell, pool, raw, BATCHES, batch, CPU)
    rcfg = inputs.reference_config(cfg)

    jcfg, jcam = _jax_config(cfg), JCamera.ideal(*inputs.camera_args(cfg))
    detect = jax.jit(lambda f: detect_and_compute(f, jcfg.akaze))
    out = {"path": path, "cell": cell.name}
    if path == "full":
        jdb, rdb = _jax_db(raw), None
    else:
        jdb = jloc.make_pruned_db(_jax_db(raw),
                                  _jax_db(raw, cfg["coarse_rows"]),
                                  cfg["window_capacity"])
        rdb = pruned.reference_db(raw, cfg, rcfg, CPU)
        out["prune_index_equal"] = {
            k: bool(np.array_equal(getattr(rdb, k).numpy(),
                                   np.asarray(getattr(jdb, k))))
            for k in ("rows", "order", "starts", "grid")}
        out["windows"] = []
    jax_rows, out["keypoints"] = [], []
    for b in BATCHES:
        x = inputs.as_float(torch.from_numpy(
            pool[b * batch:(b + 1) * batch]))
        ref_feats = detect_and_compute_batch(x, rcfg.akaze)
        if rdb is not None:
            ref_win = _reference_windows(ref_feats, rdb, cfg, rcfg, hw)
        for i in range(batch):
            f = jnp.asarray(x[i].numpy())
            if rdb is None:
                res = jloc.localize_frame_jit(f, jdb, jcam, jcfg, True)
            else:
                pr = jloc.localize_frame_pruned_jit(f, jdb, jcam, jcfg, True,
                                                    pruned.MARGIN)
                out["windows"].append([ref_win[i], (
                    bool(pr.coarse_ok), bool(pr.overflow),
                    int(pr.n_window))])
                res = pr.result
                if not bool(pr.coarse_ok) or bool(pr.overflow):
                    res = jloc.localize_frame_pruned_fallback_jit(
                        f, jdb, jcam, jcfg, True)
            jax_rows.append(_jax_row(res))
            jf = detect(f)
            out["keypoints"].append(_keypoint_gaps(
                select(ref_feats.keypoints, i), ref_feats.descriptors[i],
                jf.keypoints, jf.descriptors))
    frames = [i for b in BATCHES for i in range(b * batch, (b + 1) * batch)]
    truth = _true_centres(cfg, cell.traffic, frames, hw)
    out.update(
        frames=len(ref_rows),
        numbers=check.compare(jax_rows, ref_rows, hw),
        centre_px=max(float(np.linalg.norm(
            _centre(r["homography"], hw) - _centre(j["homography"], hw)))
            for r, j in zip(ref_rows, jax_rows)),
        truth_px={side: max(float(np.linalg.norm(_centre(r["homography"], hw)
                                                 - t))
                            for r, t in zip(rows, truth))
                  for side, rows in (("reference", ref_rows),
                                     ("jax", jax_rows))},
        ok=[[bool(r[k]) for k in ("homography_ok", "pose_ok")]
            for r in ref_rows + jax_rows])
    return out


def main() -> int:
    torch.set_num_threads(2)
    for path in sys.argv[1:] or list(CELLS):
        print(json.dumps(witness(path)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
