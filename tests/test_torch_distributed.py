"""The port's mesh across processes (parallel.mesh.initialize_distributed,
gloo): two real processes, each bringing two `cpu` slots, form a global
mesh of four slots. The library path and the command line's
`stream --distributed` and `preprocess --distributed` are held to the
single-process results. The sharded kNN-2 (dense and the kernel's twin, the
DB's columns split over both processes) and the serve step (dp=2 × tp=2:
each process a row; dp=1 × tp=4: the row's merge across both) must give
every process exactly the single-process results. Each worker has a free
port, two threads and a 120 s limit, so a hang fails the test instead of
eating the suite's clock.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.multiprocess

# The same thread count as the workers': the CPU's float reductions may
# split by thread.
torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ENV = ("APDS_COORDINATOR", "APDS_NUM_PROCESSES", "APDS_PROCESS_ID")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _scene(seed: int = 11):
    """tests/test_distributed.py's scene (a 128² base, four frames rolled
    by 0–3 px, 64 queries against 512 rows of which 32 are copies) and a
    1000-row DB of the port's own features of the base plus filler."""
    from cubesat_apds_tpu_torch.core.config import AkazeConfig
    from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute

    rng = np.random.default_rng(seed)
    base = np.zeros((128, 128), np.float32)
    for _ in range(25):
        cy, cx = rng.integers(5, 100, 2)
        s = int(rng.integers(8, 20))
        base[cy:cy + s, cx:cx + s] = rng.uniform(0.3, 1.0)
    frames = np.stack([np.roll(base, i, axis=1) for i in range(4)])
    q = rng.integers(0, 256, (64, 61), dtype=np.uint8)
    dbm = np.concatenate([q[:32], rng.integers(0, 256, (480, 61),
                                               dtype=np.uint8)])
    feats = detect_and_compute(torch.from_numpy(base),
                               AkazeConfig(capacity=256))
    m = 1000
    desc = rng.integers(0, 256, (m, 61), dtype=np.uint8)
    xy = rng.uniform(0, 128, (m, 2)).astype(np.float32)
    valid = np.ones(m, bool)
    desc[:256] = feats.descriptors.numpy()
    xy[:256] = feats.keypoints.xy.numpy()
    valid[:256] = feats.keypoints.valid.numpy()
    return frames, q, dbm, (desc, xy, valid)


def _outputs(slots):
    """Every result the test compares, on a mesh over `slots` (this
    process's, in a distributed run): a dict of numpy arrays."""
    from cubesat_apds_tpu_torch.core.config import (
        AkazeConfig, MatchConfig, PipelineConfig, RansacConfig)
    from cubesat_apds_tpu_torch.core.types import CameraModel
    from cubesat_apds_tpu_torch.ops import match as M
    from cubesat_apds_tpu_torch.parallel.mesh import make_mesh
    from cubesat_apds_tpu_torch.parallel.serve import (
        make_batch_localizer, shard_device_db)
    from cubesat_apds_tpu_torch.parallel.sharded_match import (
        make_sharded_knn2, make_sharded_knn2_fused)
    from cubesat_apds_tpu_torch.pipelines.localize import DeviceDb

    frames, q, dbm, (desc, xy, valid) = _scene()
    cfg = PipelineConfig(akaze=AkazeConfig(capacity=256),
                         match=MatchConfig(ratio=0.75),
                         ransac=RansacConfig(num_hypotheses=64))
    cam = CameraModel.ideal(100.0, 100.0, 64.0, 64.0)
    out = {}
    mesh = make_mesh(dp=1, tp=4, devices=slots)
    qb = M.unpack_bits(torch.from_numpy(q))
    for name, fn, db in (
            ("dense", make_sharded_knn2(mesh),
             M.unpack_bits(torch.from_numpy(dbm))),
            ("fused", make_sharded_knn2_fused(mesh, db_block=64),
             torch.from_numpy(dbm))):
        for k, t in zip(("d0", "d1", "i0"), fn(qb, db)):
            out[f"{name}_{k}"] = t.cpu().numpy()
    db = DeviceDb(descriptors=torch.from_numpy(desc),
                  xy=torch.from_numpy(xy), valid=torch.from_numpy(valid),
                  obj_points=torch.zeros((len(desc), 3)), has_world=False)
    for dp, tp in ((2, 2), (1, 4)):
        mesh = make_mesh(dp=dp, tp=tp, devices=slots)
        step = make_batch_localizer(mesh, cam, cfg, solve_pose=False)
        homog, _, n_match, n_kp = step(torch.from_numpy(frames),
                                       shard_device_db(mesh, db))
        for k, t in (("H", homog.H), ("ok", homog.ok),
                     ("inliers", homog.inliers), ("n_match", n_match),
                     ("n_kp", n_kp)):
            out[f"serve{dp}x{tp}_{k}"] = t.cpu().numpy()
    return out


_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["APDS_REPO"])
sys.path.insert(0, os.path.join(os.environ["APDS_REPO"], "tests"))
import numpy as np
import torch
torch.set_num_threads(2)
from cubesat_apds_tpu_torch.parallel.mesh import initialize_distributed
assert initialize_distributed(), "no distributed config"
import torch.distributed as dist
assert dist.get_world_size() == 2
from test_torch_distributed import _outputs
out = _outputs(["cpu", "cpu"])
np.savez(os.environ["APDS_OUT"] + f"{dist.get_rank()}.npz", **out)
dist.destroy_process_group()
print("WORKER_DONE", flush=True)
"""


def test_two_process_mesh_equivalence(tmp_path):
    port = _free_port()
    out = str(tmp_path / "proc")
    script = str(tmp_path / "worker.py")
    with open(script, "w") as f:
        f.write(_WORKER)
    procs = []
    for pid in range(2):
        env = dict(os.environ, APDS_REPO=_REPO, APDS_OUT=out,
                   APDS_COORDINATOR=f"127.0.0.1:{port}",
                   APDS_NUM_PROCESSES="2", APDS_PROCESS_ID=str(pid),
                   OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, script], env=env, cwd=str(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    results = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=120)
            results.append((p.returncode, so.decode(), se.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, so, se in results:
        assert rc == 0, f"worker failed:\n{se[-4000:]}"
        assert "WORKER_DONE" in so

    ref = _outputs(["cpu"] * 4)
    for pid in range(2):
        got = np.load(f"{out}{pid}.npz")
        assert set(got.files) == set(ref)
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"{pid} {k}")
    assert ref["serve2x2_ok"].any()
    # The sharded kNN-2 is one kNN-2 over the whole DB.
    from cubesat_apds_tpu_torch.ops import match as M

    _, q, dbm, _ = _scene()
    one = M.knn2(M.unpack_bits(torch.from_numpy(q)),
                 M.unpack_bits(torch.from_numpy(dbm)))
    for k, t in zip(("d0", "d1", "i0"), one):
        np.testing.assert_array_equal(ref[f"dense_{k}"], t.numpy())


def test_initialize_distributed_noop_without_config(monkeypatch):
    """No coordinator configured → False, and no process group."""
    import torch.distributed as dist

    from cubesat_apds_tpu_torch.parallel.mesh import initialize_distributed

    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed() is False
    assert not dist.is_initialized()


def test_initialize_distributed_partial_config_rejected(monkeypatch):
    """A partial APDS_* configuration raises the descriptive error that
    names what is missing."""
    from cubesat_apds_tpu_torch.parallel.mesh import initialize_distributed

    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("APDS_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="APDS_COORDINATOR"):
        initialize_distributed()
    with pytest.raises(ValueError, match="APDS_PROCESS_ID"):
        initialize_distributed(coordinator="127.0.0.1:1")


# ---- the command line across two processes --------------------------------
#
# The counterparts of tests/test_distributed.py's CLI tests: the real
# `stream --distributed` and `preprocess --distributed` mains as two OS
# processes of two `cpu` slots each, held to a single-process run.

_CLI_TIMEOUT_S = 120


def _cli_scene(tmp_path):
    """tests/test_distributed.py's _cli_scene through the port: a 128²
    GeoTIFF, a store built by the port's preprocess CLI, 8 rolled frame
    PNGs."""
    from PIL import Image

    from cubesat_apds_tpu_torch.cli import main
    from cubesat_apds_tpu_torch.io.tiff import write_geotiff

    rng = np.random.default_rng(21)
    img = np.zeros((128, 128), np.float32)
    for _ in range(25):
        cy, cx = rng.integers(5, 100, 2)
        s = int(rng.integers(8, 20))
        img[cy:cy + s, cx:cx + s] = rng.uniform(0.3, 1.0)
    tiles = tmp_path / "tiles"
    tiles.mkdir()
    rgb8 = (np.stack([img] * 3, -1) * 255).astype(np.uint8)
    write_geotiff(str(tiles / "t.tif"), rgb8,
                  [10.0, 0.001, 0, 56.0, 0, -0.001])
    store = str(tmp_path / "store")
    assert main(["--device", "cpu", "preprocess", "--dataset", str(tiles),
                 "--store", store, "--lod", "1"]) == 0
    frames = tmp_path / "frames"
    frames.mkdir()
    names = []
    for i in range(8):
        p = str(frames / f"f{i}.png")
        Image.fromarray((np.roll(img, i, axis=1) * 255)
                        .astype(np.uint8)).save(p)
        names.append(p)
    return tiles, store, frames, names


def _run_cli_pair(argv_of):
    """`python -m cubesat_apds_tpu_torch.cli <argv_of(pid)>` as processes 0
    and 1 of a two-process group (a free port, two threads each); a worker
    past its time limit is killed and fails the test. Returns their
    stdouts."""
    port = _free_port()
    procs = []
    for pid in range(2):
        env = {k: v for k, v in os.environ.items() if k not in _ENV}
        env.update(APDS_COORDINATOR=f"127.0.0.1:{port}",
                   APDS_NUM_PROCESSES="2", APDS_PROCESS_ID=str(pid),
                   OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cubesat_apds_tpu_torch.cli",
             *argv_of(pid)], env=env, cwd=_REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    outs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=_CLI_TIMEOUT_S)
            outs.append((p.returncode, so.decode(), se.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, _so, se in outs:
        assert rc == 0, f"worker failed:\n{se[-4000:]}"
    return [so for _rc, so, _se in outs]


def _frame_records(text):
    """The per-frame JSON lines of a stream run, without their latency
    (a wall-clock reading)."""
    import json

    recs = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
    return [{k: v for k, v in r.items() if k != "latency_s"}
            for r in recs if "frame" in r]


def test_two_process_stream_cli(tmp_path, capsys):
    """`stream --device cpu,cpu --mesh 2x2 --distributed` as two processes
    (one global mesh of four slots): both print the per-frame JSON lines
    of a single-process `--device cpu,cpu,cpu,cpu --mesh 2x2` run."""
    from cubesat_apds_tpu_torch.cli import main

    _tiles, store, frames, names = _cli_scene(tmp_path)
    args = ["stream", "--store", store, "--frames", str(frames),
            "--batch", "4", "--mesh", "2x2"]
    capsys.readouterr()
    assert main(["--device", "cpu,cpu,cpu,cpu", *args]) == 0
    ref = _frame_records(capsys.readouterr().out)
    assert [r["frame"] for r in ref] == names
    assert any(r["homography_ok"] for r in ref)
    outs = _run_cli_pair(lambda pid: ["--device", "cpu,cpu", *args,
                                      "--distributed"])
    for pid, out in enumerate(outs):
        assert _frame_records(out) == ref, f"process {pid}"


def test_two_process_preprocess_cli(tmp_path):
    """`preprocess --device cpu,cpu -c 4 --distributed` as two processes:
    each writes the whole store, row-equal to the single-process -c 1
    build."""
    tiles, ref_store, _frames, _names = _cli_scene(tmp_path)
    stores = [str(tmp_path / f"dstore{pid}") for pid in range(2)]
    _run_cli_pair(lambda pid: [
        "--device", "cpu,cpu", "preprocess", "--dataset", str(tiles),
        "--store", stores[pid], "--lod", "1", "-c", "4", "--distributed"])
    ref = np.load(os.path.join(ref_store, "keypoints.npz"))
    for spath in stores:
        got = np.load(os.path.join(spath, "keypoints.npz"))
        assert set(got.files) == set(ref.files)
        for k in ref.files:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
