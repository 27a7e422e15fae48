"""The port's command line (cubesat_apds_tpu_torch/cli.py) on the CPU.

Each test of tests/test_cli.py has its counterpart here, on the same
128² scene, run through the port's `main` with `--device cpu` (a list of
`cpu` slots for the mesh and `-c` cases): the same refusals and output
keys. Stores that a test only reads are built once per module by the
port's own `preprocess` command. The same argv also goes through the JAX
package's `main` — four runs, in module-scoped fixtures — and the outputs
are held to the parity tolerances of tests/test_torch_build.py,
tests/test_torch_localize.py and tests/test_torch_calibration.py. Then:
the refusal without a card, the package surface, and `bench`.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from cubesat_apds_tpu_torch.cli import _akaze_from_tag, main
from cubesat_apds_tpu_torch.io.tiff import write_geotiff

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]
GT = [10.0, 0.001, 0, 56.0, 0, -0.001]


def _img():
    """tests/test_cli.py's scene: 25 squares on 128², from seed 1234."""
    rng = np.random.default_rng(1234)
    img = np.zeros((128, 128), np.float32)
    for _ in range(25):
        cy, cx = rng.integers(5, 100, 2)
        s = int(rng.integers(8, 20))
        img[cy:cy + s, cx:cx + s] = rng.uniform(0.3, 1.0)
    return img


def _save(path, img):
    Image.fromarray((img * 255).astype(np.uint8)).save(str(path))
    return str(path)


def _tiles(d, img):
    d.mkdir()
    rgb8 = (np.stack([img] * 3, -1) * 255).astype(np.uint8)
    write_geotiff(str(d / "t.tif"), rgb8, GT)
    return d


def _json(capsys, opener="{"):
    captured = capsys.readouterr().out
    return json.loads(captured[captured.index(opener):])


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.strip()
            .splitlines() if ln.startswith("{")]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The scene's tiles, its frame, and the port's stores built by the
    CLI: npz at 1 LoD, binary at 1 LoD, npz at 2 LoDs (tile batch 4)."""
    root = tmp_path_factory.mktemp("cli")
    img = _img()
    tiles = _tiles(root / "tiles", img)
    stores = {}
    for name, extra in (("npz1", ["--lod", "1"]),
                        ("bin1", ["--lod", "1", "--binary"]),
                        ("npz2", ["--lod", "2", "--tile-batch", "4"])):
        stores[name] = str(root / name)
        assert main(CPU + ["preprocess", "--dataset", str(tiles),
                           "--store", stores[name]] + extra) == 0
    return {"root": root, "img": img, "tiles": tiles, "stores": stores,
            "frame": _save(root / "frame.png", img)}


def _frames_dir(d, img, n):
    d.mkdir()
    return [_save(d / f"f{i}.png", np.roll(img, i * 2, axis=1))
            for i in range(n)]


# --- the counterparts of tests/test_cli.py ---------------------------------

def test_cli_preprocess_and_localize(world, capsys):
    assert os.path.exists(os.path.join(world["stores"]["npz1"],
                                       "manifest.json"))
    capsys.readouterr()
    assert main(["localize", "--store", world["stores"]["npz1"],
                 "--frame", world["frame"]] + CPU) == 0
    assert _json(capsys)["keypoints"] > 0


def test_cli_preprocess_binary_and_localize(world, capsys):
    assert os.path.exists(os.path.join(world["stores"]["bin1"], "order.npy"))
    capsys.readouterr()
    assert main(["localize", "--store", world["stores"]["bin1"],
                 "--frame", world["frame"]] + CPU) == 0
    out = _json(capsys)
    assert out["matches"] >= 0 and "homography" in out


def test_cli_calculate_lod(world, capsys):
    """Host only: runs without --device, card or not."""
    assert main(["preprocess", "--dataset", str(world["tiles"]),
                 "--store", str(world["root"] / "s"), "--calculate-lod"]) == 0
    assert "LoD levels" in capsys.readouterr().out


def _board():
    nx, ny, cell = 7, 6, 24
    img = np.full((240, 320), 0.9, np.float32)
    for r in range(ny + 1):
        for c in range(nx + 1):
            shade = 0.1 if (r + c) % 2 == 0 else 0.9
            img[6 + r * cell:6 + (r + 1) * cell,
                16 + c * cell:16 + (c + 1) * cell] = shade
    return img


def test_cli_calibrate(tmp_path, capsys):
    d = tmp_path / "boards"
    d.mkdir()
    for i in range(10):
        _save(d / f"b{i}.png", _board())
    out_json = str(tmp_path / "cam.json")
    assert main(CPU + ["calibrate", str(d), "7x6", "-o", out_json]) == 0
    cap = capsys.readouterr().out
    assert "Camera matrix" in cap and "RMS" in cap
    with open(out_json) as f:
        cam = json.load(f)
    assert len(cam["K"]) == 3


def test_cli_localize_multi_frame(world, tmp_path, capsys):
    """Several --frame args share one resident DB (Localizer); the output
    is a JSON list with one record per frame."""
    f1 = world["frame"]
    f2 = _save(tmp_path / "f2.png", np.roll(world["img"], 3, axis=1))
    capsys.readouterr()
    assert main(["localize", "--store", world["stores"]["npz1"],
                 "--frame", f1, f2] + CPU) == 0
    out = _json(capsys, "[")
    assert isinstance(out, list) and len(out) == 2
    assert out[0]["frame"] == f1 and out[1]["frame"] == f2
    assert out[0]["keypoints"] > 0


def test_cli_preprocess_append_segment(world, tmp_path, capsys):
    """--binary --append lands a second tile folder as a new segment of an
    existing store; localize sees the union; the refusals come before
    any extraction."""
    from cubesat_apds_tpu_torch.store.binary_store import BinaryFeatureStore

    store_dir = str(tmp_path / "storeap")
    shutil.copytree(world["stores"]["bin1"], store_dir)
    d2 = _tiles(tmp_path / "tiles2", np.roll(world["img"], 31, axis=1))
    capsys.readouterr()
    assert main(CPU + ["preprocess", "--dataset", str(d2), "--store",
                       store_dir, "--lod", "1", "--binary", "--append"]) == 0
    assert "appended to" in capsys.readouterr().out

    b = BinaryFeatureStore(store_dir)
    assert len(b.manifest["segments"]) == 2
    assert len(b.images) == 2
    c, _ = b.read_keypoints_from_lod(0)
    assert set(np.unique(c["image_id"])) == {1, 2}
    assert (np.diff(c["response"]) <= 0).all()

    with pytest.raises(SystemExit):
        main(CPU + ["preprocess", "--dataset", str(d2), "--store", store_dir,
                    "--lod", "1", "--append"])
    with pytest.raises(SystemExit):
        main(CPU + ["preprocess", "--dataset", str(d2),
                    "--store", str(tmp_path / "nope"), "--lod", "1",
                    "--binary", "--append"])
    with pytest.raises(SystemExit, match="descriptor_mode"):
        main(CPU + ["preprocess", "--dataset", str(d2), "--store", store_dir,
                    "--lod", "1", "--binary", "--append",
                    "--descriptor-mode", "fast"])


def test_cli_missing_store_usage_error(tmp_path):
    """localize/stream/store against a nonexistent store exit with a usage
    message, not a FileNotFoundError traceback."""
    nope = str(tmp_path / "nope")
    dummy = str(tmp_path / "x.png")     # must exist: stream checks frame
    open(dummy, "w").close()            # paths before the store
    for argv in (["localize", "--store", nope, "--frame", dummy],
                 ["stream", "--store", nope, "--frames", dummy],
                 ["store", "info", nope]):
        with pytest.raises(SystemExit, match="no feature store"):
            main(CPU + argv)


def test_cli_descriptor_tag_grammar():
    for bad in ("hybridx", "fastt", "hybrid1", "hybrid0"):
        with pytest.raises(SystemExit):
            _akaze_from_tag(bad)
    assert _akaze_from_tag("hybrid3").hybrid_subcells == 3


def test_cli_stream(world, tmp_path, capsys):
    """`stream` runs the micro-batched StreamingLocalizer over a frame
    directory: one JSON line per frame, then a summary."""
    frames_dir = tmp_path / "frames"
    names = _frames_dir(frames_dir, world["img"], 3)
    capsys.readouterr()
    assert main(CPU + ["stream", "--store", world["stores"]["npz1"],
                       "--frames", str(frames_dir), "--batch", "2"]) == 0
    lines = _lines(capsys)
    recs = [ln for ln in lines if "frame" in ln]
    assert [r["frame"] for r in recs] == names     # sorted order preserved
    assert all(r["keypoints"] > 0 for r in recs)
    summary = lines[-1]["summary"]
    assert summary["frames"] == 3 and summary["batch"] == 2
    assert summary["sustained_fps"] > 0

    # Mismatched frame shapes refuse cleanly.
    _save(frames_dir / "zz_bad.png", world["img"][:64, :64])
    with pytest.raises(SystemExit):
        main(CPU + ["stream", "--store", world["stores"]["npz1"],
                    "--frames", str(frames_dir)])
    # No frames found refuses cleanly.
    with pytest.raises(SystemExit):
        main(CPU + ["stream", "--store", world["stores"]["npz1"],
                    "--frames", str(tmp_path / "empty_glob_*.png")])


def test_cli_localize_coarse_to_fine(world, capsys):
    capsys.readouterr()
    assert main(CPU + ["localize", "--store", world["stores"]["npz2"],
                       "--frame", world["frame"], "--coarse-to-fine"]) == 0
    out = _json(capsys)
    assert "coarse_ok" in out and "window" in out
    assert out["keypoints"] > 0
    if out["coarse_ok"]:
        assert out["window"] is not None and len(out["window"]) == 4


def test_cli_localize_pruned(world, capsys):
    """--pruned serves through the device-side CSR window and agrees with
    the plain full-DB localize."""
    store = world["stores"]["npz2"]
    capsys.readouterr()
    assert main(CPU + ["localize", "--store", store,
                       "--frame", world["frame"]]) == 0
    full = _json(capsys)
    assert main(CPU + ["localize", "--store", store,
                       "--frame", world["frame"], "--pruned"]) == 0
    out = _json(capsys)
    assert out["pruned"]["coarse_ok"]
    assert len(out["pruned"]["window"]) == 4
    assert out["keypoints"] == full["keypoints"]
    if full["homography_ok"] and out["homography_ok"]:
        np.testing.assert_allclose(out["homography"], full["homography"],
                                   atol=0.5)
    with pytest.raises(SystemExit):
        main(CPU + ["localize", "--store", store, "--frame", world["frame"],
                    "--pruned", "--coarse-to-fine"])


def test_cli_stream_pruned(world, tmp_path, capsys):
    """`stream --pruned` composes the pruned step with micro-batching; the
    summary reports the fallback count; --mesh is refused."""
    store = world["stores"]["npz2"]
    frames_dir = tmp_path / "prframes"
    names = _frames_dir(frames_dir, world["img"], 3)
    capsys.readouterr()
    assert main(CPU + ["stream", "--store", store, "--frames",
                       str(frames_dir), "--batch", "2", "--pruned"]) == 0
    lines = _lines(capsys)
    recs = [ln for ln in lines if "frame" in ln]
    assert [r["frame"] for r in recs] == names
    assert all(r["keypoints"] > 0 for r in recs)
    summary = lines[-1]["summary"]
    assert summary["frames"] == 3 and summary["pruned"] is True
    assert "fallback_frames" in summary
    with pytest.raises(SystemExit):
        main(CPU + ["stream", "--store", store, "--frames", str(frames_dir),
                    "--pruned", "--mesh", "1x2"])


def test_cli_preprocess_devices_mesh(world, tmp_path, monkeypatch):
    """`-c/--devices N` shards each tile batch over a dp mesh of the first
    N --device slots; the store equals the single-device build; more
    slots than the pool are refused, and so is --distributed without a
    coordinator."""
    from cubesat_apds_tpu_torch.store.feature_store import FeatureStore

    sharded = str(tmp_path / "dstore4")
    assert main(["--device", "cpu,cpu,cpu,cpu", "preprocess", "--dataset",
                 str(world["tiles"]), "--store", sharded, "--lod", "2",
                 "--tile-batch", "4", "-c", "4"]) == 0
    s1 = FeatureStore.load(world["stores"]["npz2"])
    s4 = FeatureStore.load(sharded)
    assert len(s1) == len(s4)
    np.testing.assert_array_equal(s1._desc, s4._desc)
    with pytest.raises(SystemExit, match="only 2 available"):
        main(["--device", "cpu,cpu", "preprocess", "--dataset",
              str(world["tiles"]), "--store", str(tmp_path / "x"),
              "--lod", "2", "-c", "4"])
    for var in ("APDS_COORDINATOR", "APDS_NUM_PROCESSES",
                "APDS_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="no coordinator"):
        main(["--device", "cpu,cpu", "preprocess", "--dataset",
              str(world["tiles"]), "--store", str(tmp_path / "x"),
              "-c", "2", "--distributed"])


def test_cli_stream_mesh(world, tmp_path, capsys):
    """`stream --mesh DPxTP` composes the stream with the mesh-parallel
    serving step over `cpu` slots; records match the single-device
    stream."""
    store = world["stores"]["npz1"]
    frames_dir = tmp_path / "mframes"
    names = _frames_dir(frames_dir, world["img"], 4)
    eight = ["--device", ",".join(["cpu"] * 8)]

    def run(argv):
        capsys.readouterr()
        assert main(argv) == 0
        lines = _lines(capsys)
        return [ln for ln in lines if "frame" in ln], lines[-1]["summary"]

    ref, _ = run(CPU + ["stream", "--store", store,
                        "--frames", str(frames_dir), "--batch", "2"])
    mesh, summary = run(eight + ["stream", "--store", store,
                                 "--frames", str(frames_dir), "--batch", "2",
                                 "--mesh", "2x4"])
    assert summary["frames"] == 4
    assert [r["frame"] for r in mesh] == names
    for a, b in zip(ref, mesh):
        assert a["keypoints"] == b["keypoints"]
        assert a["matches"] == b["matches"]
        assert a["inliers"] == b["inliers"]
    # A submesh of the pool and the default batch=1 (rounded up to dp).
    sub, _ = run(eight + ["stream", "--store", store,
                          "--frames", str(frames_dir), "--mesh", "2x2"])
    for a, b in zip(ref, sub):
        assert a["inliers"] == b["inliers"]
    with pytest.raises(SystemExit):
        main(eight + ["stream", "--store", store, "--frames",
                      str(frames_dir), "--mesh", "nonsense"])
    with pytest.raises(SystemExit, match="needs 64 devices"):
        main(eight + ["stream", "--store", store, "--frames",
                      str(frames_dir), "--mesh", "8x8"])


def test_cli_localize_viz(world, tmp_path, capsys):
    """--viz writes a keypoint/match/inlier overlay PNG and reports its
    path; several frames get per-frame suffixes."""
    store = world["stores"]["npz1"]
    f1 = world["frame"]
    f2 = _save(tmp_path / "vf2.png", np.roll(world["img"], 3, axis=1))
    viz = str(tmp_path / "viz.png")
    capsys.readouterr()
    assert main(CPU + ["localize", "--store", store, "--frame", f1,
                       "--viz", viz]) == 0
    assert _json(capsys)["viz"] == viz
    with Image.open(viz) as im:
        assert im.size == (128, 128)
    assert main(CPU + ["localize", "--store", store, "--frame", f1, f2,
                       "--viz", viz]) == 0
    outs = _json(capsys, "[")
    assert [o["viz"] for o in outs] == [str(tmp_path / "viz_0.png"),
                                        str(tmp_path / "viz_1.png")]
    assert all(os.path.exists(o["viz"]) for o in outs)


def test_cli_match(world, tmp_path, capsys):
    """`match`: kNN-ratio and crosscheck matching of two images, and the
    side-by-side export."""
    f1 = world["frame"]
    f2 = _save(tmp_path / "m2.png", np.roll(world["img"], 4, axis=1))
    viz = str(tmp_path / "matches.png")
    capsys.readouterr()
    assert main(CPU + ["match", f1, f2, "--ratio", "0.7", "-o", viz]) == 0
    out = _json(capsys)
    assert out["matches"] > 0 and out["keypoints"][0] > 0
    with Image.open(viz) as im:
        assert im.size == (256, 128)
    assert main(CPU + ["match", f1, f2, "--crosscheck"]) == 0
    out2 = _json(capsys)
    assert out2["mode"] == "crosscheck" and out2["matches"] > 0


def test_cli_descriptor_mode_adoption(world, tmp_path, capsys):
    """A store built with --descriptor-mode fast serves with no flag (its
    provenance is adopted), a conflicting override is refused, and
    --append adopts the store's mode."""
    store_dir = str(tmp_path / "fstore")
    assert main(CPU + ["preprocess", "--dataset", str(world["tiles"]),
                       "--store", store_dir, "--lod", "1", "--binary",
                       "--descriptor-mode", "fast"]) == 0
    with open(os.path.join(store_dir, "manifest.json")) as f:
        assert json.load(f)["descriptor_mode"] == "fast"
    capsys.readouterr()
    assert main(CPU + ["localize", "--store", store_dir,
                       "--frame", world["frame"]]) == 0
    assert _json(capsys)["keypoints"] > 0
    with pytest.raises(ValueError, match="descriptor_mode"):
        main(CPU + ["localize", "--store", store_dir, "--frame",
                    world["frame"], "--descriptor-mode", "exact"])
    assert main(CPU + ["preprocess", "--dataset", str(world["tiles"]),
                       "--store", store_dir, "--lod", "1", "--binary",
                       "--append"]) == 0
    with open(os.path.join(store_dir, "manifest.json")) as f:
        m = json.load(f)
    assert m["descriptor_mode"] == "fast" and len(m["segments"]) == 2


def _admin_stores(root, rng):
    """tests/test_cli.py's three-tile store, npz and binary."""
    from cubesat_apds_tpu_torch.store.binary_store import write_binary_store
    from cubesat_apds_tpu_torch.store.feature_store import FeatureStore

    s = FeatureStore()
    for t in range(3):
        iid = s.create_image(t * 100, 0, t * 100 + 100, 100, 0)
        k = 50 + t * 10
        s.add_keypoints(iid, rng.uniform(0, 100, k), rng.uniform(0, 100, k),
                        np.full(k, 4.8, np.float32),
                        np.zeros(k, np.float32),
                        rng.uniform(0, 1, k).astype(np.float32),
                        np.zeros(k, np.int32), np.zeros(k, np.int32),
                        rng.integers(0, 256, (k, 61), dtype=np.uint8))
    s.descriptor_mode = "exact"
    npz_dir, bin_dir = str(root / "npz"), str(root / "bin")
    s.save(npz_dir)
    write_binary_store(s, bin_dir)
    return npz_dir, bin_dir


def test_cli_store_info_delete(tmp_path, rng, capsys):
    """`store info` summarizes both backends; `store delete` cascades an
    image delete; `store compact` reclaims a binary store's dead rows.
    Host only: no --device."""
    npz_dir, bin_dir = _admin_stores(tmp_path, rng)
    for path, backend in ((npz_dir, "npz"), (bin_dir, "binary")):
        assert main(["store", "info", path]) == 0
        info = json.loads(capsys.readouterr().out)
        assert info["backend"] == backend
        assert info["tiles"] == 3
        assert info["keypoints_live"] == 180
        assert info["descriptor_mode"] == "exact"
        assert info["lods"] == [0]

        assert main(["store", "delete", path, "--image-id", "2"]) == 0
        res = json.loads(capsys.readouterr().out)
        assert res["keypoints_removed"] == 60
        assert res["keypoints_live"] == 120

        assert main(["store", "info", path]) == 0
        info = json.loads(capsys.readouterr().out)
        assert info["tiles"] == 2 and info["keypoints_live"] == 120

        assert main(["store", "compact", path]) == 0
        res = json.loads(capsys.readouterr().out)
        if backend == "binary":
            assert res == {"store": path, "kept": 120, "dropped": 60,
                           "compacted": True}
            assert main(["store", "info", path]) == 0
            info = json.loads(capsys.readouterr().out)
            assert info["keypoints_total"] == 120
            assert info["keypoints_live"] == 120
        else:
            assert res["compacted"] is False

    with pytest.raises(SystemExit, match="unknown image id"):
        main(["store", "delete", bin_dir, "--image-id", "99"])
    with pytest.raises(SystemExit, match="at least one"):
        main(["store", "delete", bin_dir])


def test_cli_localize_pose_and_attitude(world, tmp_path, capsys):
    """With elevation attached at preprocess time, localize solves PnP and
    prints the camera position (−Rᵀt), a unit quaternion and ZYX Euler
    angles."""
    from cubesat_apds_tpu_torch.core.attitude import pose_to_attitude

    edir = tmp_path / "elev"
    edir.mkdir()
    write_geotiff(str(edir / "e.tif"), np.full((32, 32), 100, np.uint8),
                  [10.0, 0.004, 0, 56.0, 0, -0.004])
    store_dir = str(tmp_path / "pstore")
    assert main(CPU + ["preprocess", "--dataset", str(world["tiles"]),
                       "--store", store_dir, "--lod", "1",
                       "-e", str(edir / "e.tif")]) == 0
    capsys.readouterr()
    assert main(CPU + ["localize", "--store", store_dir,
                       "--frame", world["frame"]]) == 0
    out = _json(capsys)
    assert out["pose_ok"] is True
    q = np.asarray(out["attitude_quat_wxyz"])
    assert q.shape == (4,) and abs(np.linalg.norm(q) - 1.0) < 1e-6
    assert len(out["camera_position"]) == 3
    assert len(out["attitude_euler_zyx_deg"]) == 3
    att = pose_to_attitude(np.asarray(out["rvec"], np.float32),
                           np.asarray(out["tvec"], np.float32))
    np.testing.assert_allclose(out["camera_position"], att["position"],
                               rtol=1e-6)


def test_cli_stream_follow(world, tmp_path, capsys):
    """--follow: frames dropped into the watched directory after the
    stream starts are found (write-then-rename producer) and processed;
    --max-frames ends the service."""
    spool = tmp_path / "spool"
    spool.mkdir()

    def write_frame(i):
        tmpf = spool / f"_tmp{i}"      # invisible: no image extension
        Image.fromarray((np.roll(world["img"], i, axis=1) * 255)
                        .astype(np.uint8)).save(str(tmpf), format="PNG")
        os.replace(tmpf, spool / f"f{i}.png")   # atomic appearance

    write_frame(0)
    write_frame(1)

    def producer():
        time.sleep(1.5)
        write_frame(2)
        time.sleep(0.7)
        write_frame(3)

    t = threading.Thread(target=producer)
    t.start()
    capsys.readouterr()
    try:
        rc = main(CPU + ["stream", "--store", world["stores"]["npz1"],
                         "--frames", str(spool), "--follow",
                         "--poll-interval", "0.2", "--max-frames", "4",
                         "--idle-timeout", "120"])
    finally:
        t.join()
    assert rc == 0
    lines = _lines(capsys)
    recs = [ln for ln in lines if "summary" not in ln]
    assert len(recs) == 4
    assert {os.path.basename(r["frame"]) for r in recs} == {
        "f0.png", "f1.png", "f2.png", "f3.png"}
    assert lines[-1]["summary"]["frames"] == 4


def test_cli_no_compile_cache_is_accepted(world, capsys, monkeypatch):
    """test_compile_cache_gate's counterpart: the port has no cache of
    compiled programs, so --no-compile-cache (and APDS_COMPILE_CACHE) are
    accepted and change nothing — the same output, no cache directory."""
    monkeypatch.setenv("HOME", str(world["root"] / "home"))
    argv = ["store", "info", world["stores"]["bin1"]]
    assert main(argv) == 0
    plain = json.loads(capsys.readouterr().out)
    monkeypatch.setenv("APDS_COMPILE_CACHE", str(world["root"] / "xla"))
    assert main(["--no-compile-cache"] + argv) == 0
    assert json.loads(capsys.readouterr().out) == plain
    assert not os.path.exists(world["root"] / "xla")
    assert not os.path.exists(world["root"] / "home")


# --- parity with the JAX package's command line ----------------------------

@pytest.fixture(scope="module")
def jax_world(world):
    """The JAX CLI on the same argv: preprocess (npz, 1 LoD), localize of
    the scene's frame, and store info (host only)."""
    import contextlib
    import io

    from cubesat_apds_tpu.cli import main as jmain

    store = str(world["root"] / "jax_npz1")
    out = {}
    for key, argv in (
            ("preprocess", ["preprocess", "--dataset", str(world["tiles"]),
                            "--store", store, "--lod", "1"]),
            ("localize", ["localize", "--store", store,
                          "--frame", world["frame"]]),
            ("info", ["store", "info", store])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert jmain(argv) == 0
        text = buf.getvalue()
        out[key] = text
    out["store"] = store
    return out


def test_cli_preprocess_and_localize_match_jax(world, jax_world, capsys):
    """The port's store against the JAX CLI's, with test_torch_build.py's
    preprocess tolerances (tile records equal; counts within 1%; every
    JAX row matched on its level within 0.06 px, ≥ 97% within 1e-3 px and
    ≥ 97% of those with equal descriptors; bit-exact where the counts
    agree), and the localize JSON: keypoints within 1%, matches and
    inliers within 5% (test_torch_localize.py's inlier Jaccard ≥ 0.95),
    the same keys, and H's corners within 0.5 px."""
    import dataclasses

    from cubesat_apds_tpu.store.feature_store import FeatureStore as JStore
    from cubesat_apds_tpu_torch.store.feature_store import FeatureStore

    ts = FeatureStore.load(world["stores"]["npz1"])
    js = JStore.load(jax_world["store"])
    assert [dataclasses.astuple(r) for r in ts._images.values()] == \
        [dataclasses.astuple(r) for r in js._images.values()]
    (tc, td), (jc, jd) = ts.read_keypoints_from_lod(0), \
        js.read_keypoints_from_lod(0)
    assert len(jd) > 50 and abs(len(td) - len(jd)) <= 0.01 * len(jd)
    txy = np.stack([tc["x"], tc["y"]], -1)
    jxy = np.stack([jc["x"], jc["y"]], -1)
    d = np.abs(jxy[:, None] - txy[None]).max(-1)
    level = jc["class_id"][:, None] == tc["class_id"][None]
    assert ((d <= 0.06) & level).any(1).all()
    same = (d <= 1e-3) & level
    hit = same.any(1)
    assert hit.mean() >= 0.97
    assert (td[same.argmax(1)[hit]] == jd[hit]).all(1).mean() >= 0.97

    capsys.readouterr()
    assert main(CPU + ["localize", "--store", world["stores"]["npz1"],
                       "--frame", world["frame"]]) == 0
    got = _json(capsys)
    text = jax_world["localize"]
    ref = json.loads(text[text.index("{"):])
    assert set(got) == set(ref)
    assert abs(got["keypoints"] - ref["keypoints"]) <= 0.01 * ref["keypoints"]
    for k in ("matches", "inliers"):
        assert abs(got[k] - ref[k]) <= 0.05 * ref[k], k
    assert got["homography_ok"] and ref["homography_ok"]
    corners = np.array([[0, 0, 1], [128, 0, 1], [0, 128, 1], [128, 128, 1]],
                       np.float64)

    def project(H):
        p = corners @ np.asarray(H, np.float64).T
        return p[:, :2] / p[:, 2:]

    np.testing.assert_allclose(project(got["homography"]),
                               project(ref["homography"]), rtol=0, atol=0.5)


def test_cli_store_info_matches_jax(world, jax_world, capsys):
    """`store info` on each package's own build of the same argv: the same
    JSON but the path (and the live count, within the 1% above)."""
    assert main(["store", "info", world["stores"]["npz1"]]) == 0
    got = json.loads(capsys.readouterr().out)
    ref = json.loads(jax_world["info"])
    assert abs(got.pop("keypoints_live") - ref.pop("keypoints_live")) \
        <= 0.01 * json.loads(jax_world["info"])["keypoints_live"]
    got.pop("store")
    ref.pop("store")
    assert got == ref
    # And on one store (the port's binary build), both read the same JSON.
    from cubesat_apds_tpu.cli import main as jmain

    assert main(["store", "info", world["stores"]["bin1"]]) == 0
    mine = capsys.readouterr().out
    assert jmain(["store", "info", world["stores"]["bin1"]]) == 0
    assert json.loads(capsys.readouterr().out) == json.loads(mine)


def test_cli_match_matches_jax(world, tmp_path, capsys):
    """`match --ratio 0.7` in both packages: keypoint counts within 1%,
    matches within 5% (the tolerances above)."""
    from cubesat_apds_tpu.cli import main as jmain

    f1 = world["frame"]
    f2 = _save(tmp_path / "m2.png", np.roll(world["img"], 4, axis=1))
    argv = ["match", f1, f2, "--ratio", "0.7"]
    capsys.readouterr()
    assert main(CPU + argv) == 0
    got = _json(capsys)
    assert jmain(argv) == 0
    ref = _json(capsys)
    assert got["mode"] == ref["mode"]
    for a, b in zip(got["keypoints"], ref["keypoints"]):
        assert abs(a - b) <= 0.01 * b
    assert ref["matches"] > 0
    assert abs(got["matches"] - ref["matches"]) <= 0.05 * ref["matches"]


def _posed_board(rng):
    """tests/test_calibration.py's board seen by K = (300, 300; 160, 120)
    under a random pose (tilts of ~0.2 rad, ~320 units away), rendered
    with PIL at 240×320: varied views, so Zhang's solve is well posed."""
    from test_calibration import _render_board

    r = np.array([rng.normal(0, 0.2) for _ in range(3)])
    th = np.linalg.norm(r)
    k = np.array([[0, -r[2], r[1]], [r[2], 0, -r[0]], [-r[1], r[0], 0]]) / th
    R = np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k
    t = [rng.uniform(-8, 8), rng.uniform(-8, 8), rng.uniform(300, 340)]
    K = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]])
    H = K @ np.c_[R[:, :2], t] @ np.array([[1, 0, -112.0], [0, 1, -90],
                                            [0, 0, 1]])
    inv = np.linalg.inv(H)
    tex = Image.fromarray((_render_board() * 255).astype(np.uint8))
    img = tex.transform((320, 240), Image.PERSPECTIVE,
                        (inv / inv[2, 2]).ravel()[:8], Image.BICUBIC,
                        fillcolor=int(0.9 * 255))
    return np.asarray(img, np.float32) / 255.0


def test_cli_calibrate_matches_jax(tmp_path, capsys):
    """`calibrate` on ten posed 240×320 boards in both packages: every
    view used, K within test_torch_calibration.py's 1e-3 of JAX's
    (measured: 1e-4), and near the rendering K."""
    from cubesat_apds_tpu.cli import main as jmain

    rng = np.random.default_rng(5)
    d = tmp_path / "boards"
    d.mkdir()
    for i in range(10):
        _save(d / f"b{i}.png", _posed_board(rng))
    cams = []
    for fn, extra in ((main, CPU), (jmain, [])):
        out_json = str(tmp_path / f"cam{len(cams)}.json")
        assert fn(extra + ["calibrate", str(d), "7x6", "-o", out_json]) == 0
        assert "views used: 10/10" in capsys.readouterr().out
        with open(out_json) as f:
            cams.append(json.load(f))
    np.testing.assert_allclose(cams[0]["K"], cams[1]["K"], rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(cams[0]["K"])[[0, 1, 0, 1],
                                                        [0, 1, 2, 2]],
                               [300, 300, 160, 120], atol=3.0)


# --- the device rule, the package surface, bench ---------------------------

def test_cli_refuses_without_a_card(world, tmp_path, capsys, monkeypatch):
    """With no card visible and no --device, every computing command exits
    non-zero naming `--device cpu`; `store` and `--calculate-lod` run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frame, store = world["frame"], world["stores"]["npz1"]
    for argv in (["localize", "--store", store, "--frame", frame],
                 ["stream", "--store", store, "--frames", frame],
                 ["match", frame, frame],
                 ["calibrate", str(tmp_path), "7x6"],
                 ["bench"],
                 ["preprocess", "--dataset", str(world["tiles"]),
                  "--store", str(tmp_path / "s")]):
        with pytest.raises(SystemExit, match="--device cpu"):
            main(argv)
    with pytest.raises(SystemExit, match="not visible"):
        main(["--device", "cuda:0", "match", frame, frame])
    assert main(["store", "info", store]) == 0
    assert main(["preprocess", "--dataset", str(world["tiles"]),
                 "--store", str(tmp_path / "s"), "--calculate-lod"]) == 0
    assert "LoD levels" in capsys.readouterr().out


def test_package_surface_matches_jax():
    """Every name of the JAX package's lazy surface and eager imports
    resolves in the port; importing the port imports no jax and starts no
    CUDA context."""
    import cubesat_apds_tpu as jpkg

    import cubesat_apds_tpu_torch as tpkg

    eager = [n for n in dir(jpkg) if not n.startswith("_")
             and n not in jpkg._LAZY and n not in ("core", "ops", "store",
                                                   "io", "pipelines",
                                                   "parallel", "utils",
                                                   "cli")]
    assert {"CameraModel", "PipelineConfig", "MAX_POINTS"} <= set(eager)
    assert set(tpkg._LAZY) == set(jpkg._LAZY)
    for name in eager + sorted(jpkg._LAZY):
        assert getattr(tpkg, name) is not None, name
    assert set(jpkg._LAZY) <= set(dir(tpkg))
    with pytest.raises(AttributeError):
        tpkg.no_such_name
    code = ("import sys, torch\n"
            "import cubesat_apds_tpu_torch\n"
            "assert not any(k == 'jax' or k.startswith('jax.')\n"
            "               for k in sys.modules)\n"
            "assert 'cubesat_apds_tpu_torch.ops.kernels.build' "
            "not in sys.modules\n"
            "assert not torch.cuda.is_initialized()\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_bench_run_prints_the_json_line():
    """bench.run on the CPU at one rep of one step: the JSON line's keys,
    bench.py's metric name, a positive rate."""
    from cubesat_apds_tpu_torch import bench

    line = bench.run(iters=1, reps=1, device="cpu")
    assert set(line) == {"metric", "value", "unit", "spread", "reps",
                         "device"}
    assert line["metric"] == "e2e_localize_512px_10kdb_fps"
    assert line["value"] > 0 and len(line["reps"]) == 1
    assert line["device"] == "cpu"
    json.dumps(line)
