"""Command-line interface of the port: preprocess / localize / stream /
match / calibrate / bench / store (port of cli.py).

The JAX package's subcommands with the same flags and defaults, the same
refusals and the same JSON output keys, on PyTorch tensors. One flag is
new: `--device DEV[,DEV...]` names the device slots the commands use
(default: every visible CUDA card). The first slot runs a single-device
command; `stream --mesh DPxTP` and `preprocess -c N` take the first dp·tp
(or N) slots, and a device may fill several slots (`--device
cuda:0,cuda:0,cuda:0,cuda:0 stream --mesh 2x2` on one card, `--device
cpu,cpu` for a CPU mesh). A mesh larger than the pool is refused. With no
card visible and no `--device`, every command that computes exits with
an error naming `--device cpu`: nothing runs on the CPU unasked. `store`
and `preprocess --calculate-lod` touch no device. `--device` is accepted
before or after the subcommand.

    apds-torch [--device DEV[,DEV...]] <command> ...
    python -m cubesat_apds_tpu_torch.cli <command> ...
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _pool(args):
    """The device slots of `--device` (comma-separated), or every visible
    card. Exits when there is no card and no `--device`, or when a named
    card is not visible."""
    import torch

    spec = getattr(args, "device", None)
    if spec:
        try:
            devs = [torch.device(d.strip()) for d in spec.split(",")]
        except RuntimeError as e:
            raise SystemExit(f"--device {spec!r}: {e}")
        for d in devs:
            if d.type == "cuda" and (not torch.cuda.is_available() or (
                    d.index or 0) >= torch.cuda.device_count()):
                raise SystemExit(f"--device {spec!r}: {d} is not visible "
                                 f"({torch.cuda.device_count()} CUDA "
                                 "devices)")
        return devs
    if not torch.cuda.is_available():
        raise SystemExit(
            f"{args.cmd}: no CUDA device is visible; pass --device cpu to "
            "run on the CPU (--device cpu,cpu,... for a mesh of CPU slots)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _mesh_slots(pool, n: int, flag: str):
    """The slots of an n-slot mesh: the pool's first n in a single process;
    in a distributed run every process brings its whole pool and
    make_mesh spans them all."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        return pool
    if n > len(pool):
        raise SystemExit(f"{flag}: needs {n} devices, only {len(pool)} "
                         "available")
    return pool[:n]


def _make_mesh(dp: int, tp: int, slots, flag: str):
    from cubesat_apds_tpu_torch.parallel.mesh import make_mesh

    try:
        return make_mesh(dp=dp, tp=tp, devices=slots)
    except ValueError as e:
        raise SystemExit(f"{flag}: {e}")


def _join_distributed(args):
    """--distributed: join the cross-process group from the APDS_*
    variables before any mesh is built (`main` leaves it when the command
    ends)."""
    if not getattr(args, "distributed", False):
        return
    import torch.distributed as dist

    from cubesat_apds_tpu_torch.parallel.mesh import initialize_distributed

    joined = not dist.is_initialized()
    if not initialize_distributed():
        raise SystemExit(
            "--distributed: no coordinator configured (set "
            "APDS_COORDINATOR, APDS_NUM_PROCESSES, APDS_PROCESS_ID)")
    args.joined_group = joined


def _leave_distributed(args, ok: bool) -> None:
    """Tear down the group `_join_distributed` joined. A process that
    exits with its group alive can abort in C++ teardown ("terminate
    called without an active exception"): the rendezvous store's server
    thread in process 0 may still be serving the other process's
    disconnect. After a command that succeeded, a barrier first, so no
    process tears down while another still runs a collective."""
    if not getattr(args, "joined_group", False):
        return
    import torch.distributed as dist

    if ok:
        dist.barrier()
    dist.destroy_process_group()


def _open_store(path: str):
    """Open either store backend by its manifest (store.open_store); a
    missing store is a usage error."""
    import os

    from cubesat_apds_tpu_torch.store import open_store

    try:
        return open_store(path)
    except FileNotFoundError:
        if os.path.exists(os.path.join(path, "manifest.json")):
            raise
        raise SystemExit(f"no feature store at {path!r} (missing "
                         "manifest.json — build one with `preprocess`)")


def _akaze_from_tag(tag: str):
    """AkazeConfig for a descriptor provenance tag: 'exact', 'fast',
    'hybrid' or 'hybridN' (AkazeConfig.descriptor_tag grammar)."""
    from cubesat_apds_tpu_torch.core.config import AkazeConfig

    if tag.startswith("hybrid") and tag != "hybrid":
        try:
            sub = int(tag[len("hybrid"):])
        except ValueError:
            raise SystemExit(f"--descriptor-mode {tag!r}: expected exact, "
                             "fast, hybrid or hybridN")
        if sub < 2:
            raise SystemExit(f"--descriptor-mode {tag!r}: hybridN needs "
                             "N >= 2 (sub-way subcells per MLDB cell)")
        return AkazeConfig(descriptor_mode="hybrid", hybrid_subcells=sub)
    if tag not in ("exact", "fast", "hybrid"):
        raise SystemExit(f"--descriptor-mode {tag!r}: expected exact, "
                         "fast, hybrid or hybridN")
    return AkazeConfig(descriptor_mode=tag)


def _store_config(store, mode_arg):
    """Pipeline config for serving against a store: an explicit
    --descriptor-mode wins (check_descriptor_mode still validates it
    downstream); otherwise adopt the store's recorded provenance tag."""
    from cubesat_apds_tpu_torch.core.config import PipelineConfig

    tag = mode_arg or getattr(store, "descriptor_mode", None) or "exact"
    return PipelineConfig(akaze=_akaze_from_tag(tag))


def _load_gray(path):
    """Load an image as float32 grayscale in [0, 1] — the one loading
    idiom for every CLI frame input (localize, match)."""
    from cubesat_apds_tpu_torch.utils.viz import read_image_gray

    return read_image_gray(path)


def _camera_from_args(camera_path, shape, device):
    """CameraModel on `device` from a calibrate-produced json (K and dist
    as float32 tensors), or the ideal camera of the frame geometry."""
    import torch

    from cubesat_apds_tpu_torch.core.types import CameraModel

    if camera_path:
        with open(camera_path) as f:
            c = json.load(f)
        return CameraModel(
            K=torch.tensor(c["K"], dtype=torch.float32, device=device),
            dist=torch.tensor(c.get("dist", [0] * 5), dtype=torch.float32,
                              device=device))
    h, w = shape
    return CameraModel.ideal(float(max(h, w)), float(max(h, w)),
                             w / 2.0, h / 2.0, device=device)


def _host(t):
    return t.detach().cpu().numpy()


def _cmd_preprocess(args):
    import os

    _join_distributed(args)

    from cubesat_apds_tpu_torch.core.config import PipelineConfig
    from cubesat_apds_tpu_torch.io.mosaic import MosaicDataset
    from cubesat_apds_tpu_torch.pipelines.preprocess import preprocess

    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume requires --checkpoint-dir")
    # Every --append precondition is checked BEFORE the (potentially
    # hours-long) extraction run.
    mode = args.descriptor_mode
    if args.append:
        if not args.binary:
            raise SystemExit("--append requires --binary (segmented store)")
        mpath = os.path.join(args.store, "manifest.json")
        if not os.path.exists(mpath):
            raise SystemExit(f"--append: no store at {args.store}")
        with open(mpath) as f:
            recorded = json.load(f).get("descriptor_mode")
        if mode is None:
            mode = recorded or "exact"
        elif recorded is not None and mode != recorded:
            raise SystemExit(
                f"--append: store was built with descriptor_mode "
                f"'{recorded}'; refusing to extract '{mode}' descriptors "
                "(omit --descriptor-mode to adopt the store's)")
    mode = mode or "exact"

    # --calculate-lod only reads the mosaic's header: no device.
    pool = None if args.calculate_lod else _pool(args)
    dev = "cpu" if pool is None else pool[0]
    if args.mosaic:
        ds = MosaicDataset.from_materialized(args.mosaic, device=dev)
    else:
        ds = MosaicDataset.from_folder(args.dataset, device=dev)
        if args.materialize:
            ds.materialize(args.materialize, format=args.mosaic_format)
            print(f"materialized mosaic -> {args.materialize} "
                  f"({args.mosaic_format})")
    if args.calculate_lod:
        # Prints the LoD resolutions and exits (preprocessor
        # main.rs:74-84 + print_resolution).
        from cubesat_apds_tpu_torch.ops.image import (
            calculate_amount_of_levels)

        w, h = ds.get_dimensions()
        n = calculate_amount_of_levels(w * h)
        print(f"dimensions: {w}x{h}; LoD levels: {n}")
        # print_resolution (level_of_detail.rs:40-52): halve both edges
        # while each stays ≥ MINIMUM_RESOLUTION.
        x, y, lod = w, h, 0
        while x >= 500 and y >= 500:
            print(f"  lod: {lod + 1} | x: {x} | y: {y}")
            x //= 2
            y //= 2
            lod += 1
        return 0
    mesh = None
    if args.devices > 1:
        # The reference's `-c/--cpu-num` fan-out (preprocessor
        # main.rs:86-89): each tile batch split over a dp mesh.
        flag = f"--devices {args.devices}"
        mesh = _make_mesh(args.devices, 1,
                          _mesh_slots(pool, args.devices, flag), flag)
    t0 = time.perf_counter()
    store, stats = preprocess(
        ds, config=PipelineConfig(akaze=_akaze_from_tag(mode)),
        amount_lod=args.lod or None,
        tile_batch=args.tile_batch, elevation_path=args.elevation_path,
        progress=print, mesh=mesh,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, resume=args.resume)
    if args.binary:
        from cubesat_apds_tpu_torch.store.binary_store import (
            append_binary_store, write_binary_store)

        if args.append:
            append_binary_store(args.store, store)
        else:
            write_binary_store(store, args.store)
    else:
        store.save(args.store)
    verb = "appended to" if args.append else "saved ->"
    print(f"store {verb} {args.store}: {stats.keypoints} keypoints, "
          f"{stats.tiles} tiles, {stats.lods} LoDs "
          f"({time.perf_counter() - t0:.1f}s)")
    return 0


def _write_localize_viz(viz_path, n_frames, idx, frame, res):
    """Draw the frame's detections (green), ratio-test matches (yellow)
    and homography inliers (red) — the single-image analogue of the
    reference's export_matches. Returns the written path (indexed per
    frame when several are given)."""
    import os

    import numpy as np

    from cubesat_apds_tpu_torch.utils.viz import draw_keypoints, write_image

    kp, m = res.keypoints, res.matches
    xy = _host(kp.xy)
    valid = _host(kp.valid)
    q = _host(m.query_idx)
    mvalid = _host(m.valid)
    inl = mvalid & _host(res.homography.inliers)
    matched = np.zeros(len(xy), bool)
    matched[q[mvalid]] = True
    inlier = np.zeros(len(xy), bool)
    inlier[q[inl]] = True
    img = draw_keypoints(frame, xy, valid & ~matched, color=(0, 255, 0))
    img = draw_keypoints(img, xy, matched & ~inlier, color=(255, 220, 0))
    img = draw_keypoints(img, xy, inlier, color=(255, 40, 40))
    path = viz_path
    if n_frames > 1:
        stem, ext = os.path.splitext(viz_path)
        path = f"{stem}_{idx}{ext or '.png'}"
    write_image(path, img)
    return path


def _pose_fields(out, rvec, tvec, pose_ok, inliers=None):
    """The pose block: rvec/tvec (and the PnP inlier count where given),
    and where the pose is ok the camera position (world frame; ECEF when
    the store carries elevation) and attitude — the deliverable the
    project is named for; Euler angles with the inlier count, as
    `localize` prints them."""
    out["pose_ok"] = pose_ok
    out["rvec"] = rvec.tolist()
    out["tvec"] = tvec.tolist()
    if inliers is not None:
        out["pose_inliers"] = inliers
    if pose_ok:
        from cubesat_apds_tpu_torch.core.attitude import pose_to_attitude

        att = pose_to_attitude(rvec, tvec)
        out["camera_position"] = att["position"].tolist()
        out["attitude_quat_wxyz"] = att["quat_wxyz"].tolist()
        if inliers is not None:
            out["attitude_euler_zyx_deg"] = att["euler_zyx_deg"].tolist()


def _cmd_localize(args):
    import contextlib

    import numpy as np
    import torch

    from cubesat_apds_tpu_torch.pipelines.localize import (
        Localizer, check_descriptor_mode, load_device_db,
        load_pruned_device_db, localize_coarse_to_fine,
        localize_frame_pruned_fallback_jit, localize_frame_pruned_jit)

    dev = _pool(args)[0]
    store = _open_store(args.store)
    config = _store_config(store, args.descriptor_mode)
    frames = [_load_gray(path) for path in args.frame]
    # The ideal-camera fallback uses the FIRST frame's geometry; require
    # uniform frame sizes so later frames aren't misnormalized.
    if not args.camera and len({f.shape for f in frames}) > 1:
        raise SystemExit(
            "frames have different sizes; the ideal-camera fallback "
            "would misnormalize — pass --camera")
    camera = _camera_from_args(args.camera, frames[0].shape, dev)
    if args.pruned and args.coarse_to_fine:
        raise SystemExit(
            "--pruned and --coarse-to-fine are alternative pruning "
            "strategies (device-side window vs host re-window) — "
            "pass one")
    # The device DB loads ONCE; every frame reuses it. Coarse-to-fine
    # re-windows the fine DB per frame instead; --pruned keeps the window
    # on the device.
    localizer = coarse_db = pruned_db = None
    if args.pruned:
        check_descriptor_mode(store, config)
        pruned_db = load_pruned_device_db(store, fine_lod=args.lod,
                                          match_config=config.match,
                                          device=dev)
    elif args.coarse_to_fine:
        recs = (store.images if hasattr(store, "images")
                else store._images).values()
        coarse_lod = max(r.level_of_detail for r in recs)
        coarse_db = load_device_db(store, coarse_lod, device=dev)
    else:
        localizer = Localizer(store, camera, config, device=dev)

    results = []
    stack = contextlib.ExitStack()
    if args.profile:
        # The trace is written even when a frame raises mid-loop.
        from cubesat_apds_tpu_torch.utils.profiling import device_trace

        stack.enter_context(device_trace(args.profile))
    with stack:
        for path, frame in zip(args.frame, frames):
            t0 = time.perf_counter()
            pruned_info = None
            if args.pruned:
                fdev = torch.from_numpy(frame).to(dev)
                pr = localize_frame_pruned_jit(
                    fdev, pruned_db, camera, config,
                    solve_pose=pruned_db.has_world)
                coarse_ok = bool(pr.coarse_ok)
                overflow = bool(pr.overflow)
                if coarse_ok and not overflow:
                    res = pr.result
                else:
                    # Rare: no coarse fix or a window overflow — the
                    # full-DB step rebuilt from the pruned row table.
                    res = localize_frame_pruned_fallback_jit(
                        fdev, pruned_db, camera, config,
                        solve_pose=pruned_db.has_world)
                pruned_info = {
                    "coarse_ok": coarse_ok,
                    "overflow": overflow,
                    "window": [round(float(v), 2) for v in _host(pr.window)],
                    "window_rows": int(pr.n_window),
                    "fallback": not coarse_ok or overflow,
                }
            elif args.coarse_to_fine:
                res, coarse, window = localize_coarse_to_fine(
                    frame, store, camera, config, coarse_db=coarse_db,
                    device=dev)
            else:
                res = localizer.localize(torch.from_numpy(frame),
                                         lod=args.lod)
            dt = time.perf_counter() - t0
            out = {
                "frame": path,
                "keypoints": int(res.num_keypoints),
                "matches": int(res.num_matches),
                "homography_ok": bool(res.homography.ok),
                "homography": _host(res.homography.H).tolist(),
                "inliers": int(res.homography.num_inliers),
                "seconds": round(dt, 3),
            }
            if pruned_info is not None:
                out["pruned"] = pruned_info
            if args.coarse_to_fine:
                out["coarse_ok"] = bool(coarse.homography.ok)
                out["window"] = (None if window is None
                                 else [round(float(v), 2) for v in window])
            if res.pose is not None:
                _pose_fields(out, _host(res.pose.rvec), _host(res.pose.tvec),
                             bool(res.pose.ok), int(res.pose.num_inliers))
            if args.viz:
                out["viz"] = _write_localize_viz(
                    args.viz, len(args.frame), len(results), frame, res)
            results.append(out)
    if args.profile:
        print(f"device trace -> {args.profile}", file=sys.stderr)
    print(json.dumps(results[0] if len(results) == 1 else results,
                     indent=2))
    return 0


_FRAME_EXTS = (".png", ".jpg", ".jpeg", ".tif", ".tiff")


def _resolve_frames(specs, strict=False):
    """Expand frame specs (files, globs, directories) to sorted paths."""
    import glob
    import os

    paths = []
    for spec in specs:
        if os.path.isdir(spec):
            paths += [os.path.join(spec, e) for e in sorted(os.listdir(spec))
                      if e.lower().endswith(_FRAME_EXTS)]
        elif any(c in spec for c in "*?["):
            paths += sorted(glob.glob(spec))   # no hits -> contributes none
        elif os.path.exists(spec):
            paths.append(spec)
        elif strict:
            raise SystemExit(f"stream: no such frame: {spec}")
    return paths


def _cmd_stream(args):
    import os

    import numpy as np
    from PIL import Image

    # A multi-process run joins its group before anything else (--mesh
    # then spans every process's slots).
    _join_distributed(args)

    from cubesat_apds_tpu_torch.pipelines.localize import (
        check_descriptor_mode, load_device_db)
    from cubesat_apds_tpu_torch.pipelines.stream import StreamingLocalizer

    paths = _resolve_frames(args.frames, strict=True)
    if not paths:
        if not args.follow:
            raise SystemExit("stream: no frames found")
        # Service mode may start on an empty spool directory: wait for
        # the first frame (it sets the stream's frame shape).
        deadline = (time.monotonic() + args.idle_timeout
                    if args.idle_timeout else None)
        while not paths:
            if deadline is not None and time.monotonic() > deadline:
                raise SystemExit(
                    "stream: no frames appeared within --idle-timeout")
            time.sleep(args.poll_interval)
            paths = _resolve_frames(args.frames)

    store = _open_store(args.store)
    pool = _pool(args)
    dev = pool[0]

    with Image.open(paths[0]) as im:
        first = np.asarray(im.convert("L"), np.uint8)
    camera = _camera_from_args(args.camera, first.shape, dev)
    first_cell = [first]               # reuse the probe decode for frame 0

    def decode(path):
        if first_cell and path == paths[0]:
            return first_cell.pop()
        with Image.open(path) as im:
            a = np.asarray(im.convert("L"), np.uint8)
        if a.shape != first.shape:
            raise SystemExit(
                f"stream: {path} is {a.shape}, expected {first.shape} — "
                "streamed frames must share one shape")
        return a

    config = _store_config(store, args.descriptor_mode)
    check_descriptor_mode(store, config)
    if args.pruned:
        if args.mesh:
            raise SystemExit(
                "--pruned and --mesh are alternative serving-scale "
                "strategies (device spatial window vs tp-sharded full "
                "DB) — pass one")
        from cubesat_apds_tpu_torch.pipelines.localize import \
            load_pruned_device_db

        db = load_pruned_device_db(store, fine_lod=args.lod,
                                   match_config=config.match, device=dev)
    else:
        db = load_device_db(store, args.lod, match_config=config.match,
                            device=dev)
    mesh = None
    if args.mesh:
        # Frames sharded over dp, the DB over tp (parallel/serve.py).
        from cubesat_apds_tpu_torch.parallel.serve import shard_device_db

        try:
            dp, tp = (int(v) for v in args.mesh.lower().split("x"))
        except ValueError:
            raise SystemExit(f"--mesh {args.mesh!r}: expected DPxTP, "
                             "e.g. 2x4")
        flag = f"--mesh {args.mesh}"
        mesh = _make_mesh(dp, tp, _mesh_slots(pool, dp * tp, flag), flag)
        db = shard_device_db(mesh, db, match_config=config.match)
    s = StreamingLocalizer(db, camera, config=config,
                           solve_pose=db.has_world, batch=args.batch,
                           mesh=mesh, device=dev)

    def source():
        """Yield frame paths; in --follow mode keep watching the dir/
        glob specs for NEW files (a new file is only taken once its size
        is stable across two polls). Ends at --max-frames, or after
        --idle-timeout seconds without a new frame (never, if unset)."""
        queue = list(paths)
        seen = set(paths)
        sizes = {}
        yielded = 0
        idle = None                    # start of the current idle period
        while True:
            while queue:
                yield queue.pop(0)
                yielded += 1
                idle = None            # time blocked in the consumer
                if args.max_frames and yielded >= args.max_frames:
                    return             # never counts as idle
            if not args.follow:
                return
            if idle is None:
                idle = time.monotonic()
            time.sleep(args.poll_interval)
            for p in _resolve_frames(args.frames):
                if p in seen:
                    continue
                try:
                    sz = os.path.getsize(p)
                except OSError:
                    continue           # vanished between listing and stat
                if sizes.get(p) == sz and sz > 0:
                    seen.add(p)
                    paths.append(p)    # res.frame_id indexes this list
                    queue.append(p)
                else:
                    sizes[p] = sz
            if not queue and args.idle_timeout and \
                    time.monotonic() - idle > args.idle_timeout:
                return

    t0 = time.perf_counter()
    n = 0
    for res in s.run(source(), preprocess=decode):
        n += 1
        out = {
            "frame": paths[res.frame_id],
            "keypoints": res.num_keypoints,
            "matches": res.num_matches,
            "homography_ok": res.homography_ok,
            "homography": res.homography.tolist(),
            "inliers": res.num_inliers,
            "latency_s": round(res.latency_s, 4),
        }
        if res.rvec is not None:
            _pose_fields(out, res.rvec, res.tvec, res.pose_ok)
        print(json.dumps(out), flush=True)
    wall = time.perf_counter() - t0
    lat = s.times.values("total_latency")
    summary = {
        "frames": n,
        "sustained_fps": round(n / max(wall, 1e-9), 2),
        "p50_latency_s": round(float(np.percentile(lat, 50)), 4),
        "p90_latency_s": round(float(np.percentile(lat, 90)), 4),
        "batch": s.batch,
    }
    if args.pruned:
        summary["pruned"] = True
        summary["fallback_frames"] = s.fallback_frames
    print(json.dumps({"summary": summary}))
    return 0


def _cmd_match(args):
    """Two-image feature matching + optional side-by-side export — the
    CLI form of the reference's get_knn_matches / get_bruteforce_matches
    / export_matches trio (feature_extraction/src/lib.rs:94-155)."""
    import torch

    from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute
    from cubesat_apds_tpu_torch.ops.match import crosscheck_match, knn_match

    dev = _pool(args)[0]
    imgs = [_load_gray(path) for path in (args.img1, args.img2)]
    cfg = _akaze_from_tag(args.descriptor_mode)
    f1 = detect_and_compute(torch.from_numpy(imgs[0]).to(dev), cfg)
    f2 = detect_and_compute(torch.from_numpy(imgs[1]).to(dev), cfg)
    if args.crosscheck:
        m = crosscheck_match(f1.descriptors, f2.descriptors,
                             q_valid=f1.keypoints.valid,
                             db_valid=f2.keypoints.valid)
    else:
        m = knn_match(f1.descriptors, f2.descriptors, ratio=args.ratio,
                      q_valid=f1.keypoints.valid,
                      db_valid=f2.keypoints.valid)
    out = {
        "keypoints": [int(f1.keypoints.count()), int(f2.keypoints.count())],
        "matches": int(m.count()),
        "mode": "crosscheck" if args.crosscheck else f"knn ratio={args.ratio}",
    }
    if args.out:
        from cubesat_apds_tpu_torch.utils.viz import export_matches

        export_matches(imgs[0], f1, imgs[1], f2, m, args.out)
        out["viz"] = args.out
    print(json.dumps(out, indent=2))
    return 0


def _cmd_calibrate(args):
    from cubesat_apds_tpu_torch.pipelines.calibrate import (
        calibrate_from_images, format_report, read_gray_images)

    dev = _pool(args)[0]
    images = read_gray_images(args.img_path)
    nx, ny = (int(v) for v in args.corners.split("x"))
    res, found = calibrate_from_images(images, (nx, ny), device=dev)
    print(f"views used: {int(found.sum())}/{len(images)}")
    print(format_report(res))
    if args.output:
        with open(args.output, "w") as f:
            json.dump({"K": _host(res.camera.K).tolist(),
                       "dist": _host(res.camera.dist).tolist(),
                       "rms": float(res.rms)}, f, indent=2)
        print(f"camera model saved -> {args.output}")
    return 0


def _cmd_bench(args):
    from cubesat_apds_tpu_torch import bench

    return bench.main(device=_pool(args)[0])


def _cmd_store(args):
    """Store administration: inspect or mutate an on-disk feature DB.

    `info` summarizes either backend; `delete` is the reference's
    cascaded image delete (imagedb.rs:66-72 — the tile record and every
    keypoint it owns), in place on a binary store and re-saving an npz
    store; `compact` rewrites a binary store into one dense segment,
    reclaiming deleted rows' disk. Host only."""
    from cubesat_apds_tpu_torch.store.binary_store import (
        BinaryFeatureStore, compact_binary_store)

    store = _open_store(args.store)
    is_binary = isinstance(store, BinaryFeatureStore)
    images = store.images if is_binary else store._images

    if args.action == "compact":
        if not is_binary:
            # The npz store is rewritten whole on every save.
            print(json.dumps({"store": args.store, "backend": "npz",
                              "compacted": False,
                              "note": "npz stores compact on save"}))
            return 0
        del store                      # close mmaps before the rewrite
        kept, dropped = compact_binary_store(args.store)
        print(json.dumps({"store": args.store, "kept": kept,
                          "dropped": dropped, "compacted": True}))
        return 0

    if args.action == "info":
        lods = sorted({r.level_of_detail for r in images.values()})
        info = {
            "store": args.store,
            "backend": "binary" if is_binary else "npz",
            "tiles": len(images),
            "lods": lods,
            "descriptor_mode": store.descriptor_mode,
        }
        if is_binary:
            info["segments"] = [dict(s) for s in store.segments]
            info["keypoints_total"] = int(store.n)
            info["keypoints_live"] = len(store)
            info["has_elevation"] = bool(store.manifest["has_elevation"])
        else:
            info["keypoints_live"] = int(store._n)
            info["has_elevation"] = store._elevation is not None
        print(json.dumps(info, indent=2))
        return 0

    # delete
    if not args.image_id:
        raise SystemExit("store delete: give at least one --image-id")
    missing = [i for i in args.image_id if i not in images]
    if missing:
        raise SystemExit(f"store delete: unknown image id(s) {missing}; "
                         f"known ids: {sorted(images)}")
    before = len(store) if is_binary else int(store._n)
    for iid in args.image_id:
        store.delete_image(iid)
    if not is_binary:
        store.save(args.store)
    after = len(store) if is_binary else int(store._n)
    print(json.dumps({"deleted_images": args.image_id,
                      "keypoints_removed": before - after,
                      "keypoints_live": after}))
    return 0


_DEVICE_HELP = ("device slots, comma-separated (cuda:0, cpu; a device may "
                "repeat): the first runs single-device commands, --mesh "
                "and -c take the first dp*tp or N (default: every visible "
                "CUDA card)")


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="apds-torch",
        description="Satellite attitude determination pipeline "
                    "(PyTorch / CUDA)")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="accepted so that a command line of the JAX "
                        "package runs unchanged; does nothing here (no "
                        "cache of compiled programs: the CUDA kernels are "
                        "built once into build/kernels/)")
    p.add_argument("--device", default=None, help=_DEVICE_HELP)
    sub = p.add_subparsers(dest="cmd", required=True)

    def command(name, help_):
        sp = sub.add_parser(name, help=help_)
        # --device after the subcommand too; SUPPRESS keeps a value given
        # before it.
        sp.add_argument("--device", default=argparse.SUPPRESS,
                        help=_DEVICE_HELP)
        return sp

    pp = command("preprocess", "build the feature store")
    src = pp.add_mutually_exclusive_group(required=True)
    src.add_argument("--dataset", help="folder of GeoTIFF tiles")
    src.add_argument("--mosaic", help="materialized mosaic to resume from")
    pp.add_argument("--store", required=True, help="output store directory")
    pp.add_argument("--materialize", help="persist the mosaic here")
    pp.add_argument("--mosaic-format", choices=("npy", "cog"),
                    default="npy",
                    help="materialized artifact: npy (memmap dir) or an "
                         "interoperable cloud-optimized GeoTIFF")
    pp.add_argument("-l", "--lod", type=int, default=0,
                    help="LoD levels (0 = auto, like --calculate-lod)")
    pp.add_argument("--calculate-lod", action="store_true")
    pp.add_argument("--tile-batch", type=int, default=8)
    pp.add_argument("-c", "--devices", type=int, default=1,
                    help="shard each tile batch over a dp mesh of the "
                         "first N --device slots (the reference "
                         "preprocessor's -c/--cpu-num analogue)")
    pp.add_argument("--distributed", action="store_true",
                    help="join a cross-process mesh first "
                         "(torch.distributed; APDS_COORDINATOR/"
                         "_NUM_PROCESSES/_PROCESS_ID); every process "
                         "brings its --device slots and -c then counts "
                         "all processes' slots")
    pp.add_argument("--binary", action="store_true",
                    help="write the mmap binary store (native queries)")
    pp.add_argument("--append", action="store_true",
                    help="append these tiles as a new segment of an "
                         "existing --binary store (incremental DB growth)")
    pp.add_argument("-e", "--elevation-path")
    pp.add_argument("--checkpoint-dir",
                    help="persist the partial store here every "
                         "--checkpoint-every tile batches; a crashed "
                         "run continues with --resume")
    pp.add_argument("--checkpoint-every", type=int, default=16)
    pp.add_argument("--resume", action="store_true",
                    help="continue a crashed run from --checkpoint-dir "
                         "(no-op if no checkpoint exists)")
    pp.add_argument("--descriptor-mode", default=None,
                    help="AKAZE descriptor sampling used to BUILD the "
                         "store: exact (default), fast, hybrid or hybridN"
                         " — recorded as provenance in the store; with "
                         "--append it defaults to the store's recorded "
                         "mode and must match it")
    pp.set_defaults(fn=_cmd_preprocess)

    pl = command("localize", "frame -> pose")
    pl.add_argument("--store", required=True)
    pl.add_argument("--frame", required=True, nargs="+",
                    help="one or more frames (the device DB loads once)")
    pl.add_argument("--camera", help="camera json (from calibrate)")
    pl.add_argument("--lod", type=int, default=0)
    pl.add_argument("--viz", help="write a keypoint/match/inlier "
                    "visualization PNG here (per-frame suffix when "
                    "several frames are given)")
    pl.add_argument("--profile", help="record a torch.profiler trace "
                    "(CPU and CUDA activity, Chrome trace.json) under "
                    "this dir")
    pl.add_argument("--descriptor-mode", default=None,
                    help="override the descriptor mode (exact/fast/"
                         "hybrid/hybridN); default: adopt the store's "
                         "recorded mode")
    pl.add_argument("--pruned", action="store_true",
                    help="serving-scale spatial pruning: coarse fix + "
                         "DEVICE-side CSR window over the fine LoD (falls "
                         "back to the full DB on coarse miss/overflow)")
    pl.add_argument("--coarse-to-fine", action="store_true",
                    help="two-stage: match the coarsest LoD first, then "
                    "only LoD-0 keypoints inside the projected window "
                    "(ignores --lod)")
    pl.set_defaults(fn=_cmd_localize)

    ps = command("stream", "continuous frame stream -> pose (JSONL)")
    ps.add_argument("--store", required=True)
    ps.add_argument("--frames", required=True, nargs="+",
                    help="frame files, globs, or directories (sorted); "
                         "all frames must share one shape")
    ps.add_argument("--batch", type=int, default=1,
                    help="frames per device step (one front-end pass and "
                         "one fetch per batch)")
    ps.add_argument("--camera", help="camera json (from calibrate)")
    ps.add_argument("--lod", type=int, default=0)
    ps.add_argument("--pruned", action="store_true",
                    help="serving-scale spatial pruning per frame "
                         "(device CSR window; composes with --batch and "
                         "--follow, not with --mesh)")
    ps.add_argument("--mesh", help="DPxTP mesh over the first dp*tp "
                    "--device slots, e.g. 2x4: frames sharded over dp, "
                    "the DB over tp (batch rounds up to a dp multiple)")
    ps.add_argument("--distributed", action="store_true",
                    help="join a multi-process mesh first "
                         "(torch.distributed via APDS_COORDINATOR/"
                         "APDS_NUM_PROCESSES/APDS_PROCESS_ID); --mesh "
                         "then spans every process's --device slots")
    ps.add_argument("--descriptor-mode", default=None,
                    help="override the descriptor mode (exact/fast/"
                         "hybrid/hybridN); default: adopt the store's "
                         "recorded mode")
    ps.add_argument("--follow", action="store_true",
                    help="service mode: after draining the initial "
                         "frames, keep watching directory/glob specs "
                         "for new files (may start on an empty dir)")
    ps.add_argument("--poll-interval", type=float, default=0.5,
                    help="seconds between --follow directory polls")
    ps.add_argument("--idle-timeout", type=float, default=None,
                    help="stop --follow after this many seconds without "
                         "a new frame (default: run forever)")
    ps.add_argument("--max-frames", type=int, default=None,
                    help="stop after processing this many frames")
    ps.set_defaults(fn=_cmd_stream)

    pm = command("match", "match two images (kNN ratio / crosscheck)")
    pm.add_argument("img1")
    pm.add_argument("img2")
    pm.add_argument("--ratio", type=float, default=0.3,
                    help="Lowe ratio (reference test default 0.3)")
    pm.add_argument("--crosscheck", action="store_true",
                    help="mutual-nearest instead of kNN+ratio")
    pm.add_argument("--descriptor-mode", default="exact",
                    help="AKAZE descriptor sampling: exact (default), "
                         "fast, hybrid or hybridN")
    pm.add_argument("-o", "--out", help="write a side-by-side match "
                    "visualization here")
    pm.set_defaults(fn=_cmd_match)

    pc = command("calibrate", "camera intrinsics")
    pc.add_argument("img_path")
    pc.add_argument("corners", help="inner corners, e.g. 7x6")
    pc.add_argument("-o", "--output", help="save camera json here")
    pc.set_defaults(fn=_cmd_calibrate)

    pb = command("bench", "run the headline benchmark "
                 "(cubesat_apds_tpu_torch.bench)")
    pb.set_defaults(fn=_cmd_bench)

    pst = command("store", "inspect / mutate a feature store (host only)")
    pst.add_argument("action", choices=("info", "delete", "compact"))
    pst.add_argument("store", help="store directory (npz or binary)")
    pst.add_argument("--image-id", type=int, nargs="+", default=[],
                     help="tile image id(s) to cascade-delete "
                          "(store delete)")
    pst.set_defaults(fn=_cmd_store)

    args = p.parse_args(argv)
    ok = False
    try:
        rc = args.fn(args)
        ok = True
        return rc
    finally:
        _leave_distributed(args, ok)


if __name__ == "__main__":
    sys.exit(main())
