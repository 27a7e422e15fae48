#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cubesat_apds_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

1. Builds the CUDA kernels from cubesat_apds_tpu_torch/csrc/ with nvcc and
   prints the card's name and power limit.
2. Kernel phase: each kernel against its plain PyTorch twin on the card —
   kernel A (FED cycle) bit-exact at every main-path level with its real τ
   schedule, at 1024² and on a ragged 72×128 case, in its plan's form and
   in the other forms (plain tiles, clusters of 8 and 16), one line per
   level with the plan, eager and device time and byte bound, and the
   device time of 15 one-pixel launches (the floor of a frame's 15
   cycles); kernel B (patch
   sampler, a direct gather) at the main path's K (the capacity ladder's
   rung for bench.py's frame, 1280) and at K=2048 with S=109 and S=441
   (bit-exact), beside one index_select of the same samples; kernel 4
   (Hamming kNN-2
   on int8 tensor cores) bit-exact on d0, d1 and i0 at Q=2048 ×
   M=1,048,576, on a ragged M=1,000,003 with ~5% invalid rows and on rows
   duplicated across the kernel's chunk edges, beside torch._int_mm of the
   same bits (the products alone), with its compiled tile shape, shared
   memory, blocks per SM and, where cuobjdump is at hand, its tensor-core
   (IGMMA) instructions; and kernel 4 at the batch step's shape, Q =
   16,384 (8 frames × 2,048) × M = 1,048,576 with ~5% invalid rows,
   bit-exact, timed beside its twin with its bound —
   with median times of each kernel and its twin from CUDA events around
   back-to-back eager calls ("ms", what the main path pays per call), each
   kernel's and library call's device time from CUDA-graph replays
   ("device_ms", the host's per-call cost left out), and each kernel's
   bound (the least time the card could take for the same work).
3. Slice phase: bench.py's scene (512² frame from seed 42, a 10,240-row DB
   built by the port from the frame rolled by (7, 13); the scene comes from
   cubesat_apds_tpu_torch.bench.scene, which `apds-torch bench` times) through
   Localizer.localize with solve_pose=True: the homography must recover the
   (13, 7) px shift within 1 px, the launch counters must show 15 kernel-A
   and 2 kernel-B launches for the frame (kernel B's is the count its
   kernel keeps on the device: it runs inside the ladder's CUDA graph,
   whose kernels the profiler's trace misattributes between sessions;
   every kernel-B count of this script is that counter's, and includes
   the warm-up launches of a ladder graph captured in its window, which
   each check adds to what it expects), and the same frame run through
   the port on the CPU must agree (homography-inlier Jaccard ≥ 0.95, pose
   ok flag equal, rotation within 0.1°). The back half runs as one CUDA
   graph a key (pipelines/step_graph.py): on the frame's features the
   graphed back half equals the eager back half (localize_from_features,
   the function the graph captures) bit for bit, also on a second DB of
   the same shapes, which must run through the same graph; the Procrustes
   kernel launches once a frame (its device counter); a warmed step on a
   host frame runs under set_sync_debug_mode("error"). Times the warmed
   step: median of 10, host clock around a synchronised step, with CUDA
   events recorded around each step beside it.
4. Big-DB phase: bench_localize_bigdb.py's scene made on the card from a
   seeded torch.Generator — the 2,048 real rows of the rolled frame, then
   uniform random filler to 1,048,576 rows, xy uniform over [0, 8192)² —
   through Localizer.localize: one kNN-2 launch per frame (plus 15
   kernel-A and 2 kernel-B), (13, 7) within 1 px, matches identical to the
   kernel="scan" twin on the same features, the graphed back half equal
   to the eager one bit for bit, a warmed step under
   set_sync_debug_mode("error"), and the warmed step time (kernel 4's and
   the Procrustes kernel's launches are counted on the device: inside the
   graph no host wrapper runs).
   (The kernel phase also runs kernels A and B on a batch of 8 frames:
   kernel A once per level for the batch, every main-path level, with its
   plan and device time per image; kernel B on 8 stacks folded into its
   stack axis; both bit-exact per image against the twins.)
5. Pruned phase: the same DB with the first 32,768 rows as the coarse DB
   and a window capacity of 16,384, through localize_frame_pruned_jit: coarse
   fix ok, no overflow, (13, 7) within 1 px, and ≥ 0.9 of the big-DB
   step's homography inliers (by global row id) kept; the graphed pruned
   back half equal to _pruned_back_half bit for bit; a warmed step under
   set_sync_debug_mode("error"); the warmed step time.
5b. Procrustes phase: csrc/procrustes3.cu against its plain twin (the
   torch.linalg.svd form) on the slice's refit matrices and on seeded
   random, near-singular, reflection, rank-2 and zero cases: R within
   1e-6 of the twin evaluated in float64 (the kernel's precision; the
   float32 twin's difference printed), NaN where S is not finite; eager,
   device, twin and torch.linalg.svd ms at the path's shape beside the
   bound (the FP64 flops its sweeps do on these inputs, or its bytes).
5c. Paired phase: the serving step with its back half eager and graphed,
   in turns (eager, graph, graph, eager), for the 10k slice at B = 1 and
   8 and the 1M DB at B = 8: frames/s, host launches a step (the CUDA
   runtime's launch, copy and memset calls under torch.profiler), the
   graph's nodes, pool MiB and capture seconds.
6. Stream phase: from seed 42, the 10k scene written as an npz
   FeatureStore and the 1,048,576-row scene as a binary store (LoD 1 = its
   first 32,768 rows), both with a geotransform and an elevation raster;
   loaded through open_store → load_device_db / load_pruned_device_db
   (rows equal to those written, ECEF world points); then 60 frames (a
   pool of 8 seeded shifted 512² uint8 frames, cycled) through
   StreamingLocalizer: 10k at batch 1 and 8, 1M full DB at batch 8 and 4,
   1M pruned at batch 1 and 8. The back half (match, RANSAC, PnP) runs
   once a batch. Every frame must recover its shift within
   1 px, its features and matches must equal Localizer.localize's
   (localize_frame_pruned_jit's when pruned) on the same frame and DB, and
   its packed outputs too (or H within 0.01 px at the corners, equal ok
   flags and inlier Jaccard ≥ 0.95). Kernel A launches 15 times and
   kernel B twice per batch, kernel 4 once per batch on the full 1M DB
   from a graph captured at Q = B × 2,048, the Procrustes kernel once per
   batch. A batch's eager back half at batch 8 launches at most 1.25x the
   device kernels it launches at batch 1 (10k and pruned); the kernels of
   the back half's graph (its node count) and a step's host launches are
   printed beside them.
   Prints frames/s, ms per frame, latency p50/p95, the stage times,
   fallback frames, launches per batch, the device kernels of a batch's
   back half and of a step (per frame) of each run. Up to `prefetch`
   frames' steps are queued before a result is fetched.
7. Build phase (the offline DB build, slice 4): from seed 42 an 8192²
   image (bench_feature_extraction.py's synth_satellite terrain with
   bench.py's corner-rich rectangles over it) written as a three-band
   uint8 mosaic of 2×2 GeoTIFF members of 4096², with a seeded float32
   elevation raster; preprocess on MosaicDataset.from_folder(lazy=True)
   with the default PipelineConfig and tile_batch 8: 6 LoDs, 1,365 tiles
   of 256², kernel A 15 and kernel B 2 launches per tile batch. Prints
   the seconds, tiles/s, keypoints per LoD, launches per batch and peak
   device memory. Eight sample tiles over the LoDs: the card's gray tile
   through the port's CPU path gives the card's store rows bit for bit;
   their to_rgb, card against CPU, with the largest uint8 difference.
   The first batch of each LoD timed again splits the build's time into
   window reads, feature steps and host copies, with one step's
   device-busy time and kernel count.
   Then write_binary_store, a second run (a 1024² crop, one LoD)
   appended, its tile deleted, compact_binary_store: every LoD answers
   as the build. (The kernel phase also checks kernel A bit-exact at the
   build's 256² B = 8 and the tiled path's 1024² shapes, all 15 levels,
   and kernel B on 8 stacks of 256² at the build's capacity.)
8. Serve check: the finest LoD of the built store with at most 262,143
   rows through Localizer and the store-level localize_frame (kernel 4
   once per frame above 65,536 rows); a 512² frame read from the mosaic
   at that LoD's scale: H maps its corners to the crop's within 2^lod
   mosaic px, homography and pose (ECEF) ok.
9. Tiled phase: detect_and_compute_tiled on the 8192² synth_satellite
   terrain at capacity 262,143 (tile 1024, overlap 64: 81 tiles; kernel
   A 15 and kernel B 2 launches a tile) with the seam invariants (count,
   response order, coordinates in the image, no pair within 0.5 px and
   ≤ 1 level); a 2048² tiled run (9 tiles) equal to the port's CPU run
   bit for bit; the 128…8192 sweep (untiled to 2048, tiled above;
   capacity 4096; CUDA events around a synchronised loop).
10. Part A: detect_and_compute_batch under
   torch.cuda.set_sync_debug_mode("error") on the 512² frame and a build
   batch of 8 tiles of 256²; one main-path step and one stream batch of 8
   (its step, then its fetch) under "warn", their synchronising calls
   listed by file:line: 0 in the step and in the batch outside its fetch;
   which torch.linalg SVD routes synchronise (logged); the per-keypoint
   stages' device time at full capacity against the live prefix
   (bit-equal).
11. Accuracy phase (the mission metric, slice 5): utils/accuracy.run on
   the rects and natural textures (seed 2026, a 1024² mosaic at 1 m GSD,
   512² frames, focal 1500 px, altitude 1500 m, capacity 2048 exact,
   ratio 0.75, 256 homography and 128 PnP hypotheses; 7 conditions) and
   run_terrain (reliefs 20/60/120 m × nadir / oblique 20°) on the card.
   The one cut is the scene count: ACC_SCENES = 4 per condition (the
   reference runner: 12) and ACC_TERRAIN_SCENES = 3 per terrain cell
   (6). Gates (tests/test_accuracy.py's bounds on the medians): nominal
   attitude < 1.0°, position < 25 m, footprint < 3 m; oblique20 and rot45
   < 3° and < 60 m; every terrain cell < 1.5° and < 35 m; at 60 m relief
   the largest homography footprint error > 0.3 m; ok rate >= 0.75 in
   every cell. Kernel A 15 and kernel B 2 launches on every frame and in
   every DB build (its one 1024² LoD-0 tile). The first nominal scene of
   each texture through the port on the CPU: the same ok flags, rotation
   within 0.1°, homography-inlier Jaccard >= 0.95. Prints the table per
   condition, the seconds and frames/s.
12. Calibration phase (slice 6): 12 varied-pose 7×6 checkerboards
   rendered with warp_perspective through a known K and distortion (k1
   0.08); calibrate_from_images on the card: every view found, fx within
   2%, principal point within 3 px, k1 within 0.02, RMS < 0.2 px; the
   same views on the CPU give K within 1e-3 relative; the LM loop's steps
   run under set_sync_debug_mode("error"); undistort_frames on 8 frames
   of 512², card against CPU within 1e-5; each step's time.
13. Mesh phase (slice 7, one card: a mesh's slots all on cuda:0; it runs
   after the stream phase; slice 14 runs a dp row's work after feature
   extraction as CUDA graphs, one a key, in the mesh's cache): (a) the
   big DB's 1,048,576 rows, and a ragged 1,000,003-row cut of it padded
   to a tp multiple, against the frame's 2,048 queries through
   make_sharded_knn2_fused at tp = 2 and 4 (one graph a call: the shards'
   kernel-4 launches and their merge): kernel 4 launched once per shard,
   (d0, d1, i0) bit-equal to one launch over the whole DB and to the
   eager partials and merge, the graph's pool within 1.5x the eager
   call's peak + 64 MiB; ms per call graphed and eager beside one launch
   over the whole DB, and the eager merge's share; the dense maker on
   10,240 rows against ops.match.knn2; the tp = 4 call under
   set_sync_debug_mode("error"). (b) make_batch_localizer at dp 2 × tp 2
   on the stream's 8 pool frames against the big DB (a dp row's geometry
   as one batch): each row's packed outputs bit-equal to the
   single-device batch step on its 4 frames, every frame agreeing with
   the lone step as a stream frame must; launches of A, B and 4 per batch
   (30, 4, 4); the step bit-equal to its eager composition (each row's
   features, then `_row_back_half` called directly), the two rows
   replaying one back-half graph (three graph replays a row: front half,
   ladder, back half), its nodes and pool beside the eager row's peak
   (within 1.5x + 64 MiB), host launches eager and graphed, a warmed step
   under set_sync_debug_mode("error"); frames/s, and eager against
   graphed paired in one call (turns eager, graphed, graphed, eager).
   (c) StreamingLocalizer(mesh=dp 2 × tp 2) over
   the stream phase's 1M binary store at batch 8: every frame equal to the
   single-device stream's at batch 4 (a dp row); frames/s, latency
   p50/p95 in s and in steps, a step's idle share. (d) preprocess(mesh=dp
   2) on a 2048² crop of the build image, amount_lod 3: the store equal
   to the single-device build bit for bit.
   (e) two child processes share the card over gloo, two slots each, one
   global mesh of four: the sharded kNN-2 (dp 1 × tp 4) and the serve
   step (dp 2 × tp 2, 4 frames), split at the collectives (a graph of a
   process's partials and merge, the all_reduces, a geometry graph),
   give each the single-process results; a child that fails or outlasts
   300 s fails the phase. The phase ends with every cached pool's MiB
   (front, ladder, back, mesh) and drops the mesh's graphs.
14. Modes phase (slice 8): (a) bench.py's 512² frame through
   detect_and_compute in fast, hybrid (sub 2) and hybrid (sub 3): card
   against CPU bit for bit (keypoints, angles, descriptors); kernel A 15
   and B 4 launches a frame, every kernel-B launch (S = 57 fast
   orientation, one a grid at S = 4/9/16, 16/36/64, 36/81/144) bit-exact
   with its twin; the per-keypoint stages' device time against exact.
   (b) the 10k slice step in each mode against a DB of the port's own
   features in that mode: median of 10 steps, the (13, 7) shift, inlier
   Jaccard against exact. (c) accuracy.run on rects nominal and oblique20,
   4 scenes each, in fast and hybrid: tests/test_accuracy.py's bounds.
   (d) a store built in fast mode: check_descriptor_mode accepts fast and
   refuses exact, and the store serves a nominal frame.
11b. Ladder phase (slice 11, after the sync phase): the capacity
   ladder in exact, fast and hybrid modes on a sparse 512² frame at
   capacity 2048 (the first rung), bench.py's 512² frame at capacity 2048
   (a middle rung), the same frame at capacity 1024 (the last rung) and a
   build batch of 8 × 256² tiles at capacity 8192: the rung the device
   chose (read after the call) equals the host formula's; the features
   equal adaptive_buckets=1 bit for bit; a warmed call runs under
   set_sync_debug_mode("error"); a held result is unchanged by the next
   call of its key; kernel B 2 launches a step (4 in fast/hybrid) on its
   device counter (the profiler's events by kernel name are printed
   beside them), and against its twin at the rung's K; the graph's pool beside the eager all-slot
   stage's peak; the stage's device ms at capacity, at the rung and on
   the live prefix, the graph's call, its static copies and output
   clones. The build phase (7) runs the build four times, paired:
   adaptive_buckets=1, the ladder, the ladder, adaptive_buckets=1; the
   stores' rows equal bit for bit and the times are printed beside the
   card's name and power limit (a record, not a claim).
15. CLI phase (slice 9; cubesat_apds_tpu_torch.cli.main called in-process
   on cuda:0, its stdout parsed, the launch counters zeroed just before
   and read just after each call): (a) preprocess of the build image's
   2048² corner as 2×2 GeoTIFF members with a DEM, --binary --lod 3
   --tile-batch 8: the store equals the in-process preprocess +
   write_binary_store bit for bit, kernel A 15 and B 2 launches a tile
   batch; again with -c 2 --device cuda:0,cuda:0: the same rows, kernel A
   30 a batch. (b) localize of a 512² frame cut at (700, 900), saved as a
   PNG: H puts the offset within 1 px, the JSON equals
   Localizer.localize's bit for bit; --pruned (no fallback),
   --coarse-to-fine, --viz (a PNG), --profile (a trace holding both
   kernels). (c) 24 pool frames from the stream phase's 1M binary store
   (written again from seed 42), --batch 8 --mesh 2x2 over four slots of
   cuda:0: every line equal to the in-process mesh stream's, kernel 4
   four times a batch, a summary of 24 frames; --pruned --batch 8: no
   fallback. (d) match of bench.py's frame and its (7, 13) roll, plain
   and --crosscheck, -o: the counts on the card equal those under
   --device cpu. (e) calibrate of the 12 boards as PNGs: K within 1e-5 of
   calibrate_from_images; localize --camera takes the file. (f) store
   info, delete (the coarsest tile) and compact on a copy of (a): the
   counts add up, the frame's H unchanged. (g) bench.run(10, 3): its JSON
   line, a rate above 0 on the card. (h) `python -m
   cubesat_apds_tpu_torch.cli localize` in a process of its own: exit 0,
   the JSON of (b); its wall time.
16. Hooks phase (slice 15, after the mesh phase; graft_entry.py, the
   port of __graft_entry__.py): (a) entry() on the card (a random 512²
   frame, a 10,240-row DB, capacity 1,024): kernel A 15, B 2 and the
   Procrustes kernel 1 launch a warmed step, kernel 4 none; the step
   bit-equal to its eager composition (the front half eager, the
   ladder, the back half eager); its keypoint and match counts equal to
   the CPU hook's; host launches, frames/s (median of 10). (b) the dry
   run at n = 4 over four slots of cuda:0 (dp 2 × tp 2, 64² frames):
   JAX's assertions, each dp row of the serve step bit-equal to the
   single-device batch step, the sharded kNN-2 to the dense one, the
   tile batch to detect_and_compute_batch; its launches and seconds.

Prints a {"kernels": [...]} JSON line, then as its LAST line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check exits non-zero without that line. Needs a CUDA build of
PyTorch, nvcc and a GPU; imports nothing of JAX. --profile DIR writes a
torch.profiler table and Chrome trace of one warmed step of each path
(slice, big DB, pruned, stream at batch 1 and 8) to DIR, with each step's
device-busy time (per frame for the batch).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

SEED = 42
# Published peaks of one H100 SXM (NVIDIA H100 datasheet) and the
# POPC issue rate of compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput: 16 results per clock per SM) at the
# 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
INT8_OPS = 1.979e15
POPC_PER_CLOCK_PER_SM = 16
BOOST_HZ = 1.98e9
BIG_DB_ROWS = 1 << 20
STREAM_BATCH = 8
STREAM_FRAMES = 60
COARSE_ROWS = 32768
WINDOW_CAPACITY = 16384
CONTAINMENT_MIN = 0.9


def log(msg):
    print(msg, flush=True)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)
    log(f"  ok: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _median_event_ms(torch, run, per_run, rounds):
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / per_run)
    return float(np.median(times))


def cuda_ms(torch, fn, reps=20, rounds=5):
    """Median over `rounds` of the mean time of `reps` back-to-back calls,
    from CUDA events (ms per call): what an eager caller pays, the host's
    per-call cost included wherever it exceeds the device time."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    return _median_event_ms(torch, run, reps, rounds)


def graph_ms(torch, fn, reps=20, rounds=5):
    """Device time per call: `reps` calls captured in one CUDA graph, its
    replays timed with CUDA events, so the host's per-call cost (the
    wrapper's checks, ctypes) is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _median_event_ms(torch, graph.replay, reps, rounds)


def kernel_phase(torch, dev, k_path):
    from cubesat_apds_tpu_torch.core.config import AkazeConfig
    from cubesat_apds_tpu_torch.ops.features.scale_space import (
        evolution_metadata, fed_tau_by_process_time)
    from cubesat_apds_tpu_torch.ops.kernels import diffusion, sample_kernel

    rng = np.random.default_rng(SEED)
    cfg = AkazeConfig()
    meta = evolution_metadata(cfg)
    cases = []
    for i in range(1, len(meta)):
        n = 512 >> meta[i].octave
        taus = fed_tau_by_process_time(meta[i].etime - meta[i - 1].etime,
                                       cfg.fed_tau_max)
        cases.append((f"level{i}", n, n, taus, True))
    cases.append(("1024sq", 1024, 1024, fed_tau_by_process_time(7.0), False))
    cases.append(("ragged72x128", 72, 128, fed_tau_by_process_time(3.0),
                  False))

    log("kernel A (FED cycle) vs plain twin on the card (bit-exact), per "
        "case: the plan's form, cluster size, CTAs, then eager and device "
        "time, the byte bound, and the device time of the other forms:")
    a_err, a_ms, a_dev_ms, a_plain_ms = 0.0, 0.0, 0.0, 0.0
    a_bytes, a_flops = 0, 0
    for name, h, w, taus, on_path in cases:
        n = len(taus)
        L = torch.from_numpy(rng.uniform(0, 1, (h, w)).astype(np.float32)).to(dev)
        g = torch.from_numpy(rng.uniform(0.2, 1, (h, w)).astype(np.float32)).to(dev)
        plan = diffusion.fed_plan(h, w, n)
        info = diffusion.plan_info(plan)
        got = diffusion.fed_cycle_cuda(L, g, taus)
        ref = diffusion.fed_cycle(L, g, taus)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        check(torch.equal(got, ref), f"kernel A {name} bit-exact")
        check(info["max_active_clusters"] >= 1,
              f"kernel A {name}: the card holds a cluster of {plan.cluster}")
        ms = cuda_ms(torch, lambda: diffusion.fed_cycle_cuda(L, g, taus))
        dms = graph_ms(torch, lambda: diffusion.fed_cycle_cuda(L, g, taus))
        pms = cuda_ms(torch, lambda: diffusion.fed_cycle(L, g, taus))
        bound_us = 12 * h * w / HBM_BYTES_PER_S * 1e6
        alts = []
        for form, c in (("tiles", None), ("cluster", 8), ("cluster", 16)):
            try:
                alt = diffusion.fed_plan(h, w, n, form=form, cluster=c)
            except ValueError:
                continue
            if alt == plan:
                continue
            got = diffusion.fed_cycle_cuda(L, g, taus, plan=alt)
            check(torch.equal(got, ref),
                  f"kernel A {name} bit-exact as {form} {alt.cluster}")
            alt_ms = graph_ms(torch, lambda: diffusion.fed_cycle_cuda(
                L, g, taus, plan=alt))
            alts.append(f"{form} x{alt.cluster} {alt.tile_h}x{alt.tile_w} "
                        f"{alt.ctas} CTAs {alt_ms * 1e3:.2f} us")
        log(f"  {name:>13} {h}x{w} n={n:2d}: {plan.form} cluster={plan.cluster} "
            f"tile={plan.tile_h}x{plan.tile_w} ctas={plan.ctas} "
            f"threads={plan.threads} cells/thread={plan.cells_per_thread} "
            f"smem={plan.smem} B regs={info['registers']} "
            f"spill={info['spill_bytes']} B max_active_clusters="
            f"{info['max_active_clusters']}; eager={ms * 1e3:.2f} us "
            f"device={dms * 1e3:.2f} us bound={bound_us:.3f} us "
            f"plain={pms:.4f} ms max_abs_err={err:.1e}; other forms "
            f"(device): {'; '.join(alts) or 'none'}")
        a_err = max(a_err, err)
        if on_path:
            a_ms += ms
            a_dev_ms += dms
            a_plain_ms += pms
            # L and g read once, the result written once; per pixel 4
            # conductance sums, then 13 flops per explicit step.
            a_bytes += 12 * h * w
            a_flops += (4 + 13 * n) * h * w
    one = torch.ones((1, 1), dtype=torch.float32, device=dev)
    floor_ms = 15 * graph_ms(torch, lambda: diffusion.fed_cycle_cuda(
        one, one, np.ones(1, np.float32)), reps=15)
    log(f"kernel A, the frame's 15 cycles: eager {a_ms:.4f} ms, device "
        f"{a_dev_ms:.4f} ms; launch floor (15 one-pixel launches from a "
        f"CUDA graph) {floor_ms:.4f} ms")

    log("kernel B (patch sampler) vs plain twin on the card, at the main "
        f"path's K = {k_path} (the ladder's rung for bench.py's frame) and "
        "at the capacity's K = 2048:")
    b = {K: kernel_b_case(torch, dev, rng, K) for K in (k_path, 2048)}
    a_bound = max(a_bytes / HBM_BYTES_PER_S, a_flops / FP32_FLOPS) * 1e3
    log(f"bounds: kernel A {a_bound:.5f} ms ({a_bytes} B, {a_flops} flops "
        f"over the frame's 15 cycles); kernel B at S=109+441: " + "; ".join(
            f"K={K} {r['ms']:.4f} ms = {r['ms'] / r['library_ms']:.3f} x "
            f"index_select (device {r['device_ms']:.4f} ms = "
            f"{r['device_ms'] / r['library_device_ms']:.3f} x), bound "
            f"{r['bound_ms']:.5f} ms ({r['bytes']} B)" for K, r in b.items()))
    main = b[k_path]
    return [
        {"name": "fed_cycle", "route": "cuda",
         "source": "cubesat_apds_tpu_torch/csrc/fed_cycle.cu",
         "replaces": "cubesat_apds_tpu/ops/pallas/diffusion.py:46",
         "max_abs_err": a_err, "ms": a_ms, "device_ms": a_dev_ms,
         "launch_floor_ms": floor_ms, "plain_ms": a_plain_ms,
         "bound_ms": a_bound,
         "bound_by": ("bytes" if a_bytes / HBM_BYTES_PER_S
                      >= a_flops / FP32_FLOPS else "operations"),
         "library_ms": None},
        {"name": "sample_patches", "route": "cuda",
         "source": "cubesat_apds_tpu_torch/csrc/sample_patches.cu",
         "replaces": "cubesat_apds_tpu/ops/pallas/sample_kernel.py:44",
         "max_abs_err": max(r["max_abs_err"] for r in b.values()),
         "K": k_path, "ms": main["ms"], "device_ms": main["device_ms"],
         "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
         "bound_by": "bytes", "library_ms": main["library_ms"],
         "library_device_ms": main["library_device_ms"],
         "at_capacity": dict(b[2048], K=2048, bound_by="bytes")},
    ]


def kernel_b_case(torch, dev, rng, K):
    """Kernel B against its twin on a 16-level 512² stack at K keypoints,
    S = 109 and 441 at the main path's reach (±29) and S = 441 at ±45:
    bit-exact; eager, device, twin and index_select times and the byte
    bound summed over the main path's two launches (S = 109 + 441)."""
    from cubesat_apds_tpu_torch.ops.kernels import sample_kernel

    L, H, W = 16, 512, 512
    stack = torch.from_numpy(
        rng.standard_normal((L, H, W, 4)).astype(np.float32)).to(dev)
    stack[..., 3] = 0
    stack = stack.to(torch.bfloat16)
    level_hw = torch.tensor([[H >> (i // 4), W >> (i // 4)] for i in range(L)],
                            dtype=torch.int32, device=dev)
    hw = level_hw.cpu().numpy()
    lvl_np = rng.integers(0, L, K).astype(np.int32)
    cx_np = np.array([rng.integers(0, w) for w in hw[lvl_np, 1]], np.int32)
    cy_np = np.array([rng.integers(0, h) for h in hw[lvl_np, 0]], np.int32)
    lvl = torch.from_numpy(lvl_np).to(dev)
    out = dict(max_abs_err=0.0, bytes=0, ms=0.0, device_ms=0.0,
               plain_ms=0.0, library_ms=0.0, library_device_ms=0.0)
    for S, reach in ((109, 29), (441, 29), (441, 45)):
        iy = torch.from_numpy((cy_np[:, None] + rng.integers(
            -reach, reach + 1, (K, S))).astype(np.int32)).to(dev)
        ix = torch.from_numpy((cx_np[:, None] + rng.integers(
            -reach, reach + 1, (K, S))).astype(np.int32)).to(dev)
        got = sample_kernel.sample_patches_cuda(stack, level_hw, lvl, iy, ix)
        ref = sample_kernel.sample_patches_plain(stack, level_hw, lvl.long(),
                                                 iy, ix)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ms = cuda_ms(torch, lambda: sample_kernel.sample_patches_cuda(
            stack, level_hw, lvl, iy, ix))
        dms = graph_ms(torch, lambda: sample_kernel.sample_patches_cuda(
            stack, level_hw, lvl, iy, ix))
        pms = cuda_ms(torch, lambda: sample_kernel.sample_patches_plain(
            stack, level_hw, lvl.long(), iy, ix))
        log(f"  K={K} S={S} reach=±{reach}: bit_exact={torch.equal(got, ref)} "
            f"kernel={ms:.4f} ms (device {dms:.4f}) plain={pms:.4f} ms")
        check(torch.equal(got, ref), f"kernel B K={K} S={S} ±{reach} bit-exact")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if reach == 29:            # the main path's sample reach
            # The library yardstick: one index_select of the flat stack at
            # the twin's clamped linear indices (made outside the timing).
            hs = level_hw[lvl.long(), 0][:, None].clamp(1, H)
            ws = level_hw[lvl.long(), 1][:, None].clamp(1, W)
            lin = ((lvl.long()[:, None] * H + torch.minimum(iy.clamp(min=0),
                                                           hs - 1)) * W
                   + torch.minimum(ix.clamp(min=0), ws - 1)).reshape(-1)
            flat = stack.reshape(L * H * W, 4)
            lms = cuda_ms(torch, lambda: torch.index_select(flat, 0, lin))
            dlms = graph_ms(torch, lambda: torch.index_select(flat, 0, lin))
            log(f"    library index_select of the same samples: {lms:.4f} ms "
                f"(device {dlms:.4f}); kernel / index_select = "
                f"{ms / lms:.3f} (device {dms / dlms:.3f})")
            out["ms"] += ms
            out["device_ms"] += dms
            out["plain_ms"] += pms
            out["library_ms"] += lms
            out["library_device_ms"] += dlms
            # Per sample: iy and ix read, one 8-byte texel read, 16 bytes
            # written.
            out["bytes"] += K * S * 32
    out["bound_ms"] = out["bytes"] / HBM_BYTES_PER_S * 1e3
    return out


def batch_kernel_phase(torch, dev, batch=STREAM_BATCH):
    """Kernels A and B on a frame batch, as detect_and_compute_batch
    launches them: kernel A once per level for B images (gridDim.z = B),
    bit-exact per image against the twin, with its plan and device time
    per image; kernel B once on B stacks folded into its stack axis,
    bit-exact per stack. Returns each kernel's device ms per frame."""
    from cubesat_apds_tpu_torch.core.config import AkazeConfig
    from cubesat_apds_tpu_torch.ops.features.scale_space import (
        evolution_metadata, fed_tau_by_process_time)
    from cubesat_apds_tpu_torch.ops.kernels import diffusion, sample_kernel

    rng = np.random.default_rng(SEED + 2)
    cfg = AkazeConfig()
    meta = evolution_metadata(cfg)
    log(f"kernel A on a batch of {batch} images (one launch per level), "
        f"bit-exact per image against the twin; device us per image:")
    a_us = 0.0
    for i in range(1, len(meta)):
        n = 512 >> meta[i].octave
        taus = fed_tau_by_process_time(meta[i].etime - meta[i - 1].etime,
                                       cfg.fed_tau_max)
        L = torch.from_numpy(rng.uniform(0, 1, (batch, n, n)).astype(
            np.float32)).to(dev)
        g = torch.from_numpy(rng.uniform(0.2, 1, (batch, n, n)).astype(
            np.float32)).to(dev)
        plan = diffusion.fed_plan(n, n, len(taus), batch=batch)
        got = diffusion.fed_cycle_cuda(L, g, taus)
        same = all(torch.equal(got[b], diffusion.fed_cycle(L[b], g[b], taus))
                   for b in range(batch))
        check(same, f"kernel A level {i} at B={batch} bit-exact per image")
        us = graph_ms(torch, lambda: diffusion.fed_cycle_cuda(L, g, taus)) \
            * 1e3 / batch
        a_us += us
        log(f"  level{i:>2} {n}x{n} n={len(taus):2d}: {plan.form} "
            f"cluster={plan.cluster} tile={plan.tile_h}x{plan.tile_w} "
            f"ctas={plan.ctas} cells/thread={plan.cells_per_thread}; "
            f"device {us:.3f} us per image")
    log(f"kernel A, a frame's 15 cycles at B={batch}: {a_us / 1e3:.4f} ms "
        f"of device time per frame")

    L, H, W, K = 16, 512, 512, 2048
    stacks = torch.from_numpy(rng.standard_normal(
        (batch, L, H, W, 4)).astype(np.float32)).to(dev)
    stacks[..., 3] = 0
    stacks = stacks.to(torch.bfloat16)
    level_hw = torch.tensor([[H >> (i // 4), W >> (i // 4)] for i in range(L)],
                            dtype=torch.int32, device=dev)
    lvl = torch.from_numpy(rng.integers(0, L, (batch, K))).to(dev)
    b_ms = 0.0
    for S in (109, 441):
        iy = torch.from_numpy(rng.integers(0, H, (batch * K, S)).astype(
            np.int32)).to(dev)
        ix = torch.from_numpy(rng.integers(0, W, (batch * K, S)).astype(
            np.int32)).to(dev)
        fn = sample_kernel.patch_sampler(stacks, level_hw, lvl)
        got = fn(iy, ix)
        same = all(torch.equal(
            got[b * K:(b + 1) * K], sample_kernel.sample_patches_plain(
                stacks[b], level_hw, lvl[b], iy[b * K:(b + 1) * K],
                ix[b * K:(b + 1) * K])) for b in range(batch))
        check(same, f"kernel B on {batch} stacks, S={S}, bit-exact per stack")
        ms = graph_ms(torch, lambda: fn(iy, ix)) / batch
        b_ms += ms
        log(f"  kernel B, B={batch} x K={K} x S={S} in one launch: device "
            f"{ms * 1e3:.3f} us per frame")
    return a_us / 1e3, b_ms


def knn_phase(torch, dev, Q=2048, m_main=BIG_DB_ROWS, m_rag=1_000_003):
    """Kernel 4 against its twin (knn2_blockwise, 64k-row blocks) on the
    card, bit-exact, at the big-DB step's shape (Q queries against m_main
    rows) and on two edge cases."""
    from cubesat_apds_tpu_torch.ops import match as tmatch
    from cubesat_apds_tpu_torch.ops.kernels import match_kernel as tmk

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    block = 65536
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def rand_bytes(n):
        return torch.randint(0, 256, (n, 61), generator=gen, device=dev,
                             dtype=torch.uint8)

    q = rand_bytes(Q)
    # Near hits for half the queries (a few bits flipped), so d0 spans the
    # range real matches give.
    def with_near_hits(db):
        rows = torch.randint(0, db.shape[0], (Q // 2,), generator=gen,
                             device=dev)
        noise = rand_bytes(Q // 2) & rand_bytes(Q // 2) & rand_bytes(Q // 2)
        db[rows] = q[:Q // 2] ^ noise
        return db

    db_main = with_near_hits(rand_bytes(m_main))
    db_rag = with_near_hits(rand_bytes(m_rag))
    valid_rag = torch.rand(m_rag, generator=gen, device=dev) >= 0.05
    db_tie = rand_bytes(m_main)
    _, _, chunk = tmk.split_plan(Q, m_main, sms)
    edges = [chunk, 2 * chunk, 7 * chunk, block, 3 * block, m_main - 1]
    for j, e in enumerate(edges):
        db_tie[[e - 1, e]] = q[j]            # an exact tie across the edge
    db_tie[[100, 5 * chunk + 3, m_main - 5]] = q[len(edges)]
    cases = [(f"Q={Q} M={m_main}", db_main, None),
             (f"ragged M={m_rag}, ~5% invalid", db_rag, valid_rag),
             ("ties across chunk/block edges", db_tie, None)]

    log(f"kernel 4 (Hamming kNN-2) vs plain twin on the card "
        f"(chunk {chunk} rows, {sms} SMs):")
    qw = tmk.pack_words(q)
    qb = tmatch.unpack_bits(q)
    err, ms, dms, pms = 0.0, None, None, None
    for name, db, valid in cases:
        layout = tmk.layout_db_blocks(tmk.pack_words(db), valid)
        got = tmk.knn2_hamming_cuda(qw, *layout)
        ref = tmatch.knn2_blockwise(qb, db, block, valid)
        torch.cuda.synchronize()
        exact = [torch.equal(g, r) for g, r in zip(got, ref)]
        e = max(float((got[0] - ref[0]).abs().max()),
                float((got[1] - ref[1]).abs().max()))
        log(f"  {name}: d0/d1/i0 bit_exact={exact} max_abs_err={e:.3e} "
            f"d0 range [{float(got[0].min()):.0f}, "
            f"{float(got[0][got[0] < 1e30].max()):.0f}]")
        check(all(exact), f"kernel 4 {name} bit-exact on d0, d1, i0")
        err = max(err, e)
        if valid is not None:
            ok = valid[got[2].long()] | (got[0] > 1e30)
            check(bool(ok.all()), "kernel 4 winners are valid rows")
        if db is db_tie:
            i0 = got[2][:len(edges) + 1].tolist()
            check(i0 == [e - 1 for e in edges] + [100]
                  and bool((got[1][:len(edges) + 1] == 0).all()),
                  "kernel 4 ties: lowest index wins, the duplicate is d1")
        if db is db_main:
            ms = cuda_ms(torch, lambda: tmk.knn2_hamming_cuda(qw, *layout),
                         reps=5, rounds=5)
            dms = graph_ms(torch, lambda: tmk.knn2_hamming_cuda(qw, *layout),
                           reps=5, rounds=5)
            pms = cuda_ms(torch, lambda: tmatch.knn2_blockwise(
                qb, db, block, valid), reps=1, rounds=3)
    ops = 2 * Q * m_main * 512           # as an int8 product on unpacked bits
    nbytes = m_main * (64 + 4) + Q * 64 + Q * 12
    bound = max(ops / INT8_OPS, nbytes / HBM_BYTES_PER_S) * 1e3
    popc_bound = (Q * m_main * 16
                  / (POPC_PER_CLOCK_PER_SM * sms * BOOST_HZ)) * 1e3
    mm_ms = int8_product_ms(torch, qb, db_main, block)
    log(f"  Q={Q} x M={m_main}: kernel={ms:.4f} ms (device {dms:.4f}) "
        f"plain={pms:.4f} ms; "
        f"bound {bound:.4f} ms (int8 tensor-core ops; bytes alone "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms), AND+POPC form bound "
        f"{popc_bound:.4f} ms; int8 product alone (torch._int_mm, "
        f"{block}-row blocks) {mm_ms:.4f} ms")
    log_knn_build()
    return {"name": "knn2_hamming", "route": "cuda",
            "source": "cubesat_apds_tpu_torch/csrc/knn2_hamming.cu",
            "replaces": "cubesat_apds_tpu/ops/pallas/match_kernel.py:130",
            "max_abs_err": err, "ms": ms, "device_ms": dms, "plain_ms": pms,
            "bound_ms": bound, "bound_by": "operations", "library_ms": None,
            "popc_bound_ms": popc_bound, "int8_product_ms": mm_ms}


def knn_batch_phase(torch, dev, Q=STREAM_BATCH * 2048, m=BIG_DB_ROWS):
    """Kernel 4 at the batch step's shape: a batch of 8 frames' 8 × 2,048
    queries against 1,048,576 rows (~5% invalid) in one launch, as the
    batched back half runs it, bit-exact on d0, d1 and i0 against its twin
    (knn2_blockwise, 64k-row blocks); eager and device ms beside the
    twin's, and the bound 2·Q·M·512 int8 ops at the tensor-core peak."""
    from cubesat_apds_tpu_torch.ops import match as tmatch
    from cubesat_apds_tpu_torch.ops.kernels import match_kernel as tmk

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    block = 65536
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def rand_bytes(n):
        return torch.randint(0, 256, (n, 61), generator=gen, device=dev,
                             dtype=torch.uint8)

    q = rand_bytes(Q)
    db = rand_bytes(m)
    rows = torch.randint(0, m, (Q // 2,), generator=gen, device=dev)
    db[rows] = q[:Q // 2] ^ (rand_bytes(Q // 2) & rand_bytes(Q // 2)
                             & rand_bytes(Q // 2))
    valid = torch.rand(m, generator=gen, device=dev) >= 0.05
    layout = tmk.layout_db_blocks(tmk.pack_words(db), valid)
    qw = tmk.pack_words(q)
    qb = tmatch.unpack_bits(q)
    nqb, n_split, chunk = tmk.split_plan(Q, m, sms)
    got = tmk.knn2_hamming_cuda(qw, *layout)
    ref = tmatch.knn2_blockwise(qb, db, block, valid)
    torch.cuda.synchronize()
    exact = [torch.equal(g, r) for g, r in zip(got, ref)]
    err = max(float((got[0] - ref[0]).abs().max()),
              float((got[1] - ref[1]).abs().max()))
    log(f"kernel 4 at the batch step's shape Q={Q} (batch {STREAM_BATCH} x "
        f"{Q // STREAM_BATCH}) x M={m}, ~5% invalid: split plan {nqb} query "
        f"blocks x "
        f"{n_split} chunks of {chunk} rows; d0/d1/i0 bit_exact={exact} "
        f"max_abs_err={err:.3e}")
    check(all(exact), f"kernel 4 at Q={Q} x M={m} bit-exact on d0, d1, i0")
    check(bool((valid[got[2].long()] | (got[0] > 1e30)).all()),
          f"kernel 4 at Q={Q}: winners are valid rows")
    del ref
    ms = cuda_ms(torch, lambda: tmk.knn2_hamming_cuda(qw, *layout),
                 reps=3, rounds=5)
    dms = graph_ms(torch, lambda: tmk.knn2_hamming_cuda(qw, *layout),
                   reps=3, rounds=5)
    pms = cuda_ms(torch, lambda: tmatch.knn2_blockwise(qb, db, block, valid),
                  reps=1, rounds=2)
    ops = 2 * Q * m * 512
    nbytes = m * (64 + 4) + Q * 64 + Q * 12
    bound = max(ops / INT8_OPS, nbytes / HBM_BYTES_PER_S) * 1e3
    log(f"  Q={Q} x M={m}: kernel={ms:.4f} ms (device {dms:.4f}) "
        f"plain={pms:.4f} ms; bound {bound:.4f} ms (int8 tensor-core ops; "
        f"bytes alone {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    return {"Q": Q, "M": m, "ms": ms, "device_ms": dms, "plain_ms": pms,
            "bound_ms": bound, "max_abs_err": err, "library_ms": None}


def int8_product_ms(torch, q_bits, db_packed, block):
    """Reference, not a kNN-2: torch._int_mm of the unpacked int8 query
    bits [Q, 512] against the unpacked DB in `block`-row blocks (the
    products alone, no top-2). Unpacked outside the timing."""
    from cubesat_apds_tpu_torch.ops import match as tmatch

    db_bits = tmatch.unpack_bits(db_packed)
    blocks = [db_bits[s:s + block].t() for s in range(0, len(db_bits), block)]

    def products():
        for b in blocks:
            torch._int_mm(q_bits, b)

    return cuda_ms(torch, products, reps=3, rounds=5)


def log_knn_build():
    """Kernel 4's launch shape as compiled, and the tensor-core
    instructions in its SASS where cuobjdump is at hand."""
    import os
    import shutil

    from cubesat_apds_tpu_torch.ops.kernels import build
    from cubesat_apds_tpu_torch.ops.kernels import match_kernel as tmk

    info = tmk.kernel_info()
    log(f"  kernel 4 chunk kernel: tile {info['queries_per_block']} queries "
        f"x {info['rows_per_tile']} DB rows x 512 bits, {info['threads']} "
        f"threads, {info['smem_bytes']} B shared memory per block "
        f"({info['stages']} stages), {info['registers']} registers/thread, "
        f"{info['spill_bytes']} B spilled, {info['blocks_per_sm']} blocks "
        f"per SM")
    check(info["blocks_per_sm"] >= 1 and info["smem_bytes"] == tmk.SMEM_BYTES
          and info["rows_per_tile"] == tmk.ROWS_PER_TILE
          and info["queries_per_block"] == tmk.QUERIES_PER_BLOCK,
          "kernel 4's compiled shape matches its wrapper's plan")
    tool = shutil.which("cuobjdump") or shutil.which(
        "cuobjdump", path=os.path.dirname(build.find_nvcc()))
    if tool is None:
        log("  cuobjdump: absent, tensor-core instructions not counted")
        return
    out = subprocess.run([tool, "-sass", str(build.load_kernels().path)],
                         capture_output=True, text=True, timeout=120)
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn and "knn2_partial" in fn:
            for op in line.replace(";", " ").split():
                if "MMA" in op:
                    counts[op] = counts.get(op, 0) + 1
    log(f"  cuobjdump -sass: tensor-core instructions in knn2_partial_kernel: "
        f"{counts or 'none'} (rc {out.returncode})")


# The Procrustes kernel (csrc/procrustes3.cu): its one-sided Jacobi
# SVD in float64, counted per matrix for the bound. A pair's sums take 18
# flops and its rotation 10 (zeta, t, c, s) plus 36 (two 3×2 column
# updates of A and V); a skipped pair takes the sums and the test (4). The
# tail (singular values, u1, u2, the two cross products, R) takes 110.
PROC_PAIR_SUMS, PROC_PAIR_TEST, PROC_PAIR_ROT, PROC_TAIL = 18, 4, 46, 110
PROC_SWEEPS = 8
FP64_FLOPS = 34e12      # H100 SXM FP64 outside the tensor cores (datasheet)


def procrustes_flops(S):
    """Flops the kernel does on `S` [N, 3, 3] (float32, host numpy): its
    sweeps replayed in float64 on the host, counting the pairs it rotates
    and the pairs it skips as converged (a non-finite S returns NaN at
    once and does none)."""
    a = S[np.isfinite(S).all((1, 2))].astype(np.float64)
    rot = np.zeros(len(a), np.int64)
    for _ in range(PROC_SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            al = (a[:, :, p] ** 2).sum(-1)
            be = (a[:, :, q] ** 2).sum(-1)
            ga = (a[:, :, p] * a[:, :, q]).sum(-1)
            go = ~(np.abs(ga) <= 2.220446049250313e-16 * np.sqrt(al * be))
            z = np.where(go, (be - al) / np.where(go, 2 * ga, 1.0), 0.0)
            t = np.where(go, np.copysign(1.0, z)
                         / (np.abs(z) + np.sqrt(1 + z * z)), 0.0)
            c = 1 / np.sqrt(1 + t * t)
            sn = c * t
            ap, aq = a[:, :, p].copy(), a[:, :, q].copy()
            a[:, :, p] = c[:, None] * ap - sn[:, None] * aq
            a[:, :, q] = sn[:, None] * ap + c[:, None] * aq
            rot += go
    n_pairs = 3 * PROC_SWEEPS * len(a)
    return int(n_pairs * (PROC_PAIR_SUMS + PROC_PAIR_TEST)
               + rot.sum() * PROC_PAIR_ROT + PROC_TAIL * len(a))


def _rotations(rng, n):
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], 1)


def procrustes_cases(rng):
    """Seeded float32 [N, 3, 3] cases: random over twelve decades of
    scale, near-singular (s3 ~ 1e-7 s1), reflections (det S < 0, distinct
    singular values), exact rank 2 and the zero matrix."""
    U, V = _rotations(rng, 4096), _rotations(rng, 4096)
    s = np.sort(rng.uniform(0.2, 1.0, (4096, 3)), axis=1)[:, ::-1]
    near, rank2 = s.copy(), s.copy()
    near[:, 2] = 1e-7 * rng.uniform(size=4096)
    rank2[:, 2] = 0.0

    def make(sv, Ua):
        return np.einsum("nij,nj,nkj->nik", Ua, sv, V).astype(np.float32)

    scale = 10.0 ** rng.uniform(-6, 6, (4096, 1, 1))
    return [("seeded random", (rng.standard_normal((4096, 3, 3)) * scale)
             .astype(np.float32)),
            ("near-singular", make(near, U)),
            ("reflection", make(s, U @ np.diag([1.0, 1.0, -1.0]))),
            ("rank 2", make(rank2, U)),
            ("zero", np.zeros((1, 3, 3), np.float32))]


def procrustes_phase(torch, dev, path_S, launches):
    """The Procrustes kernel against its plain twin on the card: on the
    slice's refit matrices (the main path's inputs) and the seeded cases,
    R within 1e-6 of the twin evaluated in float64 (the kernel's own
    precision; against the float32 twin, the path's CPU form, the
    difference is printed); NaN for a non-finite S. Times at the path's
    shape: eager, device (graph replays), the twin, torch.linalg.svd
    alone (the library's nearest call: the factors, not R), and the bound
    from the flops the kernel does on these inputs at the FP64 peak, or
    its bytes at HBM speed."""
    from cubesat_apds_tpu_torch.ops.kernels import procrustes as tproc

    rng = np.random.default_rng(SEED + 11)
    cases = [("the 10k slice's refit", path_S.cpu().numpy())] \
        + procrustes_cases(rng)
    log("Procrustes kernel vs plain twin on the card (R, max abs error "
        "against the twin in float64 / in float32, over the finite S; a "
        "non-finite S must give NaN in both):")

    def diff(R, want):
        nan = R.isnan()
        return bool(torch.equal(nan, want.isnan())), float(
            (R - want).abs().masked_fill(nan, 0.0).max())

    err = 0.0
    for label, S in cases:
        St = torch.from_numpy(S).to(dev)
        R = tproc.procrustes_rotation_cuda(St)
        nan64, e64 = diff(R, tproc.procrustes_rotation_plain(
            St.double()).float())
        nan32, e32 = diff(R, tproc.procrustes_rotation_plain(St))
        n_nan = int(R.isnan().flatten(-2).all(-1).sum())
        log(f"  {label} ({len(S)} matrices, {n_nan} non-finite): "
            f"{e64:.3e} / {e32:.3e}")
        check(nan64 and nan32 and e64 <= 1e-6,
              f"Procrustes kernel {label}: R within 1e-6 of the twin "
              "(float64), NaN where the twin's is")
        err = max(err, e64)
    S = torch.eye(3, device=dev).repeat(2, 1, 1)
    S[1, 0, 1] = float("nan")
    R = tproc.procrustes_rotation_cuda(S)
    check(torch.equal(R[0], S[0]) and bool(R[1].isnan().all()),
          "Procrustes kernel: S = I gives I, a non-finite S gives NaN")
    n = len(path_S)
    ms = cuda_ms(torch, lambda: tproc.procrustes_rotation_cuda(path_S))
    dms = graph_ms(torch, lambda: tproc.procrustes_rotation_cuda(path_S))
    pms = cuda_ms(torch, lambda: tproc.procrustes_rotation_plain(path_S))
    lms = cuda_ms(torch, lambda: torch.linalg.svd(path_S))
    flops = procrustes_flops(path_S.cpu().numpy())
    nbytes = 2 * 36 * n
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP64_FLOPS \
        else "operations"
    bound = max(nbytes / HBM_BYTES_PER_S, flops / FP64_FLOPS) * 1e3
    log(f"  at the path's {n} matrices: kernel {ms:.4f} ms (device "
        f"{dms:.4f}), twin {pms:.4f} ms, torch.linalg.svd alone {lms:.4f} "
        f"ms; bound {bound:.3e} ms ({flops} FP64 flops, {nbytes} B; by "
        f"{by})")
    return {"name": "procrustes3", "route": "cuda",
            "source": "cubesat_apds_tpu_torch/csrc/procrustes3.cu",
            "replaces": "cubesat_apds_tpu/ops/geometry/epnp.py:112",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "device_ms": dms, "plain_ms": pms, "bound_ms": bound,
            "bound_by": by, "library_ms": lms, "matrices": n}


def graph_pair_phase(torch, dev, loc10k, loc_big, frame_t):
    """Paired runs in one call of the serving step in three legs: "eager"
    (the front half `_front_end` and the back half
    `localize_from_features` eager, the functions the graphs capture),
    "back" (the front half eager, the back half graphed: the step as it
    stood before the front half had its graph) and "both" (the front and
    the back half graphed: the step as the entry points run it). The 10k
    slice at B = 1 and 8 runs all three legs in turns eager, back, both,
    both, back, eager; the 1M DB at B = 8 the first two, in turns eager,
    back, back, eager. Each turn is the median of 6 synchronised steps on
    the host clock. The front half's graph of B = 8 is held to the eager
    front end first. Prints frames/s, host launches a step, the back
    graph's nodes, pool MiB and capture seconds, beside the card."""
    from cubesat_apds_tpu_torch.ops.features.akaze import (
        detect_and_compute, detect_and_compute_batch)
    from cubesat_apds_tpu_torch.pipelines import step_graph
    from cubesat_apds_tpu_torch.pipelines.localize import (
        back_half, localize_from_features)

    config = serving_config()
    lone = frame_t.to(dev)
    batch = torch.stack([torch.roll(lone, (k, 2 * k), (0, 1))
                         for k in range(STREAM_BATCH)])
    front_b8 = front_against_eager(
        torch, f"paired 512² B = {STREAM_BATCH}", batch, config.akaze)
    cases = [("10k slice, B = 1", loc10k, lone, 1, True),
             (f"10k slice, B = {STREAM_BATCH}", loc10k, batch,
              STREAM_BATCH, True),
             (f"1M DB, B = {STREAM_BATCH}", loc_big, batch, STREAM_BATCH,
              False)]
    out = {}
    for label, loc, x, b, third in cases:
        def front(x=x, b=b):
            return (detect_and_compute(x, config.akaze) if b == 1 else
                    detect_and_compute_batch(x, config.akaze))

        steps = {
            "eager": lambda loc=loc, x=x: localize_from_features(
                eager_features(torch, x, config.akaze), loc.db, loc.camera,
                config, True),
            "back": lambda loc=loc, x=x: back_half(
                eager_features(torch, x, config.akaze), loc.db, loc.camera,
                config, True)}
        if third:
            steps["both"] = lambda loc=loc, front=front: back_half(
                front(), loc.db, loc.camera, config, True)
        steps["back"]()
        entry = step_graph.step_graphs()[-1]
        turns = list(steps) + list(steps)[::-1]
        secs = {m: [] for m in steps}
        for mode in turns:
            steps[mode]()
            torch.cuda.synchronize()
            t = []
            for _ in range(6):
                t0 = time.perf_counter()
                steps[mode]()
                torch.cuda.synchronize()
                t.append(time.perf_counter() - t0)
            secs[mode].append(float(np.median(t)))
        host = {m: host_launches(torch, steps[m]) for m in steps}
        fps = {m: [b / v for v in secs[m]] for m in secs}
        r = {"frames_per_s": fps, "host_launches": host,
             "graph_nodes": entry.nodes,
             "pool_mib": entry.pool_bytes / 2 ** 20,
             "capture_s": entry.capture_s, "warmup_s": entry.warmup_s}
        log(f"paired {label}, {card_line()}: frames/s "
            + ", ".join(f"{m} {fps[m]}" for m in fps)
            + f" (turns {', '.join(turns)}); host launches a step {host}; "
            f"the back half's graph {entry.nodes}, pool "
            f"{r['pool_mib']:.1f} MiB, warm-up {entry.warmup_s:.3f} s, "
            f"capture {entry.capture_s:.3f} s")
        out[label] = r
    out[f"10k slice, B = {STREAM_BATCH}"]["front"] = front_b8
    return out


def inlier_pairs(res):
    """Homography inliers as (query x, query y, train index) rows."""
    kp = res.keypoints.xy.cpu().numpy()
    m = res.matches
    inl = res.homography.inliers.cpu().numpy()
    q = m.query_idx.cpu().numpy()[inl]
    t = m.train_idx.cpu().numpy()[inl]
    return np.concatenate([kp[q], t[:, None].astype(np.float64)], axis=1)


def inlier_jaccard(a, b, tol=1e-2):
    """Jaccard of two inlier sets, pairing rows with the same train index
    and query positions within `tol` px."""
    if len(a) == 0 and len(b) == 0:
        return 1.0
    if len(a) == 0 or len(b) == 0:
        return 0.0
    same = (np.abs(a[:, None, :2] - b[None, :, :2]).max(-1) <= tol) \
        & (a[:, None, 2] == b[None, :, 2])
    hits = int(same.any(1).sum())
    return hits / (len(a) + len(b) - hits)


def rotation_deg(rv_a, rv_b):
    from cubesat_apds_tpu_torch.ops.geometry.rodrigues import (
        rodrigues_to_matrix)
    import torch

    Ra = rodrigues_to_matrix(torch.as_tensor(rv_a, dtype=torch.float64))
    Rb = rodrigues_to_matrix(torch.as_tensor(rv_b, dtype=torch.float64))
    c = (torch.trace(Ra.T @ Rb) - 1.0) / 2.0
    return float(torch.rad2deg(torch.arccos(c.clamp(-1.0, 1.0))))


def graph_against_eager(torch, label, graphed, eager):
    """The serving step's back half through its CUDA graph (`graphed()`,
    pipelines/step_graph.py) against the eager back half that the graph
    captures (`eager()`) on the same features: every output tensor bit
    for bit. Prints the key's graph: its nodes, pool and seconds."""
    from cubesat_apds_tpu_torch.pipelines import step_graph

    got = graphed()
    entry = step_graph.step_graphs()[-1]          # the key just used
    want = eager()
    torch.cuda.synchronize()
    lg, lw = step_graph.leaves(got), step_graph.leaves(want)
    same = [torch.equal(a, b) for a, b in zip(lg, lw)]
    graph_ms = cuda_ms(torch, graphed, reps=5, rounds=3)
    eager_ms = cuda_ms(torch, eager, reps=2, rounds=3)
    log(f"{label}: graphed back half against the eager back half on the "
        f"same features: {sum(same)} of {len(lw)} output tensors bit-equal; "
        f"the graph: {entry.nodes} nodes, pool "
        f"{entry.pool_bytes / 2 ** 20:.1f} MiB, warm-up "
        f"{entry.warmup_s:.3f} s, capture {entry.capture_s:.3f} s; back "
        f"to back (CUDA events) {graph_ms:.2f} ms a graphed call (copies, "
        f"replay, clones) against {eager_ms:.2f} ms eager")
    check(len(lg) == len(lw) and all(same),
          f"{label}: the graphed back half equals the eager back half bit "
          "for bit")
    return {"nodes": entry.nodes, "pool_mib": entry.pool_bytes / 2 ** 20,
            "warmup_s": entry.warmup_s, "capture_s": entry.capture_s,
            "graph_ms": graph_ms, "eager_ms": eager_ms}


def eager_features(torch, x, config):
    """detect_and_compute(_batch)'s features with the front half eager:
    `_front_end` called directly (the function the front half's graph
    captures), then the ladder as on the path. `x` [H, W] or [B, H, W]
    on the card."""
    import dataclasses

    from cubesat_apds_tpu_torch.core.types import Features, select
    from cubesat_apds_tpu_torch.ops.features.akaze import (
        _front_end, adaptive_orient_describe)

    xb = x[None] if x.dim() == 2 else x
    kps, packed, level_hw, grids = _front_end(xb, config, config.capacity,
                                              None)
    angle, desc = adaptive_orient_describe(kps, packed, level_hw, config,
                                           grids)
    f = Features(keypoints=dataclasses.replace(kps, angle=angle),
                 descriptors=desc)
    return select(f, 0) if x.dim() == 2 else f


def front_against_eager(torch, label, x, config, capacity=None,
                        kcontrast=None):
    """The front half through its CUDA graph at the key of (`x` [B, H, W]
    on the card, `config`, `capacity`, `kcontrast`), as
    detect_and_compute_batch calls it, against the eager `_front_end` on
    the same frames: every output tensor bit for bit. The graph's pool is
    held to at most 1.5x the eager front end's own peak (the
    max_memory_allocated delta of one eager call at the key) plus 64 MiB.
    Prints the key's graph: its nodes, pool, the eager peak and seconds."""
    from cubesat_apds_tpu_torch.core import step_graph as core_graph
    from cubesat_apds_tpu_torch.ops.features import akaze

    args = (x, config, capacity or config.capacity, kcontrast)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    want = akaze._front_end(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    got = akaze.front_half(*args)
    entry = akaze.front_graphs()[-1]                 # the key just used
    torch.cuda.synchronize()
    lg, lw = core_graph.leaves(got), core_graph.leaves(want)
    same = [torch.equal(a, b) for a, b in zip(lg, lw)]
    limit = 1.5 * peak + 64 * 2 ** 20
    log(f"{label}: graphed front half against eager _front_end on the same "
        f"frames: {sum(same)} of {len(lw)} output tensors bit-equal; the "
        f"graph: {entry.nodes} nodes, pool {entry.pool_bytes / 2 ** 20:.1f} "
        f"MiB beside the eager front end's peak {peak / 2 ** 20:.1f} MiB "
        f"(limit {limit / 2 ** 20:.1f} MiB), warm-up {entry.warmup_s:.3f} s "
        f"({entry.warmup_launches['fed_cycle']} kernel-A launches, peak "
        f"{entry.warmup_peak_bytes / 2 ** 20:.1f} MiB: the pool's first "
        f"block), capture {entry.capture_s:.3f} s")
    check(len(lg) == len(lw) and all(same),
          f"{label}: the graphed front half equals eager _front_end bit for "
          "bit")
    check(entry.pool_bytes <= limit,
          f"{label}: the front graph's pool within 1.5x the eager front "
          "end's peak plus 64 MiB")
    return {"nodes": entry.nodes, "pool_mib": entry.pool_bytes / 2 ** 20,
            "eager_peak_mib": peak / 2 ** 20, "warmup_s": entry.warmup_s,
            "capture_s": entry.capture_s}


def graph_pools_mib():
    """MiB held by every cached graph's pool: the front half's, the
    ladder's, the back half's and the mesh's."""
    from cubesat_apds_tpu_torch.ops.features import akaze, ladder
    from cubesat_apds_tpu_torch.parallel import mesh
    from cubesat_apds_tpu_torch.pipelines import step_graph

    return {name: sum(e.pool_bytes for e in entries) / 2 ** 20
            for name, entries in (("front", akaze.front_graphs()),
                                  ("ladder", ladder.ladder_graphs()),
                                  ("back", step_graph.step_graphs()),
                                  ("mesh", mesh.mesh_graphs()))}


def refit_matrices(torch, run):
    """The cross-covariances S [N, 3, 3] that the refit's exact Procrustes
    takes during `run()` (an eager back half): the Procrustes kernel's
    inputs on the main path."""
    from cubesat_apds_tpu_torch.ops.geometry import epnp

    seen = []
    orig = epnp.procrustes_rotation

    def recorded(S):
        seen.append(S.detach().reshape(-1, 3, 3).clone())
        return orig(S)

    epnp.procrustes_rotation = recorded
    try:
        run()
    finally:
        epnp.procrustes_rotation = orig
    torch.cuda.synchronize()
    return torch.cat(seen)


def no_sync(torch, step, label):
    """A warmed `step()` under set_sync_debug_mode("error"): any
    synchronising call fails the phase."""
    step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    except RuntimeError as e:
        raise SmokeFailure(f"{label}: a synchronising call in a warmed step "
                           f"({str(e).splitlines()[0]})") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(True, f"{label}: a warmed step ran under "
          "set_sync_debug_mode('error') without a synchronising call")


def slice_phase(torch, dev, profile_dir):
    from cubesat_apds_tpu_torch.bench import scene
    from cubesat_apds_tpu_torch.pipelines.localize import Localizer

    # bench.py's scene, from the port's bench module: its DB is the port's
    # features of the frame rolled by (7, 13), tiled to 10,240 rows and
    # perturbed past the first copy.
    t0 = time.perf_counter()
    frame, db, camera, config = scene(dev)
    log(f"DB features: {int(db.valid[:2048].sum())} keypoints "
        f"({time.perf_counter() - t0:.2f} s incl. first use)")
    gpu = Localizer(db, camera, config, device=dev)
    frame_t = torch.from_numpy(frame)

    gpu.localize(frame_t)                                   # warm-up
    torch.cuda.synchronize()
    _reset_launches()
    res = gpu.localize(frame_t)
    torch.cuda.synchronize()
    counted = _read_launches()
    launches = {k: counted[k] for k in ("fed_cycle", "sample_patches")}
    log(f"launches in one frame: {launches} (kernels A and B on their "
        f"device counters, inside the front half's and the ladder's graphs; "
        f"{counted.warmup_a} and {counted.warmup} of them in warm-ups)")
    check(launches == {"fed_cycle": 15 + counted.warmup_a,
                       "sample_patches": 2 + counted.warmup},
          "15 kernel-A and 2 kernel-B launches per frame")
    check(counted.procrustes == 1 + counted.warmups["procrustes3"],
          f"1 Procrustes launch per frame, in the back half's graph "
          f"({counted.procrustes}; {counted.warmups['procrustes3']} in "
          "step-graph warm-ups)")
    launches["procrustes3"] = counted.procrustes
    events = kernel_events(torch, lambda: gpu.localize(frame_t))
    log(f"the profiler's device events by kernel name: {events} (logged: "
        "its trace misattributes CUDA-graph kernels between sessions)")

    H = res.homography.H.cpu().numpy()
    n_kp = int(res.num_keypoints)
    n_match = int(res.num_matches)
    log(f"CUDA: keypoints={n_kp} matches={n_match} "
        f"H inliers={int(res.homography.num_inliers)} "
        f"H=[{H[0, 2]:.4f}, {H[1, 2]:.4f}] pose ok={bool(res.pose.ok)} "
        f"pose inliers={int(res.pose.num_inliers)}")
    check(res.keypoints.xy.shape == (2048, 2) and H.shape == (3, 3),
          "capacity-padded outputs of the expected shapes")
    check(bool(np.isfinite(H).all()) and
          bool(torch.isfinite(res.pose.rvec).all()) and
          bool(torch.isfinite(res.pose.tvec).all()), "finite H and pose")
    check(n_match > 0, "num_matches > 0")
    check(bool(res.homography.ok), "homography ok")
    check(abs(H[0, 2] - 13.0) < 1.0 and abs(H[1, 2] - 7.0) < 1.0,
          f"H recovers the (13, 7) px shift (got {H[0, 2]:.3f}, {H[1, 2]:.3f})")

    cpu = Localizer(db, camera, config, device="cpu")
    t0 = time.perf_counter()
    res_cpu = cpu.localize(frame_t)
    log(f"CPU run of the same frame: {time.perf_counter() - t0:.2f} s, "
        f"keypoints={int(res_cpu.num_keypoints)} "
        f"matches={int(res_cpu.num_matches)} "
        f"H inliers={int(res_cpu.homography.num_inliers)} "
        f"pose ok={bool(res_cpu.pose.ok)}")
    jac = inlier_jaccard(inlier_pairs(res), inlier_pairs(res_cpu))
    dang = rotation_deg(res.pose.rvec.cpu(), res_cpu.pose.rvec)
    log(f"CUDA vs CPU: homography-inlier Jaccard={jac:.4f} "
        f"rotation diff={dang:.5f} deg")
    check(jac >= 0.95, "CUDA and CPU homography-inlier Jaccard >= 0.95")
    check(bool(res.pose.ok) == bool(res_cpu.pose.ok), "pose ok flags agree")
    check(dang <= 0.1, "CUDA and CPU rotations within 0.1 deg")

    # The back half: graphed against eager on the same features, on this
    # DB and on a second DB of the same shapes (its rows rolled), which
    # runs through the same graph.
    import dataclasses

    from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute
    from cubesat_apds_tpu_torch.pipelines import step_graph
    from cubesat_apds_tpu_torch.pipelines.localize import (
        back_half, localize_from_features)

    feats = detect_and_compute(frame_t.to(dev), config.akaze)
    graph = graph_against_eager(
        torch, "10k slice", lambda: back_half(feats, gpu.db, gpu.camera,
                                              config, True),
        lambda: localize_from_features(feats, gpu.db, gpu.camera, config,
                                       True))
    db2 = dataclasses.replace(gpu.db, **{
        f: getattr(gpu.db, f).roll(2048, 0)
        for f in ("descriptors", "xy", "valid", "obj_points")})
    n_graphs = len(step_graph.step_graphs())
    graph_against_eager(
        torch, "10k slice, a second DB of the same shapes",
        lambda: back_half(feats, db2, gpu.camera, config, True),
        lambda: localize_from_features(feats, db2, gpu.camera, config, True))
    check(len(step_graph.step_graphs()) == n_graphs,
          "a second DB of the same shapes runs through the same graph")
    path_S = refit_matrices(torch, lambda: localize_from_features(
        feats, gpu.db, gpu.camera, config, True))
    no_sync(torch, lambda: gpu.localize(frame_t), "10k slice (a host frame)")
    graph["front"] = front_against_eager(
        torch, "10k slice, 512² B = 1", frame_t.to(dev)[None], config.akaze)
    graph["host_launches"] = host_launches(torch, lambda: gpu.localize(
        frame_t))
    log(f"10k slice: {graph['host_launches']} host launches in a warmed "
        "step (the profiler's runtime events)")

    step_s, event_ms = [], []
    for _ in range(10):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        gpu.localize(frame_t)
        b.record()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        event_ms.append(a.elapsed_time(b))
    med = float(np.median(step_s))
    log(f"warmed step: median {med * 1e3:.2f} ms host clock over 10 "
        f"(min {min(step_s) * 1e3:.2f}, max {max(step_s) * 1e3:.2f}); "
        f"CUDA events median {float(np.median(event_ms)):.2f} ms "
        f"= {1.0 / med:.2f} frames/s")

    if profile_dir:
        profile_step(torch, lambda: gpu.localize(frame_t), profile_dir,
                     "slice")
    return launches, med, gpu, frame_t, path_S, graph


# Kernels A, B, 4 and the Procrustes kernel count their launches on the
# device (eager or replayed from a CUDA graph: the front half's, the
# ladder's and the back half's): each count is the change of its counter
# since the last _reset_launches(), the warm-ups of graphs captured in the
# window included (the read's `warmups` say how many of them).
_BASE = {}


class _Launches(dict):
    """Kernel launches in a window, by kernel (A, B and 4; the Procrustes
    kernel's count is `procrustes`, read by the phases that hold the
    serving step's back half to it); `warmups`: each device-counted
    kernel's launches in the warm-ups of graphs captured in the window
    (part of its count), `warmup` kernel B's (ladder graphs) and
    `warmup_a` kernel A's (front-half graphs)."""
    warmup = 0
    warmup_a = 0
    procrustes = 0
    warmups = {}


def _device_counts():
    from cubesat_apds_tpu_torch.ops.features import ladder
    from cubesat_apds_tpu_torch.ops.kernels import build
    from cubesat_apds_tpu_torch.pipelines import step_graph
    counts = {k: build.device_launches(k, "cuda")
              for k in ("fed_cycle", "sample_patches", "knn2_hamming",
                        "procrustes3")}
    warm = dict(step_graph.warmup_launches(),
                sample_patches=ladder.warmup_launches())
    return counts, warm


def _reset_launches():
    _BASE["counts"], _BASE["warm"] = _device_counts()


def _read_launches():
    counts, warm = _device_counts()
    d = {k: counts[k] - _BASE["counts"][k] for k in counts}
    out = _Launches(fed_cycle=d["fed_cycle"],
                    sample_patches=d["sample_patches"],
                    knn2_hamming=d["knn2_hamming"])
    out.procrustes = d["procrustes3"]
    out.warmups = {k: warm[k] - _BASE["warm"][k] for k in warm}
    out.warmup = out.warmups["sample_patches"]
    out.warmup_a = out.warmups["fed_cycle"]
    return out


def timed_steps(torch, step, label):
    """Median of 10 warmed steps: host clock around a synchronised step,
    and CUDA events around each."""
    step_s, event_ms = [], []
    for _ in range(10):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        step()
        b.record()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        event_ms.append(a.elapsed_time(b))
    med = float(np.median(step_s))
    log(f"{label} warmed step: median {med * 1e3:.2f} ms host clock over 10 "
        f"(min {min(step_s) * 1e3:.2f}, max {max(step_s) * 1e3:.2f}); "
        f"CUDA events median {float(np.median(event_ms)):.2f} ms "
        f"= {1.0 / med:.2f} frames/s")
    return med


def serving_config():
    """bench.py's PipelineConfig (the port's bench module)."""
    from cubesat_apds_tpu_torch.bench import bench_config
    return bench_config()


def inlier_ids(res, sel=None):
    """Global DB row ids of a step's homography inliers among its matches."""
    m = (res.matches.valid & res.homography.inliers).cpu().numpy()
    ids = res.matches.train_idx.cpu().numpy()[m]
    if sel is not None:
        ids = sel.cpu().numpy()[ids]
    return set(ids.tolist())


def big_db_scene(torch, dev, config):
    """bench_localize_bigdb.py's scene made on `dev` from seed 42: the
    port's features of bench.py's frame rolled by (7, 13) (2,048 rows),
    then uniform random filler from a seeded torch.Generator to
    1,048,576 rows, xy over [0, 8192)², world points (xy, 0). Returns
    (DeviceDb, the frame as a host tensor); every process that calls it
    on the same card gets the same bits."""
    from cubesat_apds_tpu_torch.bench import make_frame
    from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute
    from cubesat_apds_tpu_torch.pipelines.localize import DeviceDb

    frame = make_frame(np.random.default_rng(SEED))
    feats = detect_and_compute(
        torch.from_numpy(np.roll(frame, (7, 13), axis=(0, 1))).to(dev),
        config.akaze)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    m, n_real = BIG_DB_ROWS, feats.descriptors.shape[0]
    desc = torch.randint(0, 256, (m, 61), generator=gen, device=dev,
                         dtype=torch.uint8)
    xy = torch.rand((m, 2), generator=gen, device=dev) * 8192.0
    valid = torch.ones(m, dtype=torch.bool, device=dev)
    desc[:n_real] = feats.descriptors
    xy[:n_real] = feats.keypoints.xy
    valid[:n_real] = feats.keypoints.valid
    obj = torch.cat([xy, torch.zeros((m, 1), device=dev)], dim=1)
    return DeviceDb(descriptors=desc, xy=xy, valid=valid, obj_points=obj,
                    has_world=True), torch.from_numpy(frame)


def bigdb_phase(torch, dev, profile_dir):
    """bench_localize_bigdb.py's scene, made on the card, through
    Localizer.localize (the kNN-2 kernel with the DB's layout)."""
    import dataclasses

    from cubesat_apds_tpu_torch.core.types import CameraModel
    from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute
    from cubesat_apds_tpu_torch.pipelines.localize import (
        Localizer, back_half, localize_from_features)

    config = serving_config()
    t0 = time.perf_counter()
    db, frame_t = big_db_scene(torch, dev, config)
    camera = CameraModel.ideal(500.0, 500.0, 256.0, 256.0)
    loc = Localizer(db, camera, config, device=dev)
    torch.cuda.synchronize()
    log(f"big DB: {BIG_DB_ROWS} rows (2048 real, "
        f"{int(db.valid[:2048].sum())} valid) built with its kNN-2 "
        f"layout in {time.perf_counter() - t0:.2f} s")
    check(loc.db.match_layout is not None, "Localizer made the kNN-2 layout")

    loc.localize(frame_t)                                   # warm-up
    torch.cuda.synchronize()
    _reset_launches()
    res = loc.localize(frame_t)
    torch.cuda.synchronize()
    launches = _read_launches()
    log(f"big-DB launches in one frame: {launches}")
    check(launches == {"fed_cycle": 15 + launches.warmup_a,
                       "sample_patches": 2 + launches.warmup,
                       "knn2_hamming": 1 + launches.warmups["knn2_hamming"]},
          "1 kNN-2, 15 kernel-A and 2 kernel-B launches per big-DB frame "
          f"({launches.warmup_a} kernel-A launches in front-half warm-ups, "
          f"{launches.warmup} kernel-B launches in ladder warm-ups, "
          f"{launches.warmups['knn2_hamming']} kNN-2 in step-graph "
          "warm-ups; kNN-2 on its device counter, inside the back half's "
          "graph)")
    check(launches.procrustes == 1 + launches.warmups["procrustes3"],
          f"1 Procrustes launch per big-DB frame ({launches.procrustes})")
    H = res.homography.H.cpu().numpy()
    log(f"big DB: keypoints={int(res.num_keypoints)} "
        f"matches={int(res.num_matches)} "
        f"H inliers={int(res.homography.num_inliers)} "
        f"H=[{H[0, 2]:.4f}, {H[1, 2]:.4f}] pose ok={bool(res.pose.ok)}")
    check(bool(res.homography.ok) and bool(np.isfinite(H).all()),
          "big-DB homography ok and finite")
    check(abs(H[0, 2] - 13.0) < 1.0 and abs(H[1, 2] - 7.0) < 1.0,
          f"big-DB H recovers (13, 7) (got {H[0, 2]:.3f}, {H[1, 2]:.3f})")

    # The same step's back half with kernel="scan" (the twin) on the same
    # features: the matches must be identical.
    q_feats = detect_and_compute(frame_t.to(dev), config.akaze)
    res_k = localize_from_features(q_feats, loc.db, loc.camera, config, True)
    scan_cfg = dataclasses.replace(
        config, match=dataclasses.replace(config.match, kernel="scan"))
    res_s = localize_from_features(
        q_feats, dataclasses.replace(loc.db, match_layout=None), loc.camera,
        scan_cfg, True)
    torch.cuda.synchronize()
    same = {f: torch.equal(getattr(res_k.matches, f), getattr(res_s.matches, f))
            for f in ("train_idx", "valid", "distance")}
    log(f"big DB kernel vs scan matches identical: {same} "
        f"({int(res_k.num_matches)} matches)")
    check(all(same.values()), "big-DB matches identical to kernel=\"scan\"")
    graph = graph_against_eager(
        torch, "big DB", lambda: back_half(q_feats, loc.db, loc.camera,
                                           config, True),
        lambda: localize_from_features(q_feats, loc.db, loc.camera, config,
                                       True))
    no_sync(torch, lambda: loc.localize(frame_t), "big DB (a host frame)")
    graph["front"] = front_against_eager(
        torch, "big DB, 512² B = 1", frame_t.to(dev)[None], config.akaze)
    graph["host_launches"] = host_launches(torch, lambda: loc.localize(
        frame_t))
    log(f"big DB: {graph['host_launches']} host launches in a warmed step "
        "(the profiler's runtime events)")

    med = timed_steps(torch, lambda: loc.localize(frame_t), "big-DB")
    if profile_dir:
        profile_step(torch, lambda: loc.localize(frame_t), profile_dir,
                     "bigdb")
    return launches, med, loc, res, frame_t, graph


def pruned_phase(torch, dev, loc, full_res, frame_t, profile_dir):
    """The big DB pruned: the first 32,768 rows as the coarse DB, a window
    capacity of 16,384, through localize_frame_pruned_jit."""
    from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute
    from cubesat_apds_tpu_torch.pipelines.localize import (
        DeviceDb, _pruned_back_half, localize_frame_pruned_jit,
        make_pruned_db, pruned_back_half)

    config = serving_config()
    db = loc.db
    n = COARSE_ROWS
    coarse = DeviceDb(descriptors=db.descriptors[:n], xy=db.xy[:n],
                      valid=db.valid[:n], obj_points=db.obj_points[:n],
                      has_world=True)
    t0 = time.perf_counter()
    pdb = make_pruned_db(db, coarse, WINDOW_CAPACITY)
    torch.cuda.synchronize()
    log(f"pruned DB (cell sort of {db.descriptors.shape[0]} rows) built in "
        f"{time.perf_counter() - t0:.2f} s")

    def step():
        return localize_frame_pruned_jit(frame_t, pdb, loc.camera, config,
                                         solve_pose=True)

    step()                                                  # warm-up
    torch.cuda.synchronize()
    _reset_launches()
    pr = step()
    torch.cuda.synchronize()
    launches = _read_launches()
    log(f"pruned launches in one frame: {launches} (the coarse and window "
        f"DBs are below db_block: dense matches)")
    check(launches == {"fed_cycle": 15 + launches.warmup_a,
                       "sample_patches": 2 + launches.warmup,
                       "knn2_hamming": 0},
          "15 kernel-A and 2 kernel-B launches per pruned frame "
          f"({launches.warmup_a} kernel-A launches in front-half warm-ups, "
          f"{launches.warmup} kernel-B launches in ladder warm-ups)")
    check(launches.procrustes == 1 + launches.warmups["procrustes3"],
          f"1 Procrustes launch per pruned frame ({launches.procrustes})")
    H = pr.result.homography.H.cpu().numpy()
    p_ids = inlier_ids(pr.result, pr.sel)
    f_ids = inlier_ids(full_res)
    jac = len(p_ids & f_ids) / max(len(p_ids | f_ids), 1)
    containment = len(p_ids & f_ids) / max(len(f_ids), 1)
    log(f"pruned: coarse_ok={bool(pr.coarse_ok)} n_window={int(pr.n_window)} "
        f"overflow={bool(pr.overflow)} matches={int(pr.result.num_matches)} "
        f"H inliers={int(pr.result.homography.num_inliers)} "
        f"H=[{H[0, 2]:.4f}, {H[1, 2]:.4f}] "
        f"pose ok={bool(pr.result.pose.ok)}; vs the big-DB step: inlier "
        f"Jaccard={jac:.4f} full-inlier containment={containment:.4f} "
        f"({len(p_ids)} pruned, {len(f_ids)} full inliers)")
    check(bool(pr.coarse_ok), "pruned coarse fix ok")
    check(not bool(pr.overflow), "pruned window within its capacity")
    check(bool(pr.result.homography.ok) and abs(H[0, 2] - 13.0) < 1.0
          and abs(H[1, 2] - 7.0) < 1.0,
          f"pruned H recovers (13, 7) (got {H[0, 2]:.3f}, {H[1, 2]:.3f})")
    check(containment >= CONTAINMENT_MIN,
          f"pruned keeps >= {CONTAINMENT_MIN} of the big-DB step's inliers")
    feats = detect_and_compute(frame_t.to(dev), config.akaze)
    hw = tuple(frame_t.shape)
    graph = graph_against_eager(
        torch, "pruned", lambda: pruned_back_half(
            feats, hw, pdb, loc.camera, config, True, 0.25),
        lambda: _pruned_back_half(feats, hw, pdb, loc.camera, config, True,
                                  0.25))
    no_sync(torch, step, "pruned (a host frame)")
    graph["front"] = front_against_eager(
        torch, "pruned, 512² B = 1", frame_t.to(dev)[None], config.akaze)
    graph["host_launches"] = host_launches(torch, step)
    log(f"pruned: {graph['host_launches']} host launches in a warmed step "
        "(the profiler's runtime events)")
    med = timed_steps(torch, step, "pruned")
    if profile_dir:
        profile_step(torch, step, profile_dir, "pruned")
    return launches, med, graph


# ---- the stream phase: stored DBs served as a stream -----------------------

MOSAIC_GT = [10.0, 1e-5, 0.0, 56.0, 0.0, -1e-5]   # mosaic px → lon/lat (deg)


def _elevation(rng, extent):
    """A seeded 16×16 elevation raster (100–120 m) over [0, extent)² px."""
    step = extent * 1e-5 / 16
    return (rng.uniform(100.0, 120.0, (16, 16)).astype(np.float32),
            [10.0, step, 0.0, 56.0, 0.0, -step])


def _store_rows(store, image_id, desc, xy):
    """Rows with responses falling with the row index, so the store's
    response-ranked LoD query returns them in the order written."""
    n = len(desc)
    store.add_keypoints(image_id, xy[:, 0], xy[:, 1],
                        np.full(n, 4.8, np.float32), np.zeros(n, np.float32),
                        np.linspace(1.0, 0.5, n, dtype=np.float32),
                        np.zeros(n, np.int32), np.zeros(n, np.int32), desc)


def write_stream_stores(torch, dev, root, base_u8, config):
    """The two stores of the stream phase, from seed 42 with numpy: the
    10k scene as an npz FeatureStore and the 1,048,576-row scene as a
    binary store (LoD 0; LoD 1 = its first 32,768 rows). Both rows start
    with the port's features of the frame rolled by (7, 13); both stores
    have a geotransform and an elevation raster. Returns their paths and
    the LoD-0 arrays written."""
    import os

    from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute
    from cubesat_apds_tpu_torch.store.binary_store import write_binary_store
    from cubesat_apds_tpu_torch.store.feature_store import FeatureStore

    rng = np.random.default_rng(SEED)
    rolled = torch.from_numpy(np.roll(base_u8, (7, 13), axis=(0, 1)))
    f = detect_and_compute(rolled.to(dev).float() / 255.0, config.akaze)
    v = f.keypoints.valid.cpu().numpy()
    desc = f.descriptors.cpu().numpy()[v]
    xy = f.keypoints.xy.cpu().numpy()[v]

    m = 10240                         # bench.py's DB: tiled and perturbed
    reps = m // len(desc) + 1
    d10 = np.tile(desc, (reps, 1))[:m]
    flip = rng.integers(0, 256, d10.shape, dtype=np.uint8)
    flip[:len(desc)] = 0
    d10 = d10 ^ (flip & rng.integers(0, 2, d10.shape, dtype=np.uint8) * 255)
    x10 = np.tile(xy, (reps, 1))[:m].astype(np.float32)
    s10 = FeatureStore()
    _store_rows(s10, s10.create_image(0, 0, 512, 512, 0), d10, x10)
    s10.set_geotransform(1, MOSAIC_GT)
    s10.set_elevation(*_elevation(rng, 512))
    s10.descriptor_mode = config.akaze.descriptor_tag
    p10 = os.path.join(root, "store10k")
    s10.save(p10)

    mb = BIG_DB_ROWS                  # bench_localize_bigdb.py's layout
    dbig = rng.integers(0, 256, (mb, 61), dtype=np.uint8)
    xbig = rng.uniform(0.0, 8192.0, (mb, 2)).astype(np.float32)
    dbig[:len(desc)] = desc
    xbig[:len(desc)] = xy
    sb = FeatureStore()
    _store_rows(sb, sb.create_image(0, 0, 8192, 8192, 0), dbig, xbig)
    _store_rows(sb, sb.create_image(0, 0, 8192, 8192, 1),
                dbig[:COARSE_ROWS], xbig[:COARSE_ROWS])
    sb.set_geotransform(1, MOSAIC_GT)
    sb.set_elevation(*_elevation(rng, 8192))
    sb.descriptor_mode = config.akaze.descriptor_tag
    pbig = os.path.join(root, "store1m")
    write_binary_store(sb, pbig)
    return {"10k": (p10, d10, x10), "1M": (pbig, dbig, xbig)}


def _check_loaded(torch, db, desc, xy, label):
    n = len(desc)
    same = (torch.equal(db.descriptors[:n].cpu(), torch.from_numpy(desc))
            and torch.equal(db.xy[:n].cpu(), torch.from_numpy(xy))
            and bool(db.valid[:n].all()) and not bool(db.valid[n:].any()))
    check(same and db.has_world and db.world_frame == "ecef",
          f"{label}: descriptors, xy and valid equal the {n} rows written; "
          f"ECEF world points")


def _corner_err(Ha, Hb, n=512):
    c = np.array([[0, 0, 1], [n, 0, 1], [0, n, 1], [n, n, 1]], np.float64)
    pa, pb = c @ np.asarray(Ha, np.float64).T, c @ np.asarray(Hb, np.float64).T
    return float(np.abs(pa[:, :2] / pa[:, 2:] - pb[:, :2] / pb[:, 2:]).max())


def _agree(torch, packed, ref_packed, got, ref):
    """A stream frame against its reference: equal packed vectors, or H
    within 0.01 px at the frame's corners, equal ok flags and homography-
    inlier Jaccard ≥ 0.95 (the differing fields are returned)."""
    if np.array_equal(packed, ref_packed):
        return True, ""
    diff = [i for i in range(len(packed)) if packed[i] != ref_packed[i]]
    ok = (_corner_err(packed[:9].reshape(3, 3), ref_packed[:9].reshape(3, 3))
          <= 0.01 and packed[9] == ref_packed[9]
          and packed[19] == ref_packed[19]
          and inlier_jaccard(inlier_pairs(got), inlier_pairs(ref)) >= 0.95)
    return ok, f"fields {diff}"


def stream_run(torch, label, make_stream, frames, shifts, refs, kind):
    """One timed stream of `frames` through a fresh StreamingLocalizer,
    with the launch counters zeroed just before and read just after, the
    back half's features and results recorded row by row (device
    tensors, no copies), then every frame checked against its reference;
    then the device kernels of one batch's back half and of one step,
    counted under torch.profiler."""
    from cubesat_apds_tpu_torch.core.types import select
    from cubesat_apds_tpu_torch.pipelines import step_graph
    from cubesat_apds_tpu_torch.pipelines import stream as stream_mod

    s = make_stream()
    b = s.batch
    list(s.run(frames[:b]))                        # warm-up, outside
    torch.cuda.synchronize()
    s.times = type(s.times)()
    record, used = [], []
    name = "pruned_back_half" if kind == "pruned" else "back_half"
    orig = getattr(stream_mod, name)

    def recorded(feats, *a, **k):
        # One call per batch (a replay of the back half's graph): its rows,
        # frame by frame, in stream order, and the graph it replayed.
        out = orig(feats, *a, **k)
        used.append(step_graph.step_graphs()[-1])
        res = out.result if kind == "pruned" else out
        record.extend((select(feats, i), select(res, i))
                      for i in range(feats.descriptors.shape[0]))
        return out

    setattr(stream_mod, name, recorded)
    try:
        _reset_launches()
        t0 = time.perf_counter()
        results = list(s.run(frames))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
    finally:
        setattr(stream_mod, name, orig)
    steps = -(-len(frames) // b)
    check([r.frame_id for r in results] == list(range(len(frames))),
          f"{label}: {len(frames)} frames back, in order")
    check(launches["fed_cycle"]
          == 15 * (steps + s.fallback_frames) + launches.warmup_a
          and launches["sample_patches"]
          == 2 * (steps + s.fallback_frames) + launches.warmup,
          f"{label}: 15 kernel-A and 2 kernel-B launches per batch of "
          f"{b} ({launches['fed_cycle']} and {launches['sample_patches']} "
          f"for {steps} batches, {s.fallback_frames} fallback frames; "
          f"{launches.warmup_a} kernel-A launches in front-half warm-ups, "
          f"{launches.warmup} kernel-B launches in ladder warm-ups)")
    graph = stream_graph(s, used)
    if kind == "full1M":
        # The batched back half matches a batch's B·capacity queries in
        # ONE kernel-4 launch, as the JAX package's single knn2_fused call
        # under vmap (a fallback frame adds its own). The launches are the
        # kernel's device count (each batch replays the back half's graph,
        # captured from a batch of B frames' features).
        cap = s.config.akaze.capacity
        warm = launches.warmups["knn2_hamming"]
        check(launches["knn2_hamming"] == steps + s.fallback_frames + warm
              and graph["queries"] == b * cap,
              f"{label}: one kNN-2 launch per batch at Q = {b} x {cap} = "
              f"{b * cap} ({launches['knn2_hamming']} launches for {steps} "
              f"batches, {warm} in step-graph warm-ups; the graph's "
              f"queries {graph['queries']})")
    warm = launches.warmups["procrustes3"]
    check(launches.procrustes == steps + s.fallback_frames + warm,
          f"{label}: one Procrustes launch per batch ({launches.procrustes} "
          f"for {steps} batches, {warm} in step-graph warm-ups)")
    bad, near = [], {}
    for i, r in enumerate(results):
        dx, dy = shifts[i % len(shifts)]
        H = r.homography
        if not (r.homography_ok and abs(H[0, 2] - (13 + dx)) < 1.0
                and abs(H[1, 2] - (7 + dy)) < 1.0):
            bad.append(f"frame {i}: shift ({H[0, 2]:.3f}, {H[1, 2]:.3f}) "
                       f"for ({13 + dx}, {7 + dy})")
            continue
        feats, got = record[i]
        ref_feats, ref, ref_packed = refs[i % len(shifts)]
        same_feats = torch.equal(feats.descriptors, ref_feats.descriptors) \
            and all(torch.equal(getattr(feats.keypoints, k),
                                getattr(ref_feats.keypoints, k))
                    for k in ("xy", "size", "angle", "response", "octave",
                              "class_id", "valid"))
        same_matches = all(torch.equal(getattr(got.matches, k),
                                       getattr(ref.matches, k))
                           for k in ("query_idx", "train_idx", "distance",
                                     "valid"))
        packed = np.concatenate([H.reshape(-1), [
            r.homography_ok, r.num_inliers, r.num_matches, r.num_keypoints],
            r.rvec, r.tvec, [r.pose_ok, r.pose_num_inliers]]).astype(
                np.float32)
        agree, why = _agree(torch, packed, ref_packed, got, ref)
        if not (same_feats and same_matches and agree):
            bad.append(f"frame {i}: features equal {same_feats}, matches "
                       f"equal {same_matches}, packed agrees {agree} {why}")
        elif why:
            near[i] = why
    if near:
        fields = sorted({int(f) for w in near.values()
                         for f in w[len("fields ["):-1].split(", ")})
        log(f"  {label}: {len(results) - len(near)} frames' packed outputs "
            f"equal their reference's bit for bit, {len(near)} differ within "
            f"the stated tolerance (fields {fields})")
    lat = sorted(r.latency_s for r in results)
    fps = len(results) / wall
    p50, p95 = lat[len(lat) // 2], lat[int(0.95 * len(lat)) - 1]
    back, step_k, busy, host = batch_kernels(torch, s, frames[:b], kind)
    idle = 1.0 - busy / (wall / steps * 1e3)
    per_batch = {k: v / steps for k, v in launches.items()}
    per_batch["procrustes3"] = launches.procrustes / steps
    log(f"{label}: {len(results)} frames in {wall:.3f} s = {fps:.2f} "
        f"frames/s, {wall / len(results) * 1e3:.2f} ms per frame; latency "
        f"p50 {p50 * 1e3:.2f} ms, p95 {p95 * 1e3:.2f} ms; fallback_frames "
        f"{s.fallback_frames}; launches per batch: {per_batch}; device "
        f"kernels: {back} in the eager back half of a batch (profiler), "
        f"{graph['nodes']['kernels']} in its graph (of {graph['nodes']} "
        f"nodes); host launches a step {host}; the profiler's device events "
        f"in a step {step_k} = {step_k / b:.1f} a frame, device-busy "
        f"{busy:.3f} ms of {wall / steps * 1e3:.2f} ms a step in the stream "
        f"(idle share {idle:.4f}; the profiler may miss graph kernels)")
    log("\n".join("    " + ln for ln in s.times.report().splitlines()))
    check(not bad, f"{label}: every frame recovers its shift within 1 px "
          f"and agrees with its reference" + ("" if not bad else
                                              ": " + "; ".join(bad[:5])))
    return {"frames_per_s": fps, "ms_per_frame": wall / len(results) * 1e3,
            "p50_s": p50, "p95_s": p95,
            "launches_per_batch": per_batch,
            "back_half_kernels_per_batch": back,
            "back_half_graph_kernels": graph["nodes"]["kernels"],
            "host_launches_per_step": host, "pool_mib": graph["pool_mib"],
            "kernels_per_frame": step_k / b, "idle_share": idle,
            "fallback_frames": s.fallback_frames, "results": results}


def device_kernels(torch, fn):
    """(device events — kernels, copies, fills — and their summed ms) of
    one warmed call of `fn` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(ev), sum(e.time_range.elapsed_us() for e in ev) / 1e3


def stream_graph(s, used):
    """The back half's graph that the stream `s` replayed at every batch
    (`used`, one entry a batch): its node counts, pool MiB and the
    queries of its match (B · capacity)."""
    check(len({id(e) for e in used}) == 1,
          f"the stream's batches replay one back-half graph "
          f"({len({id(e) for e in used})} for {len(used)} batches)")
    e = used[0]
    check(e.static_args[0].descriptors.shape[:-1]
          == (s.batch, s.config.akaze.capacity),
          "the stream's graph was captured from a batch's features")
    return {"nodes": e.nodes, "pool_mib": e.pool_bytes / 2 ** 20,
            "capture_s": e.capture_s,
            "queries": e.static_args[0].descriptors.shape[:-1].numel()}


def host_launches(torch, fn):
    """Launches the host issues in one warmed call of `fn`: the CUDA
    runtime calls that queue device work (kernel and graph launches,
    copies, memsets), counted from torch.profiler's runtime events."""
    import collections

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = collections.Counter(
        e.name for e in prof.events() if e.device_type == DeviceType.CPU
        and any(k in e.name for k in ("LaunchKernel", "GraphLaunch",
                                      "Memcpy", "Memset")))
    return sum(names.values())


def batch_kernels(torch, s, frames, kind):
    """(device kernels of a batch's eager back half, the profiler's device
    events of the whole step, the step's device-busy ms under the
    profiler, the step's host launches) for the stream `s` on one batch of
    `frames`. The eager back half is the function the step's graph
    captures; the profiler may miss the kernels of a graph replay."""
    from cubesat_apds_tpu_torch.ops.features.akaze import (
        detect_and_compute_batch)
    from cubesat_apds_tpu_torch.pipelines import stream as stream_mod
    from cubesat_apds_tpu_torch.pipelines.localize import (
        _pruned_back_half, localize_from_features)

    x = torch.stack([torch.from_numpy(f) for f in frames]).to(s.device)
    feats = detect_and_compute_batch(stream_mod._as_float(x),
                                     s.config.akaze)
    if kind == "pruned":
        def back():
            return _pruned_back_half(
                feats, tuple(x.shape[1:]), s.db, s.camera, s.config,
                s.solve_pose, stream_mod._MARGIN)
    else:
        def back():
            return localize_from_features(
                feats, s.db, s.camera, s.config, s.solve_pose)
    return (device_kernels(torch, back)[0],
            *device_kernels(torch, lambda: s._step(x)),
            host_launches(torch, lambda: s._step(x)))


def stream_phase(torch, dev, profile_dir):
    """bench_stream.py's scene from stores on disk: 60 frames (a pool of 8
    seeded shifted 512² uint8 frames, cycled; capacity 2048) through
    StreamingLocalizer from the 10k npz store at batch 1 and 8, the
    1,048,576-row binary store at batch 8 and 4 (full DB, kernel 4 once a
    batch; batch 4 is the mesh stream's row) and pruned at batch 1 and 8.
    A batch's back-half device kernels at batch 8 must stay within 1.25x
    those at batch 1."""
    import tempfile

    from cubesat_apds_tpu_torch.bench import make_frame
    from cubesat_apds_tpu_torch.core.types import CameraModel
    from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute
    from cubesat_apds_tpu_torch.pipelines.localize import (
        Localizer, load_device_db, load_pruned_device_db,
        localize_frame_pruned_jit)
    from cubesat_apds_tpu_torch.pipelines.stream import (
        StreamingLocalizer, _pack_outputs)
    from cubesat_apds_tpu_torch.store import open_store

    config = serving_config()
    camera = CameraModel.ideal(500.0, 500.0, 256.0, 256.0)
    rng = np.random.default_rng(SEED)
    base_u8 = (make_frame(rng) * 255).astype(np.uint8)
    shifts = [tuple(int(v) for v in d)
              for d in np.random.default_rng(SEED + 3).integers(-4, 5, (8, 2))]
    pool = [np.roll(base_u8, (-dy, -dx), axis=(0, 1)) for dx, dy in shifts]
    frames = [pool[i % len(pool)] for i in range(STREAM_FRAMES)]
    out = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        written = write_stream_stores(torch, dev, root, base_u8, config)
        log(f"stream stores written in {time.perf_counter() - t0:.2f} s: "
            f"10k npz FeatureStore, {BIG_DB_ROWS}-row binary store (+ "
            f"{COARSE_ROWS} rows at LoD 1)")
        t0 = time.perf_counter()
        p10, d10, x10 = written["10k"]
        db10 = load_device_db(open_store(p10), 0, match_config=config.match,
                              device=dev)
        pbig, dbig, xbig = written["1M"]
        big_store = open_store(pbig)
        dbbig = load_device_db(big_store, 0, match_config=config.match,
                               device=dev, limit=BIG_DB_ROWS)
        pdb = load_pruned_device_db(big_store, 0, 1, WINDOW_CAPACITY,
                                    match_config=config.match, device=dev,
                                    limit=BIG_DB_ROWS)
        torch.cuda.synchronize()
        log(f"stores loaded onto the card in {time.perf_counter() - t0:.2f} s")
        _check_loaded(torch, db10, d10, x10, "10k store")
        _check_loaded(torch, dbbig, dbig, xbig, "1M store")
        check(dbbig.match_layout is not None and pdb.coarse.descriptors.shape[0]
              == COARSE_ROWS, "1M store: kNN-2 layout made; coarse DB = "
              "LoD 1's 32,768 rows")

    def references(kind, db):
        """Each pool frame's features and result from one call of its own,
        with the median host-clock time of those calls (first excluded)."""
        refs, secs = [], []
        loc = None if kind == "pruned" else Localizer(db, camera, config,
                                                      device=dev)
        for f in pool:
            ft = torch.from_numpy(f).to(dev).float() / 255.0
            feats = detect_and_compute(ft, config.akaze)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "pruned":
                res = localize_frame_pruned_jit(ft, db, camera, config,
                                                solve_pose=True).result
            else:
                res = loc.localize(ft)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            packed = _pack_outputs(res.homography, res.num_matches,
                                   res.num_keypoints, res.pose)
            refs.append((feats, res, packed.cpu().numpy()))
        log(f"{kind} references, one call per frame outside the stream: "
            f"median {np.median(secs[1:]) * 1e3:.2f} ms per frame")
        return refs

    half = STREAM_BATCH // 2
    runs = [("10k store, batch 1", db10, 1, "full"),
            ("10k store, batch 8", db10, STREAM_BATCH, "full"),
            ("1M store, full DB, batch 8", dbbig, STREAM_BATCH, "full1M"),
            (f"1M store, full DB, batch {half}", dbbig, half, "full1M"),
            ("1M store, pruned, batch 1", pdb, 1, "pruned"),
            ("1M store, pruned, batch 8", pdb, STREAM_BATCH, "pruned")]
    refs = {}
    for label, db, b, kind in runs:
        if id(db) not in refs:
            refs[id(db)] = references(kind, db)
        out[label] = stream_run(
            torch, label,
            lambda: StreamingLocalizer(db, camera, config, solve_pose=True,
                                       prefetch=2 * b, batch=b, device=dev),
            frames, shifts, refs[id(db)], kind)
    if profile_dir:
        for b in (1, STREAM_BATCH):
            s = StreamingLocalizer(db10, camera, config, batch=b, device=dev)
            x = torch.stack([torch.from_numpy(f) for f in pool[:b]]).to(dev)
            s._step(x)                                      # warm-up
            profile_step(torch, lambda: s._step(x), profile_dir,
                         f"stream_b{b}", frames_per_step=b)
    # The back half runs once a batch: its launches must not grow with B.
    for b1, b8 in (("10k store, batch 1", "10k store, batch 8"),
                   ("1M store, pruned, batch 1", "1M store, pruned, batch 8")):
        k1 = out[b1]["back_half_kernels_per_batch"]
        k8 = out[b8]["back_half_kernels_per_batch"]
        check(k8 <= 1.25 * k1, f"a batch's back half: {k8} device kernels "
              f"at batch {STREAM_BATCH} against {k1} at batch 1 "
              f"({k8 / k1:.3f}x, at most 1.25x) — {b8.split(',')[0]}")
    ctx = {"db1m": dbbig, "frames": frames, "shifts": shifts, "pool": pool,
           "camera": camera,
           "row_results": out[f"1M store, full DB, batch {half}"].pop(
               "results")}
    for r in out.values():
        r.pop("results", None)
    return out, ctx


# ---- Part A: the feature step reads nothing back to the host --------------

def device_busy_ms(torch, fn, reps=3):
    """Device time of one call of `fn`: the CUDA kernels' durations summed
    over `reps` warmed calls under torch.profiler, per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA)
    return busy / 1e3 / reps


def sync_phase(torch, dev, loc, frame_t, image):
    """detect_and_compute_batch, warmed, under set_sync_debug_mode("error")
    on the 512² main-path frame and on a build batch of 8 tiles of 256²;
    one warmed main-path step and one stream batch of 8 (its step and its
    fetch) under "warn", their synchronising calls listed by file:line;
    and the per-keypoint stages' device time at full capacity against the
    live prefix (bit-equal)."""
    import collections
    import os
    import warnings

    from cubesat_apds_tpu_torch.core.config import PipelineConfig
    from cubesat_apds_tpu_torch.ops.features.akaze import (
        _front_end, detect_and_compute_batch, orient_describe)
    from cubesat_apds_tpu_torch.pipelines.stream import StreamingLocalizer

    frame = frame_t.to(dev)[None]
    tiles = torch.from_numpy(np.stack(
        [image[256 * (i // 4):256 * (i // 4 + 1),
               256 * (i % 4):256 * (i % 4 + 1)] for i in range(8)])).to(dev)
    cases = [("512² frame, capacity 2048", frame, serving_config().akaze),
             ("build batch 8 x 256², capacity "
              f"{PipelineConfig().akaze.capacity}", tiles,
              PipelineConfig().akaze)]
    for label, x, akaze in cases:
        detect_and_compute_batch(x, akaze)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            detect_and_compute_batch(x, akaze)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        check(True, f"detect_and_compute_batch ({label}) ran under "
              "set_sync_debug_mode('error') without a synchronising call")

    root = os.path.dirname(os.path.abspath(__file__))

    def sync_sites(fn, label):
        fn()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        found = collections.Counter(
            f"{os.path.relpath(w.filename, root)}:{w.lineno}" for w in caught
            if "called a synchronizing" in str(w.message))
        log(f"{label} under set_sync_debug_mode('warn'): "
            f"{sum(found.values())} synchronising calls at {len(found)} "
            f"sites:")
        for site, n in sorted(found.items()):
            log(f"  {site}: {n}")
        check(not any("ops/features" in k or "ops/kernels" in k
                      for k in found),
              f"{label}: no synchronising call in the feature step or the "
              f"kernel wrappers")
        return found

    sites = sync_sites(lambda: loc.localize(frame_t), "main-path step")
    check(not sites, "main-path step (a host frame): 0 synchronising calls")
    # A stream batch of 8: the step, then its one fetch of the packed rows.
    stream = StreamingLocalizer(loc.db, loc.camera, serving_config(),
                                batch=STREAM_BATCH, device=dev)
    x = torch.stack([torch.roll(frame_t, (k, 2 * k), (0, 1))
                     for k in range(STREAM_BATCH)]).to(dev)
    batch_sites = sync_sites(lambda: stream._step(x),
                             f"stream batch of {STREAM_BATCH} (10k DB), "
                             "its step")
    check(not batch_sites, f"stream batch of {STREAM_BATCH}: 0 "
          "synchronising calls outside its fetch")
    out = stream._step(x)
    fetch_sites = sync_sites(lambda: out.cpu(), f"stream batch of "
                             f"{STREAM_BATCH}, its one fetch")
    linalg = linalg_syncs(torch, dev)

    stages = {}
    for label, x, akaze in cases:
        cap = akaze.capacity
        kps, packed, level_hw, _ = _front_end(x, akaze, cap, None)
        n_live = int(kps.valid.sum(-1).max())
        full = orient_describe(kps, packed, level_hw, cap)
        pre = orient_describe(kps, packed, level_hw, n_live)
        check(all(torch.equal(a, b) for a, b in zip(full, pre)),
              f"{label}: per-keypoint stages at capacity equal the live "
              f"prefix ({n_live} slots) bit for bit")
        full_ms = device_busy_ms(torch, lambda: orient_describe(
            kps, packed, level_hw, cap))
        pre_ms = device_busy_ms(torch, lambda: orient_describe(
            kps, packed, level_hw, n_live))
        log(f"per-keypoint stages (orientation + MLDB), {label}: device "
            f"{full_ms:.4f} ms at capacity {cap} against {pre_ms:.4f} ms on "
            f"the live prefix of {n_live} ({full_ms / pre_ms:.2f}x)")
        stages[label] = {"capacity_ms": full_ms, "prefix_ms": pre_ms,
                         "live": n_live, "capacity": cap}
    return {"sync_sites": dict(sites), "batch_sync_sites": dict(batch_sites),
            "fetch_sync_sites": dict(fetch_sites), "linalg_syncs": linalg,
            "per_keypoint_stages": stages}


def linalg_syncs(torch, dev):
    """Which torch.linalg routes to a batch of 3×3 SVD factors (or the
    eigenvectors of SᵀS) run on the card without a synchronising call:
    each under set_sync_debug_mode("error"), on 24 matrices, the refit's
    count at batch 8. Logged, not a gate: the Procrustes kernel exists
    because none of them does."""
    S = torch.randn(24, 3, 3, generator=torch.Generator(device=dev)
                    .manual_seed(SEED), device=dev)
    calls = {
        "torch.linalg.svd": lambda: torch.linalg.svd(S),
        "torch.linalg.svd (gesvd)": lambda: torch.linalg.svd(
            S, driver="gesvd"),
        "torch.linalg.svd (gesvdj)": lambda: torch.linalg.svd(
            S, driver="gesvdj"),
        "torch.linalg.svd (gesvda)": lambda: torch.linalg.svd(
            S, driver="gesvda"),
        "torch.svd": lambda: torch.svd(S),
        "torch.linalg.svd float64": lambda: torch.linalg.svd(S.double()),
        "torch.linalg.eigh(SᵀS)": lambda: torch.linalg.eigh(S.mT @ S),
    }
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
            out[name] = "no sync"
        except RuntimeError:
            out[name] = "syncs"
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    log(f"torch {torch.__version__}: the SVD routes under "
        f"set_sync_debug_mode('error'): {out}")
    return out


# ---- slice 11: the capacity ladder on the card ------------------------------

LADDER_MODES = {"exact": {},
                "fast": dict(descriptor_mode="fast", orientation_mode="fast"),
                "hybrid": dict(descriptor_mode="hybrid", hybrid_subcells=2)}


def build_tiles(torch, dev, image):
    """A build batch: 8 tiles of 256² from the build image's corner."""
    return torch.from_numpy(np.stack(
        [image[256 * (i // 4):256 * (i // 4 + 1),
               256 * (i % 4):256 * (i % 4 + 1)] for i in range(8)])).to(dev)


def ladder_cases(torch, dev, image):
    """(label, images [B, H, W] on the card, AkazeConfig) of the ladder
    phase: the first, a middle and the last rung, and a build batch."""
    import dataclasses

    from cubesat_apds_tpu_torch.bench import make_frame
    from cubesat_apds_tpu_torch.core.config import PipelineConfig

    frame = make_frame(np.random.default_rng(SEED))
    sparse = np.zeros_like(frame)
    sparse[:192, :192] = frame[:192, :192]
    base = serving_config().akaze
    build = PipelineConfig().akaze
    return [
        ("sparse 512² frame, capacity 2048",
         torch.from_numpy(sparse)[None].to(dev), base),
        ("512² frame, capacity 2048", torch.from_numpy(frame)[None].to(dev),
         base),
        ("512² frame, capacity 1024", torch.from_numpy(frame)[None].to(dev),
         dataclasses.replace(base, capacity=1024)),
        (f"build batch 8 x 256², capacity {build.capacity}",
         build_tiles(torch, dev, image), build),
    ]


def path_rungs(torch, dev, image):
    """Kernel B's K a stack on the main path's frame and on a build batch:
    the ladder's rung for each (its largest live count)."""
    from cubesat_apds_tpu_torch.ops.features.akaze import (
        _bucket_sizes, _front_end, rung_index)

    out = {}
    # The cases: the sparse frame, bench.py's frame (the main path's), the
    # same at capacity 1024, the build batch.
    for key, (_, x, akaze) in zip((None, "frame", None, "build"),
                                  ladder_cases(torch, dev, image)):
        if key is None:
            continue
        kps = _front_end(x, akaze, akaze.capacity, None)[0]
        buckets = _bucket_sizes(akaze.capacity, akaze.adaptive_buckets)
        out[key] = buckets[int(rung_index(kps.valid.sum(-1).max(), buckets))]
    log(f"kernel B's K a stack on the main path (the ladder's rung): {out}")
    return out


def kernel_events(torch, fn):
    """Device kernels of one call of `fn` under torch.profiler, counted by
    the port's kernel names (kernel A, kernel B, kernel 4)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = {"fed_cycle": "fed_cycle_kernel",
             "sample_patches": "sample_patches_kernel",
             "knn2_hamming": "knn2_partial_kernel"}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {k: sum(n in e for e in ev) for k, n in names.items()}


def _same_features(torch, a, b):
    return torch.equal(a.descriptors, b.descriptors) and all(
        torch.equal(getattr(a.keypoints, k), getattr(b.keypoints, k))
        for k in ("xy", "size", "angle", "response", "octave", "class_id",
                  "valid"))


def ladder_phase(torch, dev, image):
    """The capacity ladder (slice 11) in exact, fast and hybrid modes on
    four cases: the rung the device chose against the host formula, the
    features against adaptive_buckets=1 bit for bit, a warmed call under
    set_sync_debug_mode("error"), a held result unchanged by the next call
    of its key, kernel B's launches on its device counter (the profiler's
    events beside them), kernel B against its twin at the rung's K, the
    graph's pool beside the eager stage's peak, and the stage's device
    time at capacity, at the rung and on the live prefix. In each mode the
    front half's graph is held to the eager front end on the four cases,
    a 512² batch of 8 and a 1024² frame."""
    import dataclasses

    from cubesat_apds_tpu_torch.bench import make_frame
    from cubesat_apds_tpu_torch.ops.features import akaze as akaze_mod
    from cubesat_apds_tpu_torch.ops.features import ladder
    from cubesat_apds_tpu_torch.ops.features.akaze import (
        _bucket_sizes, _front_end, adaptive_orient_describe,
        detect_and_compute_batch, orient_describe, rung_index)

    t_phase = time.perf_counter()
    frame = torch.from_numpy(make_frame(np.random.default_rng(SEED))).to(dev)
    front_only = [
        (f"512² B = {STREAM_BATCH}, capacity 2048", torch.stack(
            [torch.roll(frame, (k, 2 * k), (0, 1))
             for k in range(STREAM_BATCH)])),
        ("1024² frame, capacity 2048",
         torch.from_numpy(image[:1024, :1024].copy())[None].to(dev))]
    out, chosen, fronts = {}, {}, {}
    for mode, kw in LADDER_MODES.items():
        for case, x in front_only:
            label = f"{mode}: {case}"
            fronts[label] = front_against_eager(
                torch, f"ladder phase, {label}", x,
                dataclasses.replace(serving_config().akaze, **kw))
        chosen[mode] = set()
        for case, x, base in ladder_cases(torch, dev, image):
            label = f"{mode}: {case}"
            akaze = dataclasses.replace(base, **kw)
            flat = dataclasses.replace(akaze, adaptive_buckets=1)
            cap = akaze.capacity
            buckets = _bucket_sizes(cap, akaze.adaptive_buckets)
            kps, packed, level_hw, grids = _front_end(x, akaze, cap, None)
            live = int(kps.valid.sum(-1).max())
            host = int(rung_index(torch.tensor(live), buckets))
            rung = buckets[host]

            known = {g.key for g in ladder.ladder_graphs()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            first = detect_and_compute_batch(x, akaze)   # a new key captures
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            graph = ladder.ladder_graphs()[-1]
            captured = graph.key not in known
            device_rung = graph.last_rung()
            check(device_rung == host, f"{label}: the device's rung "
                  f"({device_rung}) is the host formula's ({host}: "
                  f"{rung} slots for {live} live)")
            chosen[mode].add("first" if host == 0 else "last"
                             if host == len(buckets) - 1 else "middle")
            want = detect_and_compute_batch(x, flat)
            check(_same_features(torch, first, want), f"{label}: the "
                  "ladder's features equal adaptive_buckets=1 bit for bit")
            held = [t.clone() for t in (first.descriptors,
                                        first.keypoints.angle)]
            detect_and_compute_batch(x.flip(-1), akaze)     # same key
            torch.cuda.synchronize()
            check(torch.equal(first.descriptors, held[0]) and torch.equal(
                first.keypoints.angle, held[1]), f"{label}: a held result "
                "is unchanged by the next call of its key")
            torch.cuda.set_sync_debug_mode("error")
            try:
                again = detect_and_compute_batch(x, akaze)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            check(_same_features(torch, again, want), f"{label}: a warmed "
                  "call runs under set_sync_debug_mode('error'), the same "
                  "bits")
            _reset_launches()
            events = kernel_events(torch, lambda: detect_and_compute_batch(
                x, akaze))
            counted = _read_launches()
            b_want = 2 if mode == "exact" else 4
            check(counted["sample_patches"] == b_want + counted.warmup
                  and counted["fed_cycle"] == 15 + counted.warmup_a,
                  f"{label}: kernel B {b_want} launches a step on its "
                  f"device counter ({counted}, {counted.warmup} in ladder "
                  f"warm-ups); the profiler's device events by name "
                  f"{events} (logged, not held: its trace misattributes "
                  "CUDA-graph kernels between sessions)")
            twin = kernel_b_against_twin(torch, lambda: orient_describe(
                kps, packed, level_hw, rung, akaze, grids), label)
            fronts[label] = front_against_eager(
                torch, f"ladder phase, {label}", x, akaze)
            fronts[label]["host_launches"] = host_launches(
                torch, lambda: detect_and_compute_batch(x, akaze))
            log(f"ladder, {label}: {fronts[label]['host_launches']} host "
                "launches in a warmed call (front graph, ladder graph; the "
                "profiler's runtime events)")

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_bytes = torch.cuda.memory_allocated()
            orient_describe(kps, packed, level_hw, cap, akaze, grids)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base_bytes
            # Device times from CUDA events, not the profiler (whose trace
            # misattributes CUDA-graph kernels between sessions): the eager
            # stage and the copies and clones as replays of a CUDA graph of
            # their own, the ladder's call back to back (device-bound).
            ms = {n: graph_ms(torch, lambda n=n: orient_describe(
                kps, packed, level_hw, n, akaze, grids), reps=2)
                  for n in (cap, rung, live)}
            fields = [kps.xy, kps.size, kps.class_id, kps.octave, kps.valid,
                      packed, level_hw, *(grids or ())]
            call_ms = cuda_ms(torch, lambda: adaptive_orient_describe(
                kps, packed, level_hw, akaze, grids), reps=10)
            copy_ms = graph_ms(torch, lambda: [
                s.copy_(t) for s, t in zip(graph.static, fields)], reps=5)
            clone_ms = graph_ms(torch, lambda: (graph.angle.clone(),
                                                graph.desc.clone()), reps=5)
            copy_mb = sum(t.numel() * t.element_size() for t in fields) / 1e6
            first_what = (
                f"warm-up, capture, launch: warm-up {graph.warmup_s:.3f} s, "
                f"{graph.warmup_launches} kernel-B launches; "
                f"capture {graph.capture_s:.3f} s" if captured
                else "its key's graph was cached")
            log(f"ladder, {label}: live {live} of {cap}, rung {host} ({rung} "
                f"slots of {buckets}) on the device; first call "
                f"{first_s:.3f} s ({first_what}); pool "
                f"{graph.pool_bytes / 2**20:.1f} MiB beside the eager "
                f"all-slot stage's peak {peak / 2**20:.1f} MiB "
                f"({graph.pool_bytes / peak:.2f}x); stage device ms "
                f"{ms[cap]:.4f} at capacity, {ms[rung]:.4f} at the rung, "
                f"{ms[live]:.4f} on the live prefix; the graph's call "
                f"{call_ms:.4f} ms back to back (static copies "
                f"{copy_ms:.4f} ms for {copy_mb:.1f} MB, output clones "
                f"{clone_ms:.4f} ms); "
                f"kernel B at K = {x.shape[0] * rung}, S = {twin['shapes_S']}")
            out[label] = {
                "live": live, "capacity": cap, "rung": host,
                "rung_slots": rung, "K": x.shape[0] * rung,
                "first_call_s": first_s, "captured": captured,
                "warmup_s": graph.warmup_s,
                "capture_s": graph.capture_s,
                "warmup_launches": graph.warmup_launches,
                "pool_mib": graph.pool_bytes / 2**20,
                "eager_peak_mib": peak / 2**20,
                "capacity_ms": ms[cap], "rung_ms": ms[rung],
                "live_ms": ms[live], "graph_call_ms": call_ms,
                "copy_ms": copy_ms, "copy_mb": copy_mb,
                "clone_ms": clone_ms, "kernel_b_events": events,
                "kernel_b_on_device": counted["sample_patches"],
                "kernel_b_S": twin["shapes_S"]}
        check(chosen[mode] == {"first", "middle", "last"}, f"{mode}: the "
              f"device chose the first, a middle and the last rung "
              f"({sorted(chosen[mode])})")
    n_graphs = ladder.clear_ladder_graphs()
    n_front = akaze_mod.clear_front_graphs()
    secs = time.perf_counter() - t_phase
    log(f"ladder phase: {secs:.1f} s; {n_graphs} cached ladder graphs and "
        f"{n_front} front-half graphs cleared")
    return {"seconds": secs, "cases": out, "fronts": fronts}


# ---- slice 4: a feature DB built on the card --------------------------------

MOSAIC_N = 8192
MEMBER_N = 4096
BUILD_BATCH = 8
PX_DEG = 1e-5                                    # mosaic px → degrees
# (LoD, tile index) of the tiles whose store rows the CPU path re-derives.
BUILD_SAMPLE = ((0, 0), (0, 1000), (1, 37), (1, 200), (2, 40), (3, 9),
                (4, 2), (5, 0))
TILED_CAP = 262143
SWEEP = (128, 256, 512, 1024, 2048, 4096, 8192)


def synth_satellite(n, seed=3):
    """bench_feature_extraction.py:synth_satellite — multi-scale synthetic
    terrain in [0, 1] (the stand-in for Denmark_8192.png)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((n, n), np.float32)
    scale = n
    while scale >= 8:
        k = max(n // scale, 1)
        noise = rng.standard_normal((k, k)).astype(np.float32)
        img += np.kron(noise, np.ones((scale, scale), np.float32))[:n, :n] \
            * (scale / n)
        scale //= 2
    img -= img.min()
    img /= max(img.max(), 1e-6)
    return img


def build_image(terrain):
    """The build mosaic's gray, from seed 42: the terrain at 35% with
    bench.py's corner-rich rectangles (120 per 512² on average, 8–40 px,
    0.2–1.0) painted over it. synth_satellite alone leaves the 256² tiles
    of LoDs 0–2 without a keypoint."""
    rng = np.random.default_rng(SEED)
    img = 0.35 * terrain
    n = img.shape[0]
    count = 120 * n * n // (512 * 512)
    cy, cx = rng.integers(0, n - 40, (2, count))
    side = rng.integers(8, 40, count)
    val = rng.uniform(0.2, 1.0, count).astype(np.float32)
    for y, x, s, v in zip(cy, cx, side, val):
        img[y:y + s, x:x + s] = v
    return img


def write_build_mosaic(root, image):
    """The build's input: `image` as an 8192² three-band uint8 mosaic in
    2×2 GeoTIFF members of 4096² with north-up geotransforms, a seeded
    float32 elevation raster (64², 100–101 m) over the same extent in a
    folder of its own, and a 1024² crop of the mosaic's corner (the
    second run's input)."""
    import os

    from cubesat_apds_tpu_torch.io.tiff import write_geotiff

    tiles = os.path.join(root, "mosaic")
    os.makedirs(tiles)
    rgb = np.round(np.stack([image, 0.85 * image + 0.1,
                             0.7 * image + 0.2], -1) * 255).astype(np.uint8)
    for ty in range(MOSAIC_N // MEMBER_N):
        for tx in range(MOSAIC_N // MEMBER_N):
            write_geotiff(
                os.path.join(tiles, f"m{ty}{tx}.tif"),
                rgb[ty * MEMBER_N:(ty + 1) * MEMBER_N,
                    tx * MEMBER_N:(tx + 1) * MEMBER_N],
                [10.0 + tx * MEMBER_N * PX_DEG, PX_DEG, 0.0,
                 56.0 - ty * MEMBER_N * PX_DEG, 0.0, -PX_DEG])
    elev_dir = os.path.join(root, "elevation")
    os.makedirs(elev_dir)
    elev = os.path.join(elev_dir, "dem.tif")
    step = MOSAIC_N * PX_DEG / 64
    write_geotiff(elev, np.random.default_rng(SEED).uniform(
        100.0, 101.0, (64, 64)).astype(np.float32),
        [10.0, step, 0.0, 56.0, 0.0, -step])
    crop = os.path.join(root, "crop")
    os.makedirs(crop)
    write_geotiff(os.path.join(crop, "c.tif"), rgb[:1024, :1024],
                  [10.0, PX_DEG, 0.0, 56.0, 0.0, -PX_DEG])
    return tiles, elev, crop


def _rows_per_lod(store):
    lod_of = {r.id: r.level_of_detail for r in store._images.values()}
    lut = np.zeros(max(lod_of) + 1, np.int64)
    lut[list(lod_of)] = list(lod_of.values())
    return np.bincount(lut[store._kp["image_id"]],
                       minlength=max(lod_of.values()) + 1).tolist()


def _same_store(a, b):
    """Two in-memory FeatureStores: the same rows, every column and the
    descriptors, bit for bit."""
    return (np.array_equal(a._desc, b._desc) and set(a._kp) == set(b._kp)
            and all(np.array_equal(a._kp[k], b._kp[k]) for k in a._kp))


def build_phase(torch, dev, root, image):
    """preprocess of the 8192² mosaic read lazily from its GeoTIFF members,
    the default PipelineConfig and tile_batch 8: 6 LoDs, 1,365 tiles of
    256². Kernel A 15 and kernel B 2 launches per tile batch, none of
    kernel 4. The build runs four times, paired: adaptive_buckets=1 (every
    slot), the ladder (the phase's build), the ladder, every slot; the
    stores' rows equal bit for bit, and the times are a record beside the
    card's name and power limit. Returns the store, the dataset and the
    build's numbers."""
    import dataclasses

    from cubesat_apds_tpu_torch.core.config import PipelineConfig
    from cubesat_apds_tpu_torch.io.mosaic import MosaicDataset
    from cubesat_apds_tpu_torch.io.tiff import LazyGeoRaster
    from cubesat_apds_tpu_torch.ops.image import lod_tile_grid
    from cubesat_apds_tpu_torch.pipelines.preprocess import preprocess

    t0 = time.perf_counter()
    tiles_dir, elev, crop = write_build_mosaic(root, image)
    ds = MosaicDataset.from_folder(tiles_dir, lazy=True, device=dev)
    log(f"build mosaic written in {time.perf_counter() - t0:.2f} s: "
        f"{ds.get_dimensions()} px in {len(ds.members)} GeoTIFF members "
        f"of {MEMBER_N}², an elevation raster beside them")
    check(all(isinstance(m, LazyGeoRaster) for m in ds.members),
          "mosaic members open lazily (native windowed decode)")
    config = PipelineConfig()
    every_slot = dataclasses.replace(config, akaze=dataclasses.replace(
        config.akaze, adaptive_buckets=1))

    def build(cfg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = preprocess(ds, config=cfg, tile_batch=BUILD_BATCH,
                         elevation_path=elev)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # A paired record, every slot / ladder / ladder / every slot; the
    # first ladder build is the phase's build.
    (flat_store, _), flat_s = build(every_slot)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    (store, stats), secs = build(config)
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    (store2, _), secs2 = build(config)
    (flat_store2, _), flat_s2 = build(every_slot)
    log(f"paired build, {card_line()}: every slot (adaptive_buckets=1) "
        f"{flat_s:.3f} s, ladder {secs:.3f} s, ladder {secs2:.3f} s, every "
        f"slot {flat_s2:.3f} s; medians every slot "
        f"{np.median([flat_s, flat_s2]):.3f} s, ladder "
        f"{np.median([secs, secs2]):.3f} s "
        f"({np.median([flat_s, flat_s2]) / np.median([secs, secs2]):.3f}x)")
    check(all(_same_store(store, other)
              for other in (flat_store, store2, flat_store2)),
          "paired build: the ladder's store rows equal every slot's bit "
          "for bit")
    del flat_store, store2, flat_store2
    grid = lod_tile_grid(MOSAIC_N, MOSAIC_N, stats.lods)
    batches = sum(-(-len(g[4]) * len(g[5]) // BUILD_BATCH) for g in grid)
    per_lod = _rows_per_lod(store)
    per_batch = {k: v / batches for k, v in launches.items()}
    log(f"build: {stats.lods} LoDs, {stats.tiles} tiles in {batches} "
        f"batches of {BUILD_BATCH}, {stats.keypoints} keypoints "
        f"(per LoD {per_lod}) in {secs:.2f} s = {stats.tiles / secs:.2f} "
        f"tiles/s; launches per tile batch {per_batch}; peak device memory "
        f"{peak / 2**30:.2f} GiB (since the window's last graph capture, "
        "which resets the statistic)")
    check(stats.lods == 6 and stats.tiles == 1365
          and [len(g[4]) * len(g[5]) for g in grid]
          == [1024, 256, 64, 16, 4, 1], "6 LoDs, 1,365 tiles of 256²")
    check(launches == {"fed_cycle": 15 * batches + launches.warmup_a,
                       "sample_patches": 2 * batches + launches.warmup,
                       "knn2_hamming": 0},
          "15 kernel-A and 2 kernel-B launches per tile batch, no kNN-2 "
          f"({launches.warmup_a} kernel-A launches in front-half warm-ups, "
          f"{launches.warmup} kernel-B launches in ladder warm-ups)")
    check(store._elevation is not None and 2 in store._geotransforms,
          "the store holds the elevation raster and its geotransform")
    log(f"build, {card_line()}: {secs:.3f} s; kernel A "
        f"{launches['fed_cycle']} launches on its device counter for "
        f"{batches} tile batches ({launches.warmup_a} in front-half "
        "warm-ups)")
    from cubesat_apds_tpu_torch.ops.features.akaze import (
        detect_and_compute_batch)

    tiles = build_tiles(torch, dev, image)
    front = front_against_eager(torch, f"build batch {BUILD_BATCH} x 256²",
                                tiles, config.akaze)
    front["host_launches"] = host_launches(
        torch, lambda: detect_and_compute_batch(tiles, config.akaze))
    pools = graph_pools_mib()
    log(f"build: {front['host_launches']} host launches in a warmed tile "
        f"batch (the profiler's runtime events); every cached graph's pool "
        f"at the build phase's end, MiB: {pools} (total "
        f"{sum(pools.values()):.1f})")
    return store, ds, {"seconds": secs, "tiles": stats.tiles,
                       "front": front, "graph_pools_mib": pools,
                       "paired_s": {"every slot": [flat_s, flat_s2],
                                    "ladder": [secs, secs2]},
                       "tiles_per_s": stats.tiles / secs,
                       "keypoints": stats.keypoints,
                       "keypoints_per_lod": per_lod,
                       "launches_per_batch": per_batch,
                       "peak_gib": peak / 2**30}, tiles_dir, crop


def build_cpu_check(torch, store, ds, tiles_dir):
    """The sample tiles re-derived on the CPU: the card's gray tile through
    the port's CPU path gives the card's store rows bit for bit; the same
    tiles' to_rgb, card against CPU, with the largest uint8 difference
    and the share of pixels that differ."""
    from cubesat_apds_tpu_torch.core.config import PipelineConfig
    from cubesat_apds_tpu_torch.io.mosaic import MosaicDataset
    from cubesat_apds_tpu_torch.ops.features.akaze import (
        detect_and_compute_batch)
    from cubesat_apds_tpu_torch.ops.image import lod_tile_grid
    from cubesat_apds_tpu_torch.pipelines.preprocess import (
        _host_arrays, tile_gray, tile_rows)

    akaze = PipelineConfig().akaze
    ds_cpu = MosaicDataset.from_folder(tiles_dir, lazy=True, device="cpu")
    lods = 1 + max(r.level_of_detail for r in store._images.values())
    grid = lod_tile_grid(MOSAIC_N, MOSAIC_N, lods)
    t0 = time.perf_counter()
    worst, differ = 0, []
    for lod, k in BUILD_SAMPLE:
        tw, th, sx, sy, off_x, off_y, bx, by = grid[lod]
        r, c = divmod(k, len(off_x))
        rec = sorted(store.find_images_from_lod(lod), key=lambda r: r.id)[k]
        check((rec.x_start, rec.y_start) == (off_x[c], off_y[r]),
              f"LoD {lod} tile {k}: record at ({off_x[c]}, {off_y[r]})")
        gray = tile_gray(ds, off_x[c], off_y[r], sx, sy, tw, th).cpu()
        rows = tile_rows(_host_arrays(detect_and_compute_batch(
            gray[None], akaze)), 0, lod, off_x[c], off_y[r],
            (bx[c], bx[c + 1], by[r], by[r + 1]))
        cols, desc = store.read_keypoints_from_image_id(rec.id)
        names = ("x", "y", "size", "angle", "response", "octave",
                 "class_id")
        n_cpu = 0 if rows is None else len(rows[0])
        diff = {}
        if n_cpu and n_cpu == len(desc):
            order = np.argsort(-rows[4], kind="stable")
            diff = {n: int((cols[n] != rows[i][order]).sum())
                    for i, n in enumerate(names)}
            diff["desc"] = int((desc != rows[7][order]).any(1).sum())
        same = n_cpu == len(desc) and not any(diff.values())
        check(same, f"LoD {lod} tile {k}: {len(desc)} store rows equal the "
              f"CPU path's on the card's gray tile, bit for bit"
              + ("" if same else f" (CPU {n_cpu} rows; rows differing "
                 f"per field {diff})"))
        a = ds.to_rgb((off_x[c], off_y[r]), (sx, sy), (tw, th))
        b = ds_cpu.to_rgb((off_x[c], off_y[r]), (sx, sy), (tw, th))
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        worst = max(worst, int(d.max()))
        differ.append(float((d > 0).any(-1).mean()))
    log(f"to_rgb of the {len(BUILD_SAMPLE)} sample tiles, card against "
        f"CPU: largest uint8 difference {worst}, share of pixels that "
        f"differ {np.mean(differ):.6f} (per tile {differ}); CPU check "
        f"{time.perf_counter() - t0:.1f} s")
    return {"to_rgb_max_diff": worst, "to_rgb_share_differ":
            float(np.mean(differ))}


def build_breakdown(torch, ds, lods, build_s):
    """Where the build's time goes, from the first batch of each LoD timed
    again after the build (host clock to a sync, median of 3): the mosaic
    window reads, resample and gray of the batch (tile_gray), the feature
    step on it (detect_and_compute_batch), and its copy to the host and
    store rows (tile_rows), each times the LoD's batch count; and one
    LoD-0 step's device-busy time and kernel count under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cubesat_apds_tpu_torch.core.config import PipelineConfig
    from cubesat_apds_tpu_torch.ops.features.akaze import (
        detect_and_compute_batch)
    from cubesat_apds_tpu_torch.ops.image import lod_tile_grid
    from cubesat_apds_tpu_torch.pipelines.preprocess import (
        _host_arrays, tile_gray, tile_rows)

    akaze = PipelineConfig().akaze

    def timed(fn):
        times, out = [], None
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return float(np.median(times)), out

    total = {"read": 0.0, "step": 0.0, "rows": 0.0}
    rows_ms = []
    first = None
    for lod, (tw, th, sx, sy, off_x, off_y, bx, by) in enumerate(
            lod_tile_grid(MOSAIC_N, MOSAIC_N, lods)):
        tiles = [(r, c) for r in range(len(off_y)) for c in range(len(off_x))]
        batch = tiles[:BUILD_BATCH]
        batches = -(-len(tiles) // BUILD_BATCH)
        t_read, grays = timed(lambda: [tile_gray(ds, off_x[c], off_y[r], sx,
                                                 sy, tw, th)
                                       for r, c in batch])
        x = torch.stack(grays)
        first = x if first is None else first
        t_step, feats = timed(lambda: detect_and_compute_batch(x, akaze))

        def store_rows():
            host = _host_arrays(feats)
            return [tile_rows(host, bi, lod, off_x[c], off_y[r],
                              (bx[c], bx[c + 1], by[r], by[r + 1]))
                    for bi, (r, c) in enumerate(batch)]

        t_rows, _ = timed(store_rows)
        for k, t in (("read", t_read), ("step", t_step), ("rows", t_rows)):
            total[k] += batches * t
        rows_ms.append(f"LoD {lod} ({batches} x {len(batch)} tiles): read "
                       f"{t_read * 1e3:.1f}, step {t_step * 1e3:.1f}, host "
                       f"copy and rows {t_rows * 1e3:.1f} ms")
    detect_and_compute_batch(first, akaze)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        detect_and_compute_batch(first, akaze)
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    log("build breakdown, per batch: " + "; ".join(rows_ms))
    log(f"build breakdown, the batch counts applied: reads {total['read']:.2f}"
        f" s, feature steps {total['step']:.2f} s, host copies and rows "
        f"{total['rows']:.2f} s, sum {sum(total.values()):.2f} s of the "
        f"build's {build_s:.2f} s; one LoD-0 step: {len(kern)} device "
        f"kernels, {busy_ms:.3f} ms device-busy")
    return {"breakdown_s": total, "step_kernels": len(kern),
            "step_device_busy_ms": busy_ms}


def store_write_phase(torch, dev, root, store, crop_dir):
    """write_binary_store of the build; a second run (preprocess of a
    1024² crop of the mosaic, one LoD) appended; its tile deleted and the
    store compacted back to the build's rows, query for query."""
    import os

    from cubesat_apds_tpu_torch.core.config import PipelineConfig
    from cubesat_apds_tpu_torch.io.mosaic import MosaicDataset
    from cubesat_apds_tpu_torch.pipelines.preprocess import preprocess
    from cubesat_apds_tpu_torch.store.binary_store import (
        BinaryFeatureStore, append_binary_store, compact_binary_store,
        write_binary_store)

    path = os.path.join(root, "db")
    t0 = time.perf_counter()
    write_binary_store(store, path)
    t_write = time.perf_counter() - t0
    second, st2 = preprocess(
        MosaicDataset.from_folder(crop_dir, lazy=True, device=dev),
        config=PipelineConfig(), amount_lod=1)
    t0 = time.perf_counter()
    append_binary_store(path, second)
    t_append = time.perf_counter() - t0
    b = BinaryFeatureStore(path)
    new_id = max(b.images)
    check(len(b.segments) == 2 and b.n == len(store) + len(second)
          and new_id == len(store._images) + 1
          and b.images[new_id].level_of_detail == 0,
          f"append: a second segment of {len(second)} rows (a 1024² tile "
          f"at LoD 0), image id {new_id}")
    b.delete_image(new_id)
    t0 = time.perf_counter()
    kept, dropped = compact_binary_store(path)
    t_compact = time.perf_counter() - t0
    c = BinaryFeatureStore(path)
    check((kept, dropped) == (len(store), len(second))
          and len(c.segments) == 1, f"compact: {kept} rows kept, {dropped} "
          "dropped, one segment")
    for lod in sorted({r.level_of_detail for r in store._images.values()}):
        (cc, cd), (sc, sd) = (c.read_keypoints_from_lod(lod),
                              store.read_keypoints_from_lod(lod))
        check(np.array_equal(cd, sd) and all(np.array_equal(cc[k], sc[k])
                                             for k in sc),
              f"LoD {lod}: the compacted store answers as the build")
    log(f"binary store: written in {t_write:.2f} s, second run's "
        f"{st2.keypoints} rows appended in {t_append:.2f} s, compacted in "
        f"{t_compact:.2f} s")
    return path


def serve_phase(torch, dev, path, ds, rows_per_lod):
    """The built store served: the finest LoD of at most 262,143 rows
    loaded on the card; a 512² frame read from the mosaic at that LoD's
    scale localized through localize_frame and Localizer, with PnP in
    ECEF. H must map the frame's corners to the crop's mosaic corners
    within 2^lod mosaic px."""
    from cubesat_apds_tpu_torch.core.config import MAX_POINTS
    from cubesat_apds_tpu_torch.core.types import CameraModel
    from cubesat_apds_tpu_torch.ops.image import rgb_to_gray
    from cubesat_apds_tpu_torch.pipelines.localize import (
        Localizer, localize_frame)
    from cubesat_apds_tpu_torch.store import open_store

    store = open_store(path)
    lod = next(k for k, n in enumerate(rows_per_lod) if n <= MAX_POINTS)
    s = 2 ** lod
    x0 = y0 = MOSAIC_N // 2 - 256 * s + 3 * s
    rgba = ds.to_rgb((x0, y0), (512 * s, 512 * s), (512, 512))
    frame = rgb_to_gray(torch.from_numpy(rgba[..., :3]).to(dev))
    camera = CameraModel.ideal(500.0, 500.0, 256.0, 256.0)
    config = serving_config()
    loc = Localizer(store, camera, config, device=dev)
    loc.localize(frame, lod=lod)                       # load + warm-up
    torch.cuda.synchronize()
    _reset_launches()
    res = loc.localize(frame, lod=lod)
    torch.cuda.synchronize()
    launches = _read_launches()
    one = localize_frame(frame, store, camera, lod, config, device=dev)
    n_rows = int(loc.device_db(lod).valid.sum())
    H = res.homography.H.cpu().numpy().astype(np.float64)
    c = np.array([[0, 0, 1], [512, 0, 1], [0, 512, 1], [512, 512, 1]],
                 np.float64)
    p = c @ H.T
    got = p[:, :2] / p[:, 2:]
    want = np.array([[x0, y0], [x0 + 512 * s, y0], [x0, y0 + 512 * s],
                     [x0 + 512 * s, y0 + 512 * s]], np.float64)
    err = float(np.abs(got - want).max())
    log(f"serve check: LoD {lod} ({n_rows} rows; 2^{lod} mosaic px a "
        f"frame px), frame at ({x0}, {y0}); keypoints "
        f"{int(res.num_keypoints)} matches {int(res.num_matches)} H inliers "
        f"{int(res.homography.num_inliers)} pose ok {bool(res.pose.ok)} pose "
        f"inliers {int(res.pose.num_inliers)}; corner error {err:.4f} "
        f"mosaic px; launches {launches}")
    check(n_rows == rows_per_lod[lod] and n_rows <= MAX_POINTS,
          f"LoD {lod}'s {n_rows} rows loaded")
    check(launches["knn2_hamming"] == (1 if n_rows > config.match.db_block
                                       else 0),
          "kNN-2 launched once where the LoD passes db_block rows")
    check(bool(res.homography.ok) and err <= s,
          f"H maps the frame's corners to the crop's within {s} mosaic px")
    check(res.pose is not None and bool(res.pose.ok)
          and loc.device_db(lod).world_frame == "ecef",
          "pose solved and ok against ECEF world points")
    check(_corner_err(one.homography.H.cpu().numpy(), H) <= 0.01
          and bool(one.pose.ok), "localize_frame(frame, store, camera, lod) "
          "agrees with Localizer")
    return {"lod": lod, "rows": n_rows, "corner_err_px": err,
            "launches": launches}


def tiled_phase(torch, dev, terrain, image):
    """detect_and_compute_tiled on the 8192² terrain at capacity 262,143
    (tile 1024, overlap 64: 81 tiles) with the seam invariants; a 2048²
    tiled run (9 tiles) of the build image's corner, where the terrain
    alone has no keypoint, against the port's CPU run, bit for bit; then
    bench_feature_extraction.py's 128…8192 sweep."""
    from scipy.spatial import cKDTree

    from cubesat_apds_tpu_torch.core.config import AkazeConfig
    from cubesat_apds_tpu_torch.ops.features.akaze import (
        detect_and_compute, detect_and_compute_tiled)

    cfg = AkazeConfig()
    img = torch.from_numpy(terrain).to(dev)

    def run():
        return detect_and_compute_tiled(img, cfg, capacity=TILED_CAP,
                                        tile=1024, overlap=64)

    run()                                               # warm-up
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _read_launches()
    kp = out.keypoints
    v = kp.valid.cpu().numpy()
    n = int(v.sum())
    xy = kp.xy.cpu().numpy()[:n]
    cls = kp.class_id.cpu().numpy()[:n]
    resp = kp.response.cpu().numpy()[:n]
    log(f"tiled 8192² at capacity {TILED_CAP}: {n} keypoints in "
        f"{secs:.3f} s; launches {launches}")
    check(launches["fed_cycle"] == 15 * 81 + launches.warmup_a
          and launches["sample_patches"] == 2 * 81 + launches.warmup,
          "81 tiles: 15 kernel-A and 2 kernel-B launches each "
          f"({launches.warmup} kernel-B launches in ladder warm-ups)")
    check(0 < n <= TILED_CAP and v[:n].all() and not v[n:].any(),
          "count within capacity, a valid prefix")
    check(bool((np.diff(resp) <= 0).all()), "response order holds")
    check(bool((xy >= -1).all() and (xy < MOSAIC_N + 1).all()),
          "coordinates fall in the image")
    pairs = cKDTree(xy).query_pairs(0.5, output_type="ndarray")
    near = pairs[np.abs(cls[pairs[:, 0]] - cls[pairs[:, 1]]) <= 1] \
        if len(pairs) else pairs
    d2 = ((xy[near[:, 0]] - xy[near[:, 1]]) ** 2).sum(-1) if len(near) \
        else np.zeros(0)
    check(not (d2 < 0.25).any(), "no surviving pair within 0.5 px and "
          "≤ 1 level (the seam rule)")
    from cubesat_apds_tpu_torch.ops.features.scale_space import (
        compute_k_percentile)

    dec = MOSAIC_N // 2048
    kc = compute_k_percentile(img[::dec, ::dec], cfg.kcontrast_percentile,
                              1.0, cfg.kcontrast_nbins)
    front = front_against_eager(
        torch, "tiled 1024² tile, the global contrast factor",
        img[:1024, :1024][None].contiguous(), cfg,
        capacity=max(TILED_CAP // (81 // 2), 256), kcontrast=kc)

    sub = image[:2048, :2048]
    t0 = time.perf_counter()
    card = detect_and_compute_tiled(torch.from_numpy(sub).to(dev), cfg,
                                    tile=1024, overlap=64)
    torch.cuda.synchronize()
    cpu = detect_and_compute_tiled(sub, cfg, tile=1024, overlap=64,
                                   device="cpu")
    same = torch.equal(card.descriptors.cpu(), cpu.descriptors) and all(
        torch.equal(getattr(card.keypoints, k).cpu(),
                    getattr(cpu.keypoints, k))
        for k in ("xy", "size", "angle", "response", "octave", "class_id",
                  "valid"))
    n_sub = int(cpu.keypoints.valid.sum())
    check(same and n_sub > 0, f"2048² tiled (9 tiles), card against the "
          f"port's CPU run: bit for bit ({n_sub} keypoints, "
          f"{time.perf_counter() - t0:.1f} s)")

    sweep = {}
    for size in SWEEP:
        x = img if size == MOSAIC_N else torch.from_numpy(
            synth_satellite(size, SEED)).to(dev)
        iters = 5 if size <= 1024 else 3 if size <= 2048 else 2

        def call():
            if size <= 2048:
                return detect_and_compute(x, AkazeConfig(capacity=4096))
            return detect_and_compute_tiled(x, AkazeConfig(capacity=4096),
                                            tile=1024, overlap=64,
                                            tile_batch=4)

        f = call()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            f = call()
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b) / iters
        sweep[size] = ms
        log(f"  sweep {size}²{' tiled' if size > 2048 else ''}: {ms:.2f} ms "
            f"per call over {iters} ({int(f.keypoints.valid.sum())} "
            f"keypoints)")
    return {"tiled_8192_s": secs, "keypoints": n, "launches": launches,
            "sweep_ms": sweep, "front": front}


def build_kernel_phase(torch, dev, k_rung):
    """Kernels A and B against their twins at the build path's shapes:
    kernel A at every level of a 256² tile batch of 8 and of a 1024² tile
    (the halo-tile form of TPU row 2), kernel B on 8 stacks of 256² at the
    build batch's rung (the ladder's K a stack) and at the build's
    capacity. Bit-exact, with device time and the byte bound."""
    from cubesat_apds_tpu_torch.core.config import AkazeConfig
    from cubesat_apds_tpu_torch.ops.features.scale_space import (
        evolution_metadata, fed_tau_by_process_time)
    from cubesat_apds_tpu_torch.ops.kernels import diffusion, sample_kernel

    rng = np.random.default_rng(SEED + 4)
    cfg = AkazeConfig()
    meta = evolution_metadata(cfg)
    out = {}
    for size, batch in ((256, BUILD_BATCH), (1024, 1)):
        us = 0.0
        for i in range(1, len(meta)):
            n = size >> meta[i].octave
            taus = fed_tau_by_process_time(
                meta[i].etime - meta[i - 1].etime, cfg.fed_tau_max)
            L = torch.from_numpy(rng.uniform(0, 1, (batch, n, n)).astype(
                np.float32)).to(dev)
            g = torch.from_numpy(rng.uniform(0.2, 1, (batch, n, n)).astype(
                np.float32)).to(dev)
            got = diffusion.fed_cycle_cuda(L, g, taus)
            check(torch.equal(got, diffusion.fed_cycle(L, g, taus)),
                  f"kernel A at {size}² B={batch}, level {i} ({n}², "
                  f"n={len(taus)}) bit-exact")
            us += graph_ms(torch, lambda: diffusion.fed_cycle_cuda(
                L, g, taus)) * 1e3
        log(f"kernel A, the 15 cycles of a {size}² tile at B={batch}: "
            f"device {us / 1e3:.4f} ms per call ({us / batch / 1e3:.4f} ms "
            f"per tile)")
        out[f"{size}_b{batch}_device_ms"] = us / 1e3
    L, H = 16, 256
    stacks = torch.from_numpy(rng.standard_normal(
        (BUILD_BATCH, L, H, H, 4)).astype(np.float32)).to(dev)
    stacks[..., 3] = 0
    stacks = stacks.to(torch.bfloat16)
    level_hw = torch.tensor([[H >> (i // 4), H >> (i // 4)] for i in range(L)],
                            dtype=torch.int32, device=dev)
    # The build batch's rung (the ladder's K a stack), then the capacity.
    for K, at in ((k_rung, ""), (cfg.capacity, "capacity_")):
        lvl = torch.from_numpy(rng.integers(0, L, (BUILD_BATCH, K))).to(dev)
        for S in (109, 441):
            iy = torch.from_numpy(rng.integers(
                -8, H + 8, (BUILD_BATCH * K, S)).astype(np.int32)).to(dev)
            ix = torch.from_numpy(rng.integers(
                -8, H + 8, (BUILD_BATCH * K, S)).astype(np.int32)).to(dev)
            fn = sample_kernel.patch_sampler(stacks, level_hw, lvl)
            got = fn(iy, ix)
            same = all(torch.equal(
                got[b * K:(b + 1) * K], sample_kernel.sample_patches_plain(
                    stacks[b], level_hw, lvl[b], iy[b * K:(b + 1) * K],
                    ix[b * K:(b + 1) * K])) for b in range(BUILD_BATCH))
            check(same, f"kernel B on {BUILD_BATCH} stacks of 256², K={K} "
                  f"a stack, S={S}, bit-exact")
            ms = graph_ms(torch, lambda: fn(iy, ix))
            log(f"kernel B, {BUILD_BATCH} x K={K} x S={S} in one launch: "
                f"device {ms:.4f} ms")
            out[f"B_{at}S{S}_device_ms"] = ms
        # Per sample 32 B (iy, ix, one texel read, the result written).
        out[f"B_{at}bound_ms"] = (BUILD_BATCH * K * (109 + 441) * 32
                                  / HBM_BYTES_PER_S * 1e3)
        out[f"B_{at}K"] = BUILD_BATCH * K
    return out


# ---- slices 5 and 6: the mission metric and calibration ---------------------

ACC_SCENES = 4              # per condition (the reference runner: 12)
ACC_TERRAIN_SCENES = 3      # per terrain cell (the reference runner: 6)
ACC_TEXTURES = ("rects", "natural")
# tests/test_accuracy.py's pinned bounds on the medians.
ACC_NOMINAL = dict(att=1.0, pos=25.0, fp=3.0)
ACC_HARD = dict(att=3.0, pos=60.0)              # oblique20 and rot45
ACC_TERRAIN = dict(att=1.5, pos=35.0)
ACC_OK_RATE = 0.75


def accuracy_phase(torch, dev):
    """utils/accuracy.run on the rects and natural textures (7 conditions,
    ACC_SCENES scenes each) and run_terrain (reliefs 20/60/120 m × nadir /
    oblique 20°, ACC_TERRAIN_SCENES each) at full size on the card, held
    to tests/test_accuracy.py's bounds; the launches of kernels A and B in
    each DB build and in the frames; one nominal scene per texture
    through the port on the CPU against the card."""
    from cubesat_apds_tpu_torch.utils import accuracy as A

    builds = []                  # [start (s, launches), end (s, launches)]

    def progress(msg):
        if "building DB" in msg or "DB built" in msg:
            torch.cuda.synchronize()
            mark = (time.perf_counter(), _read_launches())
            if "building DB" in msg:
                builds.append([mark])
            else:
                builds[-1].append(mark)
        log(f"  {msg}")

    scenes = []
    _reset_launches()
    t0 = time.perf_counter()
    planar = {tex: A.run(ACC_SCENES, texture=tex, progress=progress,
                         device=dev, scenes=scenes)["exact"]
              for tex in ACC_TEXTURES}
    n_planar = len(scenes)
    terrain = A.run_terrain(ACC_TERRAIN_SCENES, progress=progress,
                            device=dev, scenes=scenes)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    total = _read_launches()
    n_frames = len(scenes)
    build_s = sum(b[1][0] - b[0][0] for b in builds)
    build_l = {k: sum(b[1][1][k] - b[0][1][k] for b in builds) for k in total}
    frame_l = {k: total[k] - build_l[k] for k in total}
    # Kernel B's launches in the ladder warm-ups of the builds and frames.
    build_w = sum(b[1][1].warmup - b[0][1].warmup for b in builds)
    frame_w = total.warmup - build_w
    # Kernel A's launches in the front-half warm-ups of each.
    build_wa = sum(b[1][1].warmup_a - b[0][1].warmup_a for b in builds)
    frame_wa = total.warmup_a - build_wa
    per_frame = {k: v / n_frames for k, v in frame_l.items()}
    per_build = {k: v / len(builds) for k, v in build_l.items()}
    frames_s = seconds - build_s
    log(f"accuracy phase: {n_frames} frames ({n_planar} planar, "
        f"{n_frames - n_planar} terrain) and {len(builds)} DB builds in "
        f"{seconds:.2f} s; builds {build_s:.2f} s; frames (render + "
        f"localize) {frames_s:.2f} s = {n_frames / frames_s:.3f} frames/s")
    log(f"accuracy launches a frame {per_frame}, a build (one 1024² LoD-0 "
        f"tile) {per_build}; kernel-B launches in ladder warm-ups: "
        f"{frame_w} in the frames, {build_w} in the builds; kernel-A "
        f"launches in front-half warm-ups: {frame_wa} in the frames, "
        f"{build_wa} in the builds")
    check(frame_l["fed_cycle"] == 15 * n_frames + frame_wa
          and frame_l["sample_patches"] == 2 * n_frames + frame_w
          and per_frame["knn2_hamming"] == 0,
          "every accuracy frame launched kernel A 15 times and kernel B "
          "twice (dense match: no kernel 4)")
    check(build_l["fed_cycle"] == 15 * len(builds) + build_wa
          and build_l["sample_patches"] == 2 * len(builds) + build_w,
          "every accuracy DB build launched kernel A 15 times (its 1024² "
          "tile) and kernel B twice")

    log("texture  condition   ok    att med / p90 deg    pos med / p90 m  "
        "  fp med m  inliers")
    for tex, res in planar.items():
        for cond, a in res.items():
            log(f"{tex:8s} {cond:10s} {a['ok_rate']:.2f}  {a['att_med']} / "
                f"{a['att_p90']}  {a['pos_med']} / {a['pos_p90']}  "
                f"{a['fp_med']}  {a['inl_med']}")
    for relief, res in terrain.items():
        for cond, a in res["exact"].items():
            log(f"terrain  {relief}/{cond:9s} {a['ok_rate']:.2f}  "
                f"{a['att_med']} / {a['att_p90']}  {a['pos_med']} / "
                f"{a['pos_p90']}  {a['fp_med']}  PnP {a['pnp_inl_med']}")
    for tex, res in planar.items():
        for cond, a in res.items():
            check(a["ok_rate"] >= ACC_OK_RATE,
                  f"{tex} {cond}: ok rate {a['ok_rate']} >= {ACC_OK_RATE}")
        a = res["nominal"]
        check(a["att_med"] < ACC_NOMINAL["att"]
              and a["pos_med"] < ACC_NOMINAL["pos"]
              and a["fp_med"] < ACC_NOMINAL["fp"],
              f"{tex} nominal: median attitude {a['att_med']} < 1.0 deg, "
              f"position {a['pos_med']} < 25 m, footprint {a['fp_med']} "
              "< 3 m")
        for cond in ("oblique20", "rot45"):
            a = res[cond]
            check(a["att_med"] < ACC_HARD["att"]
                  and a["pos_med"] < ACC_HARD["pos"],
                  f"{tex} {cond}: median attitude {a['att_med']} < 3 deg, "
                  f"position {a['pos_med']} < 60 m")
    for relief, res in terrain.items():
        for cond, a in res["exact"].items():
            check(a["ok_rate"] >= ACC_OK_RATE and a["att_med"] is not None
                  and a["att_med"] < ACC_TERRAIN["att"]
                  and a["pos_med"] < ACC_TERRAIN["pos"],
                  f"terrain {relief} {cond}: ok rate {a['ok_rate']}, median "
                  f"attitude {a['att_med']} < 1.5 deg, position "
                  f"{a['pos_med']} < 35 m")
    fp60 = [r["fp"] for r in scenes
            if r.get("relief") == 60.0 and r["fp"] is not None]
    check(fp60 and max(fp60) > 0.3,
          f"60 m relief: largest homography footprint error "
          f"{max(fp60, default=0):.3f} m > 0.3 m (the planar model is wrong)")
    cpu = accuracy_cpu_check(torch, dev)
    return {"seconds": seconds, "build_s": build_s, "frames": n_frames,
            "frames_per_s": n_frames / frames_s, "builds": len(builds),
            "launches_per_frame": per_frame, "launches_per_build": per_build,
            "planar": planar, "terrain": terrain, "cpu_check": cpu}


def accuracy_cpu_check(torch, dev):
    """The first nominal scene of each texture (the runner's seed and
    draws), one DB built on the card, the frame rendered on the card: the
    port on the CPU gives the same ok flags, a rotation within 0.1° and a
    homography-inlier Jaccard >= 0.95."""
    from cubesat_apds_tpu_torch.pipelines.localize import Localizer
    from cubesat_apds_tpu_torch.utils import accuracy as A
    from cubesat_apds_tpu_torch.utils import synthetic as S

    out = {}
    for tex in ACC_TEXTURES:
        mosaic, plane, ds = A.build_world(2026, tex, device=dev)
        cfg = A.mode_config("exact")
        store = A.build_db(ds, cfg, progress=lambda s: None)
        cam = A.scene_camera(mosaic, plane, A._cond_rng(2026, "nominal"), {})
        frame, _ = S.render_frame(mosaic.bands[0] / 255.0, mosaic.geotransform,
                                  plane, cam, device=dev)
        res = {}
        for d in (dev, "cpu"):
            loc = Localizer(store, A.camera_model(cam, d), cfg, device=d)
            t0 = time.perf_counter()
            res[str(d)] = loc.localize(frame, solve_pose=True)
            if d == dev:
                torch.cuda.synchronize()
            log(f"  {tex} nominal scene on {d}: "
                f"{time.perf_counter() - t0:.2f} s (first call)")
        a, b = res[str(dev)], res["cpu"]
        jac = inlier_jaccard(inlier_pairs(a), inlier_pairs(b))
        dang = rotation_deg(a.pose.rvec.cpu(), b.pose.rvec)
        log(f"{tex} nominal, card vs CPU: pose ok {bool(a.pose.ok)} / "
            f"{bool(b.pose.ok)}, homography ok {bool(a.homography.ok)} / "
            f"{bool(b.homography.ok)}, inlier Jaccard {jac:.4f}, rotation "
            f"diff {dang:.5f} deg")
        check(bool(a.pose.ok) == bool(b.pose.ok)
              and bool(a.homography.ok) == bool(b.homography.ok),
              f"{tex}: card and CPU ok flags agree")
        check(jac >= 0.95, f"{tex}: card and CPU homography-inlier Jaccard "
              ">= 0.95")
        check(dang <= 0.1, f"{tex}: card and CPU rotations within 0.1 deg")
        out[tex] = {"jaccard": jac, "rotation_deg": dang}
    return out


CAL_K = np.array([[600.0, 0.0, 320.0], [0.0, 580.0, 240.0], [0.0, 0.0, 1.0]])
CAL_DIST = np.array([0.08, -0.02, 0.0, 0.0, 0.0])
CAL_VIEWS = 12
CAL_GRID = (7, 6)
CAL_SQUARE_PX = 48          # texture pixels a board square


def calibration_boards(torch, dev, rng, n=CAL_VIEWS, hw=(480, 640)):
    """n views of a 7×6-corner checkerboard at varied poses (tilts of
    ~0.25 rad, in-plane turns of ~0.15 rad, 14–18 squares away, shifted
    about the frame; identical views would degenerate Zhang's method),
    through CAL_K and CAL_DIST: the board texture warped by K·[r1 r2 t]
    with warp_perspective, then distorted by sampling the ideal image
    where each distorted pixel undistorts to."""
    from cubesat_apds_tpu_torch.core.camera import pixels_to_normalized
    from cubesat_apds_tpu_torch.core.types import CameraModel
    from cubesat_apds_tpu_torch.ops.geometry.rodrigues import (
        rodrigues_to_matrix)
    from cubesat_apds_tpu_torch.ops.warp import (
        bilinear_sample, warp_perspective)

    nx, ny = CAL_GRID
    s = CAL_SQUARE_PX
    tex = np.full(((ny + 5) * s, (nx + 5) * s), 0.9, np.float32)
    for r in range(ny + 1):
        for c in range(nx + 1):
            if (r + c) % 2 == 0:
                tex[(r + 2) * s:(r + 3) * s, (c + 2) * s:(c + 3) * s] = 0.1
    # Board units (one square; inner corner (i, j) at (i, j)) → texture px.
    to_tex = np.array([[s, 0, 3 * s - 0.5], [0, s, 3 * s - 0.5], [0, 0, 1]])
    tex_t = torch.from_numpy(tex).to(dev)
    cam = CameraModel(K=torch.tensor(CAL_K, dtype=torch.float32, device=dev),
                      dist=torch.tensor(CAL_DIST, dtype=torch.float32,
                                        device=dev))
    h, w = hw
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    xy_u = pixels_to_normalized(torch.stack([gx, gy], -1), cam)
    src = torch.stack([CAL_K[0, 0] * xy_u[..., 0] + CAL_K[0, 2],
                       CAL_K[1, 1] * xy_u[..., 1] + CAL_K[1, 2]], -1)
    views = []
    for _ in range(n):
        rv = np.array([rng.normal(0, 0.25), rng.normal(0, 0.25),
                       rng.normal(0, 0.15)])
        R = rodrigues_to_matrix(torch.tensor(rv)).numpy()
        t = np.array([rng.uniform(-6.0, 0.0), rng.uniform(-5.0, 0.0),
                      rng.uniform(14.0, 18.0)])
        H = CAL_K @ np.c_[R[:, 0], R[:, 1], t] @ np.linalg.inv(to_tex)
        ideal = warp_perspective(tex_t, torch.tensor(H, dtype=torch.float32),
                                 hw, 0.9)
        views.append(bilinear_sample(ideal, src, 0.9).cpu().numpy())
    return views


def calibration_phase(torch, dev, card):
    """Zhang + LM calibration on the card from CAL_VIEWS rendered boards
    (every view found; fx within 2%, principal point within 3 px, k1
    within 0.02, RMS < 0.2 px: tests/test_calibration.py's bounds); the
    same views on the CPU give K within 1e-3 relative; the LM loop runs
    under set_sync_debug_mode("error"); undistort_frames on 8 frames of
    512², card against CPU within 1e-5."""
    from cubesat_apds_tpu_torch.bench import make_frame
    from cubesat_apds_tpu_torch.core.config import CalibConfig
    from cubesat_apds_tpu_torch.core.types import CameraModel
    from cubesat_apds_tpu_torch.ops.geometry import calibration as C
    from cubesat_apds_tpu_torch.ops.warp import undistort_frames
    from cubesat_apds_tpu_torch.pipelines.calibrate import (
        calibrate_from_images, format_report)

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    views = calibration_boards(torch, dev, rng)
    render_s = time.perf_counter() - t0
    times = {"render_s": render_s}
    for label, d in (("first", dev), ("warm", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        res, found = calibrate_from_images(views, CAL_GRID, device=d)
        K = res.camera.K.cpu().numpy()
        times[f"calibrate_{label}_s"] = time.perf_counter() - t0
        if label == "warm":
            res_card, found_card, K_card = res, found, K
    K_cpu = K
    log(f"calibration ({card}): {CAL_VIEWS} views rendered in "
        f"{render_s:.3f} s; calibrate_from_images on the card "
        f"{times['calibrate_first_s']:.3f} s (first call), "
        f"{times['calibrate_warm_s']:.3f} s (warm); on the CPU "
        f"{times['calibrate_cpu_s']:.3f} s")
    log(format_report(res_card))
    d = res_card.camera.dist.cpu().numpy()
    check(bool(found_card.all()), f"corners found in all {CAL_VIEWS} views")
    check(bool(res_card.ok), "calibration ok")
    check(abs(K_card[0, 0] / CAL_K[0, 0] - 1) < 0.02
          and abs(K_card[1, 1] / CAL_K[1, 1] - 1) < 0.02,
          f"fx, fy {K_card[0, 0]:.3f}, {K_card[1, 1]:.3f} within 2% of "
          f"{CAL_K[0, 0]}, {CAL_K[1, 1]}")
    check(abs(K_card[0, 2] - CAL_K[0, 2]) < 3 and
          abs(K_card[1, 2] - CAL_K[1, 2]) < 3,
          f"principal point ({K_card[0, 2]:.3f}, {K_card[1, 2]:.3f}) within "
          "3 px")
    check(abs(d[0] - CAL_DIST[0]) < 0.02,
          f"k1 {d[0]:.4f} within 0.02 of {CAL_DIST[0]}")
    check(float(res_card.rms) < 0.2, f"RMS {float(res_card.rms):.4f} px < 0.2")
    rel = float(np.abs(K_card - K_cpu).max() / np.abs(K_cpu).max())
    check(rel < 1e-3, f"card and CPU K within 1e-3 relative ({rel:.2e})")

    # The LM loop queues work only: its steps from a perturbed start on the
    # card's own solution, under set_sync_debug_mode("error").
    cfg = CalibConfig()
    obj = C.planar_grid(*CAL_GRID, device=dev)
    Kd = res_card.camera.K
    params = torch.cat([
        torch.stack([Kd[0, 0], Kd[1, 1], Kd[0, 2], Kd[1, 2], Kd[0, 1]]),
        res_card.camera.dist,
        torch.cat([res_card.rvecs, res_card.tvecs], -1).reshape(-1)])
    pts = C._project(params, obj, CAL_VIEWS)
    w = torch.ones(pts.numel() // 2, device=dev)
    start = params * 1.001
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        C._levenberg_marquardt(start, obj, pts, w, cfg.lm_iters,
                               cfg.lm_lambda0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    queued_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    times["lm_queue_s"] = queued_s
    times["lm_s"] = time.perf_counter() - t0
    check(True, f"the LM loop's {cfg.lm_iters} steps ran under "
          f"set_sync_debug_mode('error'): queued in {queued_s:.3f} s, "
          f"done in {times['lm_s']:.3f} s")

    camera = CameraModel(K=torch.tensor(K_card), dist=res_card.camera.dist.cpu())
    frames = np.stack([make_frame(rng) for _ in range(8)])
    ft = torch.from_numpy(frames).to(dev)
    cam_d = CameraModel(K=camera.K.to(dev), dist=camera.dist.to(dev))
    got = undistort_frames(ft, cam_d)
    want = undistort_frames(torch.from_numpy(frames), camera)
    err = float((got.cpu() - want).abs().max())
    und_ms = cuda_ms(torch, lambda: undistort_frames(ft, cam_d), reps=10)
    und_dev_ms = graph_ms(torch, lambda: undistort_frames(ft, cam_d), reps=10)
    bound_ms = 2 * ft.numel() * 4 / HBM_BYTES_PER_S * 1e3
    log(f"undistort_frames, 8 × 512² ({card}): {und_ms:.4f} ms a call "
        f"(eager), device {und_dev_ms:.4f} ms (CUDA-graph replays), byte "
        f"bound {bound_ms:.4f} ms; card against CPU max |diff| {err:.3g}")
    check(err <= 1e-5, "undistort_frames card and CPU within 1e-5")
    times["undistort_8x512_ms"] = und_ms
    times["undistort_8x512_device_ms"] = und_dev_ms
    return {"K": K_card.tolist(), "dist": d.tolist(),
            "rms": float(res_card.rms), "K_rel_cpu": rel,
            "undistort_max_err": err, **times}


# ---- slice 7: the device mesh on one card ----------------------------------

MESH_CHILD_TIMEOUT_S = 300


def mesh_graph_against_eager(torch, label, fn, args):
    """`fn(*args)` through the mesh's CUDA graph of its key
    (parallel.mesh.run_graph) against `fn(*args)` eager: every output
    bit for bit, and the graph's pool within 1.5x the eager call's peak
    (the max_memory_allocated delta of one eager call) plus 64 MiB.
    Prints the key's graph: nodes, pool, the eager peak and seconds."""
    from cubesat_apds_tpu_torch.core import step_graph as core_graph
    from cubesat_apds_tpu_torch.parallel import mesh as mesh_mod

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    want = fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    got = mesh_mod.run_graph(fn, *args)
    entry = mesh_mod.mesh_graphs()[-1]               # the key just used
    torch.cuda.synchronize()
    lg, lw = core_graph.leaves(got), core_graph.leaves(want)
    same = [torch.equal(a, b) for a, b in zip(lg, lw)]
    limit = 1.5 * peak + 64 * 2 ** 20
    log(f"{label}: the mesh graph of {fn.__name__} against the eager call: "
        f"{sum(same)} of {len(lw)} output tensors bit-equal; {entry.nodes} "
        f"nodes, pool {entry.pool_bytes / 2 ** 20:.1f} MiB beside the eager "
        f"peak {peak / 2 ** 20:.1f} MiB (limit {limit / 2 ** 20:.1f} MiB), "
        f"warm-up {entry.warmup_s:.3f} s, capture {entry.capture_s:.3f} s")
    check(len(lg) == len(lw) and all(same),
          f"{label}: the mesh graph equals the eager {fn.__name__} bit for "
          "bit")
    check(entry.pool_bytes <= limit,
          f"{label}: the mesh graph's pool within 1.5x the eager call's "
          "peak plus 64 MiB")
    return {"nodes": entry.nodes, "pool_mib": entry.pool_bytes / 2 ** 20,
            "eager_peak_mib": peak / 2 ** 20, "warmup_s": entry.warmup_s,
            "capture_s": entry.capture_s}


def mesh_knn(torch, dev, db, q_desc):
    """(a): the big DB's 1,048,576 rows and a ragged 1,000,003-row cut of
    it (~5% invalid, padded with invalid rows to a tp multiple) against
    the frame's 2,048 queries through make_sharded_knn2_fused at tp = 2
    and 4 on slots of one card, one mesh graph a call: tp kernel-4
    launches per call, (d0, d1, i0) bit-equal to one kernel-4 launch over
    the whole DB and to the eager partials and merge, the graph's pool
    within its gate; ms graphed, eager and one launch over the whole DB;
    the dense maker on 10,240 rows against ops.match.knn2; the tp = 4
    call again under set_sync_debug_mode("error"). Returns the numbers
    and the tp = 4 result on the full DB (the two-process reference)."""
    from cubesat_apds_tpu_torch.ops import match as M
    from cubesat_apds_tpu_torch.ops.kernels import match_kernel as tmk
    from cubesat_apds_tpu_torch.parallel.mesh import make_mesh
    from cubesat_apds_tpu_torch.parallel.sharded_match import (
        group_top2, make_sharded_knn2, make_sharded_knn2_fused,
        merge_columns)

    q_bits = M.unpack_bits(q_desc)
    q_words = tmk.pack_words(q_desc)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    m_rag = BIG_DB_ROWS - 48_573                    # 1,000,003
    valid_rag = db.valid[:m_rag] & (torch.rand(m_rag, generator=gen,
                                               device=dev) >= 0.05)
    out, ref_tp4 = {}, None
    for label, desc, valid in (("1M", db.descriptors, db.valid),
                               ("ragged 1,000,003", db.descriptors[:m_rag],
                                valid_rag)):
        layout = tmk.layout_db_blocks(tmk.pack_words(desc), valid)
        one = tmk.knn2_hamming_cuda(q_words, *layout)
        one_ms = cuda_ms(torch, lambda: tmk.knn2_hamming_cuda(
            q_words, *layout), reps=5, rounds=3)
        for tp in (2, 4):
            pad = (-desc.shape[0]) % tp
            d_p = torch.cat([desc, desc.new_zeros((pad, 61))])
            v_p = torch.cat([valid, valid.new_zeros(pad)])
            mesh = make_mesh(dp=1, tp=tp, devices=[dev] * tp)
            fn = make_sharded_knn2_fused(mesh, db_block=65536)
            placed = fn.place(d_p, v_p)
            fn(q_bits, placed)                       # warm-up and capture
            torch.cuda.synchronize()
            _reset_launches()
            got = fn(q_bits, placed)
            torch.cuda.synchronize()
            launches = _read_launches()["knn2_hamming"]
            same = [torch.equal(g, r) for g, r in zip(got, one)]
            check(launches == tp, f"sharded kNN-2 {label}, tp={tp} (+{pad} "
                  f"pad rows): kernel 4 launched {launches} times, once "
                  f"per shard")
            check(all(same), f"sharded kNN-2 {label}, tp={tp}: d0, d1, i0 "
                  f"bit-equal to one kernel-4 launch over the whole DB")
            graph = mesh_graph_against_eager(
                torch, f"sharded kNN-2 {label}, tp={tp}", group_top2,
                (q_bits, *fn.group_args(placed, 0, range(tp))))
            m_shard = placed.shape[0] // tp

            def eager(fn=fn, placed=placed, tp=tp, m_shard=m_shard):
                return merge_columns(tp, fn.partials(q_bits, placed),
                                     m_shard, q_bits.shape[0], dev)

            check(all(torch.equal(g, r) for g, r in zip(eager(), one)),
                  f"sharded kNN-2 {label}, tp={tp}: the eager partials and "
                  "merge bit-equal to one launch")
            ms = cuda_ms(torch, lambda: fn(q_bits, placed), reps=5, rounds=3)
            eager_ms = cuda_ms(torch, eager, reps=5, rounds=3)
            partials = fn.partials(q_bits, placed)
            merge_ms = cuda_ms(torch, lambda: merge_columns(
                tp, partials, m_shard, q_bits.shape[0], dev),
                reps=5, rounds=3)
            log(f"  {label}, tp={tp}, {card_line()}: graphed {ms:.4f} ms per "
                f"call, eager {eager_ms:.4f} ms (its merge {merge_ms:.4f} "
                f"ms, {merge_ms / eager_ms:.1%} of it); one launch over the "
                f"whole DB {one_ms:.4f} ms, the graphed call "
                f"{(ms - one_ms) / ms:.1%} above it")
            out[f"{label} tp{tp}"] = {
                "ms": ms, "eager_ms": eager_ms, "merge_ms": merge_ms,
                "one_launch_ms": one_ms, "launches": launches,
                "graph": graph}
            if label == "1M" and tp == 4:
                ref_tp4 = [t.cpu() for t in got]
                torch.cuda.set_sync_debug_mode("error")
                try:
                    fn(q_bits, placed)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
                check(True, "sharded kNN-2 + merge (tp=4) ran under "
                      "set_sync_debug_mode('error')")
    small = M.unpack_bits(db.descriptors[:10240])
    dense = make_sharded_knn2(make_mesh(dp=1, tp=4, devices=[dev] * 4))(
        q_bits, small, db.valid[:10240])
    one = M.knn2(q_bits, small, db_valid=db.valid[:10240])
    check(all(torch.equal(g, r) for g, r in zip(dense, one)),
          "dense sharded kNN-2, 10,240 rows at tp=4: bit-equal to "
          "ops.match.knn2")
    return out, ref_tp4


def eager_mesh_step(torch, mesh, mdb, frames, camera, config, want_pose):
    """The mesh serve step's eager composition on one card: each dp row's
    features (`detect_and_compute_batch`, the front half's and the
    ladder's graphs, as on the path), then `_row_back_half` called
    directly, eagerly (the function a row's graph captures), the rows
    concatenated as the step returns them."""
    from cubesat_apds_tpu_torch.ops.features.akaze import (
        detect_and_compute_batch)
    from cubesat_apds_tpu_torch.parallel.serve import (
        _row_args, _row_back_half, _unflat)

    dp = mesh.shape["dp"]
    lb = frames.shape[0] // dp
    rows = []
    for i in range(dp):
        feats = detect_and_compute_batch(frames[i * lb:(i + 1) * lb],
                                         config.akaze)
        rows.append(_row_back_half(*_row_args(mdb, i, feats, camera, config,
                                              want_pose)))
    return _unflat([torch.cat([r[k] for r in rows])
                    for k in range(len(rows[0]))], want_pose)


def graph_replays(fn):
    """The CUDA-graph replays in one call of `fn()`, by graph: the key's
    function for a front-half, back-half or mesh graph
    (core/step_graph.py), "ladder" for the capacity ladder's."""
    import collections

    from cubesat_apds_tpu_torch.core.step_graph import StepGraph
    from cubesat_apds_tpu_torch.ops.features.ladder import LadderGraph

    seen = collections.Counter()
    step_call, ladder_call = StepGraph.__call__, LadderGraph.__call__

    def step_replay(self, args):
        seen[self.key[0].__name__] += 1
        return step_call(self, args)

    def ladder_replay(self, fields):
        seen["ladder"] += 1
        return ladder_call(self, fields)

    StepGraph.__call__, LadderGraph.__call__ = step_replay, ladder_replay
    try:
        fn()
    finally:
        StepGraph.__call__, LadderGraph.__call__ = step_call, ladder_call
    return dict(seen)


def mesh_serve(torch, dev, loc, pool, config):
    """(b): make_batch_localizer at dp = 2 × tp = 2 on the 8 pool frames
    against the big DB: each dp row's packed outputs bit-equal to the
    single-device batch step on that row's 4 frames (the same batched back
    half), and each frame agreeing with the lone Localizer step as a
    stream frame must (`_agree`); launches of A, B and 4 per batch; the
    graphed step against its eager composition (bits, graph replays a
    row, the row graph's pool beside the eager row's peak, host launches,
    a warmed step with no synchronising call); frames/s, and the eager
    and graphed steps paired in one call."""
    from cubesat_apds_tpu_torch.core.step_graph import leaves
    from cubesat_apds_tpu_torch.core.types import select
    from cubesat_apds_tpu_torch.ops.features.akaze import (
        detect_and_compute_batch)
    from cubesat_apds_tpu_torch.parallel.mesh import make_mesh, mesh_graphs
    from cubesat_apds_tpu_torch.parallel.serve import (
        _row_args, _row_back_half, make_batch_localizer, shard_device_db)
    from cubesat_apds_tpu_torch.pipelines.localize import (
        localize_from_features)
    from cubesat_apds_tpu_torch.pipelines.stream import _pack_outputs

    mesh = make_mesh(dp=2, tp=2, devices=[dev] * 4)
    mdb = shard_device_db(mesh, loc.db, match_config=config.match)
    check(mdb.fused and len({id(v[0]) for v in mdb.shards.parts.values()})
          == 2, "mesh DB: one kernel-4 layout per shard, made at placement")
    step = make_batch_localizer(mesh, loc.camera, config, solve_pose=True)
    frames = torch.stack([torch.from_numpy(f) for f in pool]).to(dev) / 255.0
    step(frames, mdb)                                       # warm-up
    torch.cuda.synchronize()
    _reset_launches()
    homog, pose, n_match, n_kp = step(frames, mdb)
    torch.cuda.synchronize()
    launches = _read_launches()
    log(f"serve step dp=2 x tp=2, batch {len(pool)}: launches {launches}")
    check(launches == {"fed_cycle": 30 + launches.warmup_a,
                       "sample_patches": 4 + launches.warmup,
                       "knn2_hamming": 4},
          "serve step: kernel A 15 and B 2 per dp row, kernel 4 once per "
          f"shard per row ({launches.warmup} kernel-B launches in ladder "
          "warm-ups)")
    got = _pack_outputs(homog, n_match, n_kp, pose)
    lb = len(pool) // 2
    same, agree = [], []
    for i in range(2):
        row = localize_from_features(detect_and_compute_batch(
            frames[i * lb:(i + 1) * lb], config.akaze), loc.db, loc.camera,
            config, True)
        want = _pack_outputs(row.homography, row.num_matches,
                             row.num_keypoints, row.pose)
        same.append(torch.equal(got[i * lb:(i + 1) * lb], want))
        for j in range(lb):
            r = loc.localize(frames[i * lb + j])
            lone = _pack_outputs(r.homography, r.num_matches,
                                 r.num_keypoints, r.pose)
            agree.append(_agree(torch, got[i * lb + j].cpu().numpy(),
                                lone.cpu().numpy(), select(row, j), r)[0])
    check(all(same), f"serve step: each dp row's packed outputs bit-equal "
          f"to the single-device batch step on its {lb} frames "
          f"({sum(same)} of {len(same)} rows)")
    check(all(agree), f"serve step: every frame agrees with the lone step "
          f"({sum(agree)} of {len(agree)})")

    def eager():
        return eager_mesh_step(torch, mesh, mdb, frames, loc.camera, config,
                               True)

    def graphed():
        return step(frames, mdb)

    want = eager()
    bits = [torch.equal(a, b) for a, b in zip(leaves(graphed()),
                                              leaves(want))]
    check(len(bits) == len(leaves(want)) and all(bits),
          f"serve step: the graphed step equals its eager composition bit "
          f"for bit ({sum(bits)} of {len(bits)} output tensors)")
    rows = [e for e in mesh_graphs() if e.key[0] is _row_back_half]
    replays = graph_replays(graphed)
    check(len(rows) == 1 and replays == {"_front_end": 2, "ladder": 2,
                                         "_row_back_half": 2},
          f"serve step: the two dp rows replay one back-half graph, three "
          f"graph replays a row ({len(rows)} row graphs; replays {replays})")
    feats0 = detect_and_compute_batch(frames[:lb], config.akaze)
    graph = mesh_graph_against_eager(
        torch, "serve step dp=2 x tp=2, row 0", _row_back_half,
        _row_args(mdb, 0, feats0, loc.camera, config, True))
    host = {"eager": host_launches(torch, eager),
            "graphed": host_launches(torch, graphed)}
    no_sync(torch, graphed, "serve step dp=2 x tp=2 (graphed)")
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        step(frames, mdb)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    fps = len(pool) / float(np.median(secs))
    legs = {"eager": eager, "graphed": graphed}
    turns = ["eager", "graphed", "graphed", "eager"]
    paired = {m: [] for m in legs}
    for mode in turns:
        legs[mode]()
        torch.cuda.synchronize()
        t = []
        for _ in range(6):
            t0 = time.perf_counter()
            legs[mode]()
            torch.cuda.synchronize()
            t.append(time.perf_counter() - t0)
        paired[mode].append(len(pool) / float(np.median(t)))
    log(f"serve step dp=2 x tp=2, {card_line()}: median "
        f"{np.median(secs) * 1e3:.2f} ms a batch of {len(pool)} = {fps:.2f} "
        f"frames/s; paired (turns {', '.join(turns)}) frames/s eager "
        f"{paired['eager']}, graphed {paired['graphed']}; host launches a "
        f"batch eager {host['eager']}, graphed {host['graphed']}; graph "
        f"replays a batch {replays}; the row graph {graph['nodes']}, pool "
        f"{graph['pool_mib']:.1f} MiB beside the eager row's peak "
        f"{graph['eager_peak_mib']:.1f} MiB")
    return {"frames_per_s": fps, "launches_per_batch": dict(launches),
            "paired_frames_per_s": paired, "host_launches": host,
            "graph_replays": replays, "graph": graph}


def mesh_stream(torch, dev, ctx, config):
    """(c): StreamingLocalizer(mesh=dp 2 × tp 2) over the stream phase's
    1M binary store at batch 8: every frame's packed outputs equal the
    single-device stream's at the batch of one dp row (4: the same frames
    through the same batched back half); frames/s, latency p50/p95, the
    stage times, a step's idle share; then the same stream again (its
    frames/s, the same outputs)."""
    from cubesat_apds_tpu_torch.parallel.mesh import make_mesh
    from cubesat_apds_tpu_torch.pipelines.stream import StreamingLocalizer

    mesh = make_mesh(dp=2, tp=2, devices=[dev] * 4)
    b = STREAM_BATCH
    s = StreamingLocalizer(ctx["db1m"], ctx["camera"], config,
                           solve_pose=True, prefetch=2 * b, batch=b,
                           mesh=mesh)
    frames = ctx["frames"]
    list(s.run(frames[:b]))                                 # warm-up
    torch.cuda.synchronize()
    s.times = type(s.times)()
    _reset_launches()
    t0 = time.perf_counter()
    results = list(s.run(frames))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    steps = -(-len(frames) // b)

    def packed(r):
        return np.concatenate([r.homography.reshape(-1), [
            r.homography_ok, r.num_inliers, r.num_matches, r.num_keypoints],
            r.rvec, r.tvec, [r.pose_ok, r.pose_num_inliers]])

    check([r.frame_id for r in results] == list(range(len(frames))),
          f"mesh stream: {len(frames)} frames back, in order")
    check(launches == {"fed_cycle": 30 * steps + launches.warmup_a,
                       "sample_patches": 4 * steps + launches.warmup,
                       "knn2_hamming": 4 * steps},
          f"mesh stream: kernel A 30, B 4 and kernel 4 4 launches a batch "
          f"({launches} for {steps} batches; {launches.warmup} kernel-B "
          "launches in ladder warm-ups)")
    same = [np.array_equal(packed(r), packed(w))
            for r, w in zip(results, ctx["row_results"])]
    check(all(same), f"mesh stream: every frame equals the single-device "
          f"stream's at batch {b // 2}, a dp row ({sum(same)} of "
          f"{len(same)})")
    lat = sorted(r.latency_s for r in results)
    step_s = wall / steps
    p50, p95 = lat[len(lat) // 2], lat[int(0.95 * len(lat)) - 1]
    fps = len(results) / wall
    report = s.times.report()
    # The same stream again: its rate beside the first run's shows the
    # spread within the call (the host's share of a step varies).
    s.times = type(s.times)()
    t0 = time.perf_counter()
    again = list(s.run(frames))
    torch.cuda.synchronize()
    wall_again = time.perf_counter() - t0
    fps_again = len(again) / wall_again
    check(all(np.array_equal(packed(r), packed(w))
              for r, w in zip(again, results)),
          "mesh stream: a second run gives the first run's outputs")
    x = torch.stack([torch.from_numpy(f) for f in frames[:b]]).to(dev)
    events, busy = device_kernels(torch, lambda: s._step(x))
    host = host_launches(torch, lambda: s._step(x))
    idle = 1.0 - busy / (step_s * 1e3)
    log(f"mesh stream dp=2 x tp=2, batch {b}, {card_line()}: "
        f"{len(results)} frames in {wall:.3f} s = {fps:.2f} frames/s; "
        f"latency p50 {p50:.3f} s ({p50 / step_s:.2f} steps), p95 "
        f"{p95:.3f} s ({p95 / step_s:.2f} steps); launches per batch "
        f"{ {k: v / steps for k, v in launches.items()} } and "
        f"{launches.procrustes / steps} Procrustes; a step: "
        f"{host} host launches, {events} device events, device-busy "
        f"{busy:.3f} ms of {step_s * 1e3:.2f} ms in the stream (idle share "
        f"{idle:.4f}; the profiler may miss graph kernels); the stream "
        f"again {fps_again:.2f} frames/s (idle share "
        f"{1.0 - busy / (wall_again / steps * 1e3):.4f})")
    log("\n".join("    " + ln for ln in report.splitlines()))
    log("  again:\n" + "\n".join("    " + ln for ln in
                                   s.times.report().splitlines()))
    per_batch = {k: v / steps for k, v in launches.items()}
    per_batch["procrustes3"] = launches.procrustes / steps
    return {"frames_per_s": fps, "frames_per_s_again": fps_again,
            "p50_s": p50, "p95_s": p95,
            "p50_steps": p50 / step_s, "p95_steps": p95 / step_s,
            "idle_share": idle, "host_launches_per_step": host,
            "device_events_per_step": events, "launches_per_batch": per_batch}


def mesh_preprocess(torch, dev, image):
    """(d): preprocess(mesh = dp 2) on a 2048² crop of the build mosaic,
    amount_lod 3: the store equals the single-device build, row for row."""
    import os

    from cubesat_apds_tpu_torch.core.config import PipelineConfig
    from cubesat_apds_tpu_torch.io.mosaic import MosaicDataset
    from cubesat_apds_tpu_torch.io.tiff import write_geotiff
    from cubesat_apds_tpu_torch.ops.image import lod_tile_grid
    from cubesat_apds_tpu_torch.parallel.mesh import make_mesh
    from cubesat_apds_tpu_torch.pipelines.preprocess import preprocess

    with tempfile.TemporaryDirectory() as root:
        crop = image[:2048, :2048]
        rgb = np.round(np.stack([crop, 0.85 * crop + 0.1, 0.7 * crop + 0.2],
                                -1) * 255).astype(np.uint8)
        write_geotiff(os.path.join(root, "c.tif"), rgb,
                      [10.0, PX_DEG, 0.0, 56.0, 0.0, -PX_DEG])
        ds = MosaicDataset.from_folder(root, device=dev)
        config = PipelineConfig()
        ref, ref_stats = preprocess(ds, config=config, amount_lod=3,
                                    tile_batch=BUILD_BATCH)
        mesh = make_mesh(dp=2, tp=1, devices=[dev] * 2)
        _reset_launches()
        t0 = time.perf_counter()
        got, stats = preprocess(ds, config=config, amount_lod=3,
                                tile_batch=BUILD_BATCH, mesh=mesh)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = _read_launches()
    same = (all(np.array_equal(ref._kp[k], got._kp[k]) for k in ref._kp)
            and np.array_equal(ref._desc, got._desc))
    batches = sum(-(-len(g[4]) * len(g[5]) // BUILD_BATCH)
                  for g in lod_tile_grid(2048, 2048, 3))
    log(f"preprocess(mesh=dp 2) of a 2048² crop, 3 LoDs: {stats.tiles} "
        f"tiles in {batches} batches, {stats.keypoints} keypoints in "
        f"{secs:.2f} s; launches {launches}")
    check(launches == {"fed_cycle": 30 * batches + launches.warmup_a,
                       "sample_patches": 4 * batches + launches.warmup,
                       "knn2_hamming": 0},
          "preprocess(mesh=dp 2): kernel A 15 and B 2 launches per dp row "
          f"of each tile batch ({launches.warmup} kernel-B launches in "
          "ladder warm-ups)")
    check(stats.keypoints == ref_stats.keypoints > 0 and same,
          "preprocess(mesh=dp 2): the store equals the single-device "
          "build bit for bit")
    return {"seconds": secs, "tiles": stats.tiles, "launches": launches}


def mesh_child(device="cuda:0"):
    """One of the two processes of the mesh phase's part (e): joins the
    gloo group from the APDS_* variables with two slots on `device`, runs
    the sharded kNN-2 (dp 1 × tp 4) and the serve step (dp 2 × tp 2, four
    frames) on the big DB, and saves what it got to $APDS_OUT<rank>.npz."""
    import os

    import torch
    import torch.distributed as dist

    from cubesat_apds_tpu_torch.parallel.mesh import initialize_distributed

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not initialize_distributed():
        raise SmokeFailure("mesh child without APDS_* configuration")
    config = serving_config()
    db, frame_t = big_db_scene(torch, dev, config)
    out = mesh_two_process_outputs(torch, dev, db, frame_t, config,
                                   [dev, dev])
    np.savez(os.environ["APDS_OUT"] + f"{dist.get_rank()}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def mesh_two_process_outputs(torch, dev, db, frame_t, config, slots):
    """The results part (e) compares: the sharded kNN-2 (dp 1 × tp 4) of
    the frame's queries against the big DB and the serve step (dp 2 ×
    tp 2) on the first four pool frames, on a mesh over `slots` (this
    process's, in a distributed run)."""
    from cubesat_apds_tpu_torch.core.types import CameraModel
    from cubesat_apds_tpu_torch.ops import match as M
    from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute
    from cubesat_apds_tpu_torch.parallel.mesh import make_mesh
    from cubesat_apds_tpu_torch.parallel.serve import (
        make_batch_localizer, shard_device_db)
    from cubesat_apds_tpu_torch.parallel.sharded_match import (
        make_sharded_knn2_fused)
    from cubesat_apds_tpu_torch.pipelines.stream import _pack_outputs

    q = detect_and_compute(frame_t.to(dev), config.akaze).descriptors
    fn = make_sharded_knn2_fused(make_mesh(dp=1, tp=4, devices=slots),
                                 db_block=65536)
    d0, d1, i0 = fn(M.unpack_bits(q), fn.place(db.descriptors, db.valid))
    mesh = make_mesh(dp=2, tp=2, devices=slots)
    step = make_batch_localizer(mesh, CameraModel.ideal(
        500.0, 500.0, 256.0, 256.0, device=dev), config, solve_pose=True)
    base = frame_t.numpy()
    frames = torch.stack([torch.from_numpy(np.roll(base, (-k, -2 * k),
                                                   axis=(0, 1)))
                          for k in range(4)]).to(dev)
    homog, pose, n_match, n_kp = step(
        frames, shard_device_db(mesh, db, match_config=config.match))
    packed = _pack_outputs(homog, n_match, n_kp, pose)
    return {"d0": d0.cpu().numpy(), "d1": d1.cpu().numpy(),
            "i0": i0.cpu().numpy(), "packed": packed.cpu().numpy()}


def mesh_two_processes(torch, dev, db, frame_t, config):
    """(e): two child processes share the card over gloo, two slots each,
    one global mesh of four; each must get the single-process results. A
    child that fails or outlasts its time limit fails the phase; both are
    stopped either way."""
    import os
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank")
        procs = []
        t0 = time.perf_counter()
        try:
            for rank in range(2):
                env = dict(os.environ, APDS_COORDINATOR=f"127.0.0.1:{port}",
                           APDS_NUM_PROCESSES="2", APDS_PROCESS_ID=str(rank),
                           APDS_OUT=out, PYTHONPATH=root)
                env.setdefault("GLOO_SOCKET_IFNAME", "lo")
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", "import sys, chip_smoke; "
                     f"sys.exit(chip_smoke.mesh_child('{dev}'))"], cwd=root,
                    env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            logs = [p.communicate(timeout=MESH_CHILD_TIMEOUT_S)[0]
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        secs = time.perf_counter() - t0
        for rank, (p, text) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                log(f"mesh child {rank} output:\n{text[-4000:]}")
            check(p.returncode == 0, f"mesh child {rank} exited 0 "
                  f"(got {p.returncode})")
        got = [dict(np.load(f"{out}{rank}.npz")) for rank in range(2)]
    ref = mesh_two_process_outputs(torch, dev, db, frame_t, config,
                                   [dev] * 4)
    for rank, g in enumerate(got):
        same = {k: np.array_equal(g[k], v) for k, v in ref.items()}
        check(all(same.values()), f"process {rank} of 2 (gloo, 2 slots "
              f"each): sharded kNN-2 and serve step equal the single "
              f"process's ({same})")
    log(f"two processes sharing the card: {secs:.1f} s with start-up")
    return {"seconds": secs}


def mesh_phase(torch, dev, loc, ctx, image):
    """Slice 7 on one card, parts (a)–(e) (module docstring, step 13)."""
    from cubesat_apds_tpu_torch.bench import make_frame
    from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute

    from cubesat_apds_tpu_torch.parallel.mesh import clear_mesh_graphs

    config = serving_config()
    t0 = time.perf_counter()
    frame_t = torch.from_numpy(make_frame(np.random.default_rng(SEED)))
    q_desc = detect_and_compute(frame_t.to(dev), config.akaze).descriptors
    knn, _ = mesh_knn(torch, dev, loc.db, q_desc)
    serve = mesh_serve(torch, dev, loc, ctx["pool"], config)
    stream = mesh_stream(torch, dev, ctx, config)
    build = mesh_preprocess(torch, dev, image)
    procs = mesh_two_processes(torch, dev, loc.db, frame_t, config)
    pools = graph_pools_mib()
    log(f"mesh phase's end: every cached pool, MiB {pools} (total "
        f"{sum(pools.values()):.1f}); {clear_mesh_graphs()} mesh graphs "
        "dropped")
    secs = time.perf_counter() - t0
    log(f"mesh phase: {secs:.1f} s")
    return {"knn": knn, "serve": serve, "stream": stream, "build": build,
            "two_processes": procs, "pools_mib": pools, "seconds": secs}


# ---- slice 15: the driver hooks of graft_entry.py ---------------------------

def hooks_entry(torch, dev):
    """(a): entry() on the card, its step as the driver calls it: the
    arguments on the card, the warmed step's launches of A, B, 4 and the
    Procrustes kernel, the step bit-equal to its eager composition (the
    front half eager, the ladder, the back half eager), the counts equal
    to the CPU hook's, host launches and frames/s (median of 10)."""
    from cubesat_apds_tpu_torch import graft_entry
    from cubesat_apds_tpu_torch.core.step_graph import leaves
    from cubesat_apds_tpu_torch.pipelines.localize import (
        localize_from_features)

    fn, args = graft_entry.entry()
    frame, db, camera = args
    check(all(t.device == dev for t in (frame, db.descriptors, camera.K)),
          "entry(): the frame, the DB and the camera on the card")
    config = fn.keywords["config"]
    fn(*args)                                  # warm-up: the key's capture
    torch.cuda.synchronize()
    _reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    launches = _read_launches()
    log(f"entry() step: launches {launches}, Procrustes "
        f"{launches.procrustes}")
    w = launches.warmups
    check(launches == {"fed_cycle": 15 + w["fed_cycle"],
                       "sample_patches": 2 + w["sample_patches"],
                       "knn2_hamming": w["knn2_hamming"]}
          and launches.procrustes == 1 + w["procrustes3"],
          "entry() step: kernel A 15, B 2, the Procrustes kernel once and "
          "kernel 4 never (10,240 rows take the dense match) a warmed step "
          f"(graph warm-ups in the window: {w})")
    want = localize_from_features(eager_features(torch, frame, config.akaze),
                                  db, camera, config, True)
    lg, lw = leaves(out), leaves(want)
    same = [torch.equal(a, b) for a, b in zip(lg, lw)]
    check(len(lg) == len(lw) and all(same),
          f"entry() step: the graphed step equals its eager composition bit "
          f"for bit ({sum(same)} of {len(lw)} output tensors)")
    cfn, cargs = graft_entry.entry(device="cpu")
    ref = cfn(*cargs)
    n_kp, n_match = int(out.num_keypoints), int(out.num_matches)
    check(n_kp == int(ref.num_keypoints) == config.akaze.capacity
          and n_match == int(ref.num_matches)
          and bool(torch.isfinite(out.homography.H).all()),
          f"entry() step: {n_kp} keypoints and {n_match} matches, as the "
          "CPU hook's step; H finite")
    host = host_launches(torch, lambda: fn(*args))
    step_s = timed_steps(torch, lambda: fn(*args), "entry()")
    return {"launches": dict(launches, procrustes3=launches.procrustes),
            "keypoints": n_kp, "matches": n_match, "host_launches": host,
            "frames_per_s": 1.0 / step_s, "step_ms": step_s * 1e3}


def hooks_dryrun(torch, dev):
    """(b): the dry run at n = 4 over 4 slots of the card (dp 2 × tp 2):
    JAX's assertions (made by the hook), each dp row of its serve step
    bit-equal to the single-device batch step on the row's frames, the
    sharded kNN-2 bit-equal to the dense one over the whole DB, the tile
    batch bit-equal to detect_and_compute_batch on the card; the launches
    of the whole dry run; its seconds, cold and again."""
    from cubesat_apds_tpu_torch import graft_entry
    from cubesat_apds_tpu_torch.ops import match as M
    from cubesat_apds_tpu_torch.ops.features.akaze import (
        detect_and_compute_batch)
    from cubesat_apds_tpu_torch.pipelines.localize import (
        localize_from_features)
    from cubesat_apds_tpu_torch.pipelines.stream import _pack_outputs

    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        out = graft_entry._dryrun(4)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches = _read_launches()
    mesh, cfg, db = out["mesh"], out["config"], out["db"]
    check(mesh.shape == {"dp": 2, "tp": 2}
          and all(d == dev for d in mesh.devices.flat),
          "dry run: a dp 2 x tp 2 mesh of four slots of the card")
    log(f"dry run (second): launches {launches}, Procrustes "
        f"{launches.procrustes}")
    w = launches.warmups
    check(launches == {"fed_cycle": 60 + w["fed_cycle"],
                       "sample_patches": 8 + w["sample_patches"],
                       "knn2_hamming": w["knn2_hamming"]}
          and launches.procrustes == 2 + w["procrustes3"],
          "dry run: kernel A 15 and B 2 a dp row in the serve step and in "
          "the tile batch, the Procrustes kernel once a row, kernel 4 never "
          f"(128-row shards) (graph warm-ups in the window: {w})")
    homog, pose, n_match, n_kp = out["serve"]
    got = _pack_outputs(homog, n_match, n_kp, pose)
    frames, lb = out["frames"], out["frames"].shape[0] // 2
    rows = []
    for i in range(2):
        row = localize_from_features(detect_and_compute_batch(
            frames[i * lb:(i + 1) * lb], cfg.akaze), db, out["camera"], cfg,
            True)
        rows.append(torch.equal(got[i * lb:(i + 1) * lb], _pack_outputs(
            row.homography, row.num_matches, row.num_keypoints, row.pose)))
    check(all(rows), f"dry run: each dp row of the serve step bit-equal to "
          f"the single-device batch step on its {lb} frames ({sum(rows)} "
          "of 2 rows)")
    dense = M.knn2(M.unpack_bits(out["q_desc"]), M.unpack_bits(db.descriptors),
                   db_valid=db.valid)
    check(all(torch.equal(a, b) for a, b in zip(out["knn"], dense)),
          "dry run: the sharded kNN-2 bit-equal to the dense kNN-2 over the "
          "whole DB")
    feats = detect_and_compute_batch(out["tiles"].to(dev), cfg.akaze)
    host = out["tile_features"]
    same = np.array_equal(host["desc"], feats.descriptors.cpu().numpy())
    for f in ("xy", "size", "angle", "response", "octave", "class_id",
              "valid"):
        same &= np.array_equal(host[f],
                               getattr(feats.keypoints, f).cpu().numpy())
    check(same, "dry run: the dp-split tile batch bit-equal to "
          "detect_and_compute_batch on the card")
    log(f"dry run n = 4: {secs[0]:.3f} s cold (its graphs captured), "
        f"{secs[1]:.3f} s again")
    return {"launches": dict(launches, procrustes3=launches.procrustes),
            "seconds": secs, "keypoints": n_kp.tolist()}


def hooks_phase(torch, dev):
    """Slice 15: the driver hooks on the card (module docstring, step
    16)."""
    t0 = time.perf_counter()
    entry = hooks_entry(torch, dev)
    dryrun = hooks_dryrun(torch, dev)
    secs = time.perf_counter() - t0
    log(f"hooks phase, {card_line()}: entry() {entry['frames_per_s']:.2f} "
        f"frames/s ({entry['step_ms']:.2f} ms a warmed step, "
        f"{entry['host_launches']} host launches), {entry['keypoints']} "
        f"keypoints, {entry['matches']} matches; dry run "
        f"{dryrun['seconds'][0]:.3f} s cold, {dryrun['seconds'][1]:.3f} s "
        f"again; the phase {secs:.1f} s")
    return {"entry": entry, "dryrun": dryrun, "seconds": secs}


# ---- slice 8: the approximate descriptor modes ------------------------------

MODE_CONFIGS = {   # label: AkazeConfig keywords
    "exact": {},
    "fast": dict(descriptor_mode="fast", orientation_mode="fast"),
    "hybrid2": dict(descriptor_mode="hybrid", hybrid_subcells=2),
    "hybrid3": dict(descriptor_mode="hybrid", hybrid_subcells=3),
}


def slice_db(torch, dev, frame, config, rng):
    """bench.py's 10,240-row DB: the port's features of `frame` rolled by
    (7, 13) under `config`, tiled and perturbed past the first copy."""
    from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute
    from cubesat_apds_tpu_torch.pipelines.localize import DeviceDb

    feats = detect_and_compute(
        torch.from_numpy(np.roll(frame, (7, 13), axis=(0, 1))).to(dev),
        config.akaze)
    desc = feats.descriptors.cpu().numpy()
    xy = feats.keypoints.xy.cpu().numpy()
    valid = feats.keypoints.valid.cpu().numpy()
    m = 10240
    reps = m // len(desc) + 1
    desc_db = np.tile(desc, (reps, 1))[:m]
    xy_db = np.tile(xy, (reps, 1))[:m]
    valid_db = np.tile(valid, reps)[:m]
    flip = rng.integers(0, 256, desc_db.shape, dtype=np.uint8)
    flip[:len(desc)] = 0
    desc_db = desc_db ^ (flip & rng.integers(0, 2, desc_db.shape,
                                             dtype=np.uint8) * 255)
    obj = np.concatenate([xy_db, np.zeros((m, 1), np.float32)], axis=1)
    return DeviceDb(descriptors=torch.from_numpy(desc_db),
                    xy=torch.from_numpy(xy_db.astype(np.float32)),
                    valid=torch.from_numpy(valid_db),
                    obj_points=torch.from_numpy(obj.astype(np.float32)),
                    has_world=True)


def kernel_b_against_twin(torch, run, label):
    """Every kernel-B launch of `run()` held against the plain twin on the
    same inputs, bit for bit: the approximate modes' shapes (S = 57 for
    fast orientation, one launch per MLDB grid at S = 4, 9, 16 fast and
    16, 36, 64 or 36, 81, 144 hybrid)."""
    from cubesat_apds_tpu_torch.ops.kernels import sample_kernel as sk

    calls = []
    orig = sk.sample_patches_cuda

    def recorded(*args):
        out = orig(*args)
        calls.append((args, out))
        return out

    sk.sample_patches_cuda = recorded
    try:
        run()
    finally:
        sk.sample_patches_cuda = orig
    shapes, err = [], 0.0
    for (packed, level_hw, lvl, iy, ix), out in calls:
        ref = sk.sample_patches_plain(packed, level_hw, lvl, iy, ix)
        check(torch.equal(out, ref), f"{label}: kernel B at S={iy.shape[1]} "
              f"(K={iy.shape[0]}) bit-exact with its twin")
        shapes.append(int(iy.shape[1]))
        err = max(err, float((out - ref).abs().max()))
    return {"shapes_S": shapes, "max_abs_err": err}


def modes_features(torch, dev):
    """(a): bench.py's 512² frame through detect_and_compute in each mode
    on the card and on the CPU: keypoints, angles and descriptors bit for
    bit; kernel B's launches a frame; the per-keypoint stages' device
    time against exact mode."""
    import dataclasses

    from cubesat_apds_tpu_torch.bench import make_frame
    from cubesat_apds_tpu_torch.ops.features.akaze import (
        _front_end, detect_and_compute, orient_describe)

    frame = torch.from_numpy(make_frame(np.random.default_rng(SEED)))
    base = serving_config().akaze
    out = {}
    for label, kw in MODE_CONFIGS.items():
        akaze = dataclasses.replace(base, **kw)
        detect_and_compute(frame.to(dev), akaze)                # warm-up
        torch.cuda.synchronize()
        _reset_launches()
        f = detect_and_compute(frame.to(dev), akaze)
        torch.cuda.synchronize()
        launches = _read_launches()
        x = frame.to(dev)[None]
        kps, packed, level_hw, grids = _front_end(x, akaze, akaze.capacity,
                                                  None)
        stage_ms = device_busy_ms(torch, lambda: orient_describe(
            kps, packed, level_hw, akaze.capacity, akaze, grids))
        entry = {"launches": launches, "describe_device_ms": stage_ms}
        if label != "exact":
            entry["kernel_b"] = kernel_b_against_twin(
                torch, lambda: orient_describe(kps, packed, level_hw,
                                               akaze.capacity, akaze, grids),
                label)
            t0 = time.perf_counter()
            fc = detect_and_compute(frame, akaze)
            cpu_s = time.perf_counter() - t0
            same = {k: torch.equal(getattr(f.keypoints, k).cpu(),
                                   getattr(fc.keypoints, k))
                    for k in ("xy", "size", "angle", "response", "octave",
                              "class_id", "valid")}
            same["descriptors"] = torch.equal(f.descriptors.cpu(),
                                              fc.descriptors)
            check(all(same.values()), f"{label}: card and CPU give the same "
                  f"keypoints, angles and descriptors bit for bit "
                  f"({int(f.keypoints.valid.sum())} keypoints; CPU "
                  f"{cpu_s:.1f} s)")
            check(launches == {"fed_cycle": 15 + launches.warmup_a,
                               "sample_patches": 4 + launches.warmup,
                               "knn2_hamming": 0},
                  f"{label}: kernel A 15 and kernel B 4 launches a frame "
                  "(orientation, then one per MLDB grid; "
                  f"{launches.warmup} in ladder warm-ups)")
        log(f"{label}: launches {launches}; orientation + descriptors "
            f"{stage_ms:.4f} ms device at capacity {akaze.capacity}")
        out[label] = entry
    return out


def modes_slice(torch, dev):
    """(b): the 10k slice step in each mode against a DB of the port's own
    features in that mode: median of 10 steps, the (13, 7) shift, and the
    homography-inlier Jaccard against exact mode (the JAX package's
    120-scene study: 0.81 fast, 0.90 hybrid; reference figures, no
    gate)."""
    import dataclasses

    from cubesat_apds_tpu_torch.bench import make_frame
    from cubesat_apds_tpu_torch.core.types import CameraModel
    from cubesat_apds_tpu_torch.pipelines.localize import Localizer

    frame = make_frame(np.random.default_rng(SEED))
    frame_t = torch.from_numpy(frame)
    camera = CameraModel.ideal(500.0, 500.0, 256.0, 256.0)
    out, ref = {}, None
    for label, kw in MODE_CONFIGS.items():
        config = serving_config()
        config = dataclasses.replace(config, akaze=dataclasses.replace(
            config.akaze, **kw))
        db = slice_db(torch, dev, frame, config, np.random.default_rng(SEED))
        loc = Localizer(db, camera, config, device=dev)
        res = loc.localize(frame_t)
        torch.cuda.synchronize()
        H = res.homography.H.cpu().numpy()
        check(bool(res.homography.ok) and abs(H[0, 2] - 13.0) < 1.0
              and abs(H[1, 2] - 7.0) < 1.0,
              f"{label} slice: H recovers the (13, 7) shift (got "
              f"{H[0, 2]:.3f}, {H[1, 2]:.3f})")
        pairs = inlier_pairs(res)
        if ref is None:
            ref = pairs
        jac = inlier_jaccard(pairs, ref)
        med = timed_steps(torch, lambda: loc.localize(frame_t),
                          f"{label} slice")
        log(f"{label} slice: {int(res.num_matches)} matches, "
            f"{int(res.homography.num_inliers)} inliers, inlier Jaccard "
            f"against exact {jac:.4f}")
        out[label] = {"step_ms": med * 1e3, "jaccard_vs_exact": jac,
                      "matches": int(res.num_matches)}
    return out


def modes_accuracy(torch, dev):
    """(c) and (d): accuracy.run for rects nominal and oblique20, 4 scenes
    each, in fast and hybrid with tests/test_accuracy.py's bounds; then a
    store built in fast mode served, check_descriptor_mode accepting fast
    and refusing exact."""
    from cubesat_apds_tpu_torch.pipelines.localize import (
        Localizer, check_descriptor_mode)
    from cubesat_apds_tpu_torch.utils import accuracy as A
    from cubesat_apds_tpu_torch.utils import synthetic as S

    conds = ("nominal", "oblique20")
    all_conditions = A.CONDITIONS
    A.CONDITIONS = {c: all_conditions[c] for c in conds}
    _reset_launches()
    t0 = time.perf_counter()
    try:
        res = A.run(ACC_SCENES, modes=("fast", "hybrid"), texture="rects",
                    device=dev, progress=log)
    finally:
        A.CONDITIONS = all_conditions
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _read_launches()
    frames = 2 * len(conds) * ACC_SCENES
    for mode, cells in res.items():
        for cond, agg in cells.items():
            gate = ACC_NOMINAL if cond == "nominal" else ACC_HARD
            ok = (agg["ok_rate"] >= ACC_OK_RATE
                  and agg["att_med"] < gate["att"]
                  and agg["pos_med"] < gate["pos"]
                  and ("fp" not in gate or agg["fp_med"] < gate["fp"]))
            check(ok, f"{mode} {cond}: ok {agg['ok_rate']}, attitude "
                  f"{agg['att_med']} deg, position {agg['pos_med']} m, "
                  f"footprint {agg['fp_med']} m within the bounds {gate}")
    check(launches == {"fed_cycle": 15 * (frames + 2) + launches.warmup_a,
                       "sample_patches": 4 * (frames + 2) + launches.warmup,
                       "knn2_hamming": 0},
          f"modes accuracy: kernel A 15 and B 4 launches in each of the "
          f"{frames} frames and 2 builds ({launches}; {launches.warmup} "
          "kernel-B launches in ladder warm-ups)")
    log(f"modes accuracy: {frames} frames and 2 builds in {secs:.2f} s")

    mosaic, plane, ds = A.build_world(2026, device=dev)
    store = A.build_db(ds, A.mode_config("fast"), progress=log,
                       label="[fast store]")
    check(store.descriptor_mode == "fast", "the fast build's store records "
          "descriptor_mode 'fast'")
    check_descriptor_mode(store, A.mode_config("fast"))
    try:
        check_descriptor_mode(store, A.mode_config("exact"))
        refused = False
    except ValueError:
        refused = True
    check(refused, "check_descriptor_mode refuses exact against the fast "
          "store")
    cam = A.scene_camera(mosaic, plane, A._cond_rng(2026, "nominal"), {})
    frame, _ = S.render_frame(mosaic.bands[0] / 255.0, mosaic.geotransform,
                              plane, cam, device=dev)
    r = Localizer(store, A.camera_model(cam, dev), A.mode_config("fast"),
                  device=dev).localize(frame, solve_pose=True)
    att, pos = S.pose_errors(r.pose.rvec.cpu().numpy(),
                             r.pose.tvec.cpu().numpy(), cam)
    check(bool(r.pose.ok) and att < ACC_NOMINAL["att"]
          and pos < ACC_NOMINAL["pos"], f"the fast store serves a nominal "
          f"frame: attitude {att:.4f} deg, position {pos:.2f} m")
    return {"cells": res, "seconds": secs, "launches": launches}


def modes_phase(torch, dev):
    """Slice 8, parts (a)–(d) (module docstring, step 14)."""
    t0 = time.perf_counter()
    feats = modes_features(torch, dev)
    slice_ = modes_slice(torch, dev)
    acc = modes_accuracy(torch, dev)
    secs = time.perf_counter() - t0
    log(f"modes phase: {secs:.1f} s")
    return {"features": feats, "slice": slice_, "accuracy": acc,
            "seconds": secs}


# ---- the CLI phase: the port's command line on the card -------------------

CLI_CROP = 2048                   # the build image's corner, 2×2 members
CLI_AT = (700, 900)               # (x, y) of the localize frame in the crop
CLI_STREAM_FRAMES = 24


def _cli(torch, argv):
    """cubesat_apds_tpu_torch.cli.main(argv) in-process: its stdout, the
    kernel launches of the call (counters zeroed just before, read just
    after) and its seconds. A non-zero exit fails the phase."""
    import contextlib
    import io

    from cubesat_apds_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _read_launches()
    if rc != 0:
        raise SmokeFailure(f"apds-torch {' '.join(argv)}: exit {rc}")
    log(f"apds-torch {' '.join(argv)}: {secs:.2f} s, launches {launches}")
    return buf.getvalue(), launches, secs


def _cli_json(text, opener="{"):
    return json.loads(text[text.index(opener):])


def _cli_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _same_store_rows(a, b):
    """Two stores on disk: the same tile records and, per LoD, the same
    rows (every column and the descriptors) bit for bit."""
    from cubesat_apds_tpu_torch.store import open_store

    sa, sb = open_store(a), open_store(b)
    recs = [sorted((i, r.x_start, r.y_start, r.x_end, r.y_end,
                    r.level_of_detail) for i, r in s.images.items())
            for s in (sa, sb)]
    if recs[0] != recs[1]:
        return False
    for lod in sorted({r[5] for r in recs[0]}):
        (ca, da), (cb, db) = (sa.read_keypoints_from_lod(lod),
                              sb.read_keypoints_from_lod(lod))
        if not (np.array_equal(da, db) and set(ca) == set(cb) and all(
                np.array_equal(ca[k], cb[k]) for k in ca)):
            return False
    return True


def _offset_err(H, at):
    """How far H puts the frame's origin from the crop offset `at`."""
    H = np.asarray(H, np.float64)
    return float(np.hypot(H[0, 2] / H[2, 2] - at[0], H[1, 2] / H[2, 2] - at[1]))


def cli_build(torch, dev, root, crop):
    """(a) preprocess: the 2048² crop as 2×2 GeoTIFF members of 1024² with
    a seeded DEM, built with --binary --lod 3 --tile-batch 8 -e, equal to
    the in-process preprocess + write_binary_store bit for bit; then -c 2
    over two slots of cuda:0, the same rows, kernel A 30 times a batch."""
    import os

    from cubesat_apds_tpu_torch.core.config import PipelineConfig
    from cubesat_apds_tpu_torch.io.mosaic import MosaicDataset
    from cubesat_apds_tpu_torch.io.tiff import write_geotiff
    from cubesat_apds_tpu_torch.ops.image import lod_tile_grid
    from cubesat_apds_tpu_torch.pipelines.preprocess import preprocess
    from cubesat_apds_tpu_torch.store.binary_store import write_binary_store

    tiles = os.path.join(root, "tiles")
    os.makedirs(tiles)
    rgb = np.round(np.stack([crop, 0.85 * crop + 0.1, 0.7 * crop + 0.2],
                            -1) * 255).astype(np.uint8)
    m = CLI_CROP // 2
    for ty in range(2):
        for tx in range(2):
            write_geotiff(os.path.join(tiles, f"m{ty}{tx}.tif"),
                          rgb[ty * m:(ty + 1) * m, tx * m:(tx + 1) * m],
                          [10.0 + tx * m * PX_DEG, PX_DEG, 0.0,
                           56.0 - ty * m * PX_DEG, 0.0, -PX_DEG])
    dem = os.path.join(root, "dem.tif")
    step = CLI_CROP * PX_DEG / 32
    write_geotiff(dem, np.random.default_rng(SEED).uniform(
        100.0, 101.0, (32, 32)).astype(np.float32),
        [10.0, step, 0.0, 56.0, 0.0, -step])
    store = os.path.join(root, "store")
    argv = ["preprocess", "--dataset", tiles, "--store", store, "--binary",
            "--lod", "3", "--tile-batch", "8", "-e", dem]
    out, launches, secs = _cli(torch, ["--device", "cuda:0"] + argv)
    ds = MosaicDataset.from_folder(tiles, device=dev)
    ref, ref_stats = preprocess(ds, config=PipelineConfig(), amount_lod=3,
                                tile_batch=8, elevation_path=dem)
    ref_path = os.path.join(root, "ref")
    write_binary_store(ref, ref_path)
    batches = sum(-(-len(g[4]) * len(g[5]) // 8)
                  for g in lod_tile_grid(CLI_CROP, CLI_CROP, 3))
    check(f"{ref_stats.keypoints} keypoints, {ref_stats.tiles} tiles" in out
          and _same_store_rows(store, ref_path),
          f"preprocess: the CLI's store ({ref_stats.keypoints} keypoints, "
          f"{ref_stats.tiles} tiles) equals the in-process build bit for bit")
    check(launches == {"fed_cycle": 15 * batches + launches.warmup_a,
                       "sample_patches": 2 * batches + launches.warmup,
                       "knn2_hamming": 0},
          f"preprocess: kernel A 15 and B 2 launches in each of {batches} "
          f"tile batches ({launches.warmup} kernel-B launches in ladder "
          "warm-ups)")
    store2 = os.path.join(root, "store_c2")
    _, launches2, secs2 = _cli(torch, ["--device", "cuda:0,cuda:0"] + [
        store2 if a == store else a for a in argv] + ["-c", "2"])
    check(_same_store_rows(store2, ref_path),
          "preprocess -c 2: the same rows as the in-process build")
    check(launches2 == {"fed_cycle": 30 * batches + launches2.warmup_a,
                        "sample_patches": 4 * batches + launches2.warmup,
                        "knn2_hamming": 0},
          "preprocess -c 2: kernel A 30 and B 4 launches a tile batch "
          f"({launches2.warmup} kernel-B launches in ladder warm-ups)")
    return store, ds, {"preprocess": (launches, secs),
                       "preprocess -c 2": (launches2, secs2)}


def cli_localize(torch, dev, root, store, ds):
    """(b) localize: a 512² frame cut from the crop at CLI_AT, as a PNG;
    H puts the offset within 1 px and the JSON equals the in-process
    Localizer.localize of the same decoded frame bit for bit; then
    --pruned (no fallback), --coarse-to-fine, --viz and --profile."""
    import os

    from cubesat_apds_tpu_torch.cli import _load_gray
    from cubesat_apds_tpu_torch.core.config import PipelineConfig
    from cubesat_apds_tpu_torch.core.types import CameraModel
    from cubesat_apds_tpu_torch.pipelines.localize import Localizer
    from cubesat_apds_tpu_torch.pipelines.preprocess import tile_gray
    from cubesat_apds_tpu_torch.store import open_store
    from PIL import Image

    x0, y0 = CLI_AT
    gray = tile_gray(ds, x0, y0, 512, 512, 512, 512).cpu().numpy()
    frame = os.path.join(root, "frame.png")
    Image.fromarray(np.round(gray * 255).astype(np.uint8)).save(frame)
    dv = ["--device", "cuda:0"]
    base = ["localize", "--store", store, "--frame", frame]
    out, launches, secs = _cli(torch, dv + base)
    got = _cli_json(out)
    err = _offset_err(got["homography"], CLI_AT)
    log(f"localize: keypoints {got['keypoints']} matches {got['matches']} "
        f"inliers {got['inliers']} pose ok {got.get('pose_ok')}; offset "
        f"error {err:.4f} px")
    check(got["homography_ok"] and err < 1.0,
          f"localize: H puts the frame at {CLI_AT} within 1 px")
    loc = Localizer(open_store(store), CameraModel.ideal(512.0, 512.0, 256.0,
                                                         256.0),
                    PipelineConfig(), device=dev)
    res = loc.localize(torch.from_numpy(_load_gray(frame)))
    rows = int(loc.device_db(0).valid.sum())
    check(got["keypoints"] == int(res.num_keypoints)
          and got["matches"] == int(res.num_matches)
          and got["inliers"] == int(res.homography.num_inliers)
          and got["homography"] == res.homography.H.cpu().numpy().tolist()
          and got["pose_ok"] == bool(res.pose.ok)
          and got["rvec"] == res.pose.rvec.cpu().numpy().tolist(),
          "localize: keypoints, matches, inliers, H and pose equal "
          "Localizer.localize's bit for bit")
    check(launches == {"fed_cycle": 15 + launches.warmup_a,
                       "sample_patches": 2 + launches.warmup,
                       "knn2_hamming": int(rows > PipelineConfig()
                                           .match.db_block)},
          f"localize: kernel A 15, B 2 launches; kNN-2 where LoD 0's {rows} "
          f"rows pass db_block ({launches.warmup} kernel-B launches in "
          "ladder warm-ups)")
    if got["pose_ok"]:
        check(len(got["camera_position"]) == 3
              and len(got["attitude_quat_wxyz"]) == 4,
              "localize: the attitude block (position, quaternion)")
    out_p, l_p, _ = _cli(torch, dv + base + ["--pruned"])
    pr = _cli_json(out_p)
    check(pr["pruned"]["coarse_ok"] and not pr["pruned"]["fallback"]
          and _offset_err(pr["homography"], CLI_AT) < 1.0,
          f"localize --pruned: coarse fix, no fallback "
          f"({pr['pruned']['window_rows']} window rows), offset within 1 px")
    out_c, l_c, _ = _cli(torch, dv + base + ["--coarse-to-fine"])
    c2f = _cli_json(out_c)
    check(c2f["homography_ok"]
          and _offset_err(c2f["homography"], CLI_AT) < 1.0,
          f"localize --coarse-to-fine (coarse ok {c2f['coarse_ok']}): "
          "offset within 1 px")
    viz = os.path.join(root, "viz.png")
    _cli(torch, dv + base + ["--viz", viz])
    with Image.open(viz) as im:
        check(im.size == (512, 512), "localize --viz wrote a 512² PNG")
    prof_dir = os.path.join(root, "trace")
    _cli(torch, dv + base + ["--profile", prof_dir])
    with open(os.path.join(prof_dir, "trace.json")) as f:
        trace = f.read()
    check("fed_cycle_kernel" in trace and "sample_patches_kernel" in trace,
          f"localize --profile: the trace ({len(trace) / 1e6:.1f} MB) holds "
          "the fed_cycle and sample_patches kernels")
    return frame, got, {"localize": (launches, secs),
                        "localize --pruned": (l_p, None),
                        "localize --coarse-to-fine": (l_c, None)}


def cli_stream(torch, dev, root):
    """(c) stream: 24 of the stream phase's pool frames as PNGs, served from
    its 1,048,576-row binary store (written again from seed 42) with
    --batch 8 --mesh 2x2 over four slots of cuda:0: every line's H equal to
    the in-process mesh stream's, kernel 4 four times a batch, a summary
    of 24 frames; then --pruned --batch 8 with no frame falling back."""
    import os

    from cubesat_apds_tpu_torch.bench import make_frame
    from cubesat_apds_tpu_torch.core.config import PipelineConfig
    from cubesat_apds_tpu_torch.core.types import CameraModel
    from cubesat_apds_tpu_torch.parallel.mesh import make_mesh
    from cubesat_apds_tpu_torch.parallel.serve import shard_device_db
    from cubesat_apds_tpu_torch.pipelines.localize import load_device_db
    from cubesat_apds_tpu_torch.pipelines.stream import StreamingLocalizer
    from cubesat_apds_tpu_torch.store import open_store
    from PIL import Image

    rng = np.random.default_rng(SEED)
    base_u8 = (make_frame(rng) * 255).astype(np.uint8)
    shifts = [tuple(int(v) for v in d)
              for d in np.random.default_rng(SEED + 3).integers(-4, 5, (8, 2))]
    pool = [np.roll(base_u8, (-dy, -dx), axis=(0, 1)) for dx, dy in shifts]
    t0 = time.perf_counter()
    p1m = write_stream_stores(torch, dev, root, base_u8,
                              serving_config())["1M"][0]
    frames_dir = os.path.join(root, "frames")
    os.makedirs(frames_dir)
    frames = [pool[i % len(pool)] for i in range(CLI_STREAM_FRAMES)]
    for i, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(frames_dir, f"f{i:02d}.png"))
    log(f"stream: the 1M store and {CLI_STREAM_FRAMES} frames written in "
        f"{time.perf_counter() - t0:.2f} s")
    argv = ["stream", "--store", p1m, "--frames", frames_dir, "--batch", "8"]
    out, launches, secs = _cli(torch, ["--device", ",".join(["cuda:0"] * 4)]
                               + argv + ["--mesh", "2x2"])
    lines = _cli_lines(out)
    recs, summary = lines[:-1], lines[-1]["summary"]
    batches = CLI_STREAM_FRAMES // 8

    config = PipelineConfig()
    db = load_device_db(open_store(p1m), 0, match_config=config.match,
                        device=dev)
    mesh = make_mesh(dp=2, tp=2, devices=[dev] * 4)
    s = StreamingLocalizer(shard_device_db(mesh, db, match_config=config.match),
                           CameraModel.ideal(512.0, 512.0, 256.0, 256.0),
                           config, solve_pose=db.has_world, batch=8,
                           mesh=mesh)
    ref = list(s.run(frames))
    check(summary["frames"] == CLI_STREAM_FRAMES == len(recs)
          and [os.path.basename(r["frame"]) for r in recs]
          == [f"f{i:02d}.png" for i in range(CLI_STREAM_FRAMES)],
          f"stream --mesh 2x2: {CLI_STREAM_FRAMES} lines in order and a "
          "summary of as many frames")
    check(all(r["homography"] == x.homography.tolist()
              and r["inliers"] == x.num_inliers
              and r["matches"] == x.num_matches for r, x in zip(recs, ref)),
          "stream --mesh 2x2: every line's H, inliers and matches equal the "
          "in-process mesh stream's")
    warm4 = launches.warmups["knn2_hamming"]
    check(launches["knn2_hamming"] == 4 * batches + warm4
          and launches["fed_cycle"] == 30 * batches + launches.warmup_a
          and launches["sample_patches"] == 4 * batches + launches.warmup,
          f"stream --mesh 2x2: kNN-2 4, kernel A 30, B 4 launches in each of "
          f"{batches} batches (one kNN-2 a shard; {warm4} kNN-2 launches in "
          f"mesh-graph warm-ups, {launches.warmup} kernel-B launches in "
          "ladder warm-ups)")
    log(f"stream --mesh 2x2: {summary}")
    out_p, l_p, secs_p = _cli(torch, ["--device", "cuda:0"] + argv
                              + ["--pruned"])
    sp = _cli_lines(out_p)[-1]["summary"]
    log(f"stream --pruned: {sp}")
    check(sp["frames"] == CLI_STREAM_FRAMES and sp["fallback_frames"] == 0,
          "stream --pruned --batch 8: no frame falls back")
    return {"stream --mesh 2x2": (launches, secs),
            "stream --pruned": (l_p, secs_p)}, summary, sp


def cli_match(torch, root):
    """(d) match: bench.py's frame against its (7, 13) roll, plain and
    --crosscheck, with -o: the counts equal those under --device cpu."""
    import os

    from PIL import Image

    from cubesat_apds_tpu_torch.bench import make_frame

    frame = make_frame(np.random.default_rng(SEED))
    paths = []
    for name, img in (("a", frame), ("b", np.roll(frame, (7, 13), (0, 1)))):
        paths.append(os.path.join(root, f"{name}.png"))
        Image.fromarray(np.round(img * 255).astype(np.uint8)).save(paths[-1])
    runs = {}
    for extra in ([], ["--crosscheck"]):
        viz = os.path.join(root, "m.png")
        out, launches, secs = _cli(torch, ["--device", "cuda:0", "match"]
                                   + paths + extra + ["-o", viz])
        card = _cli_json(out)
        cpu = _cli_json(_cli(torch, ["--device", "cpu", "match"] + paths
                             + extra)[0])
        label = "match" + "".join(" " + e for e in extra)
        check(card["keypoints"] == cpu["keypoints"]
              and card["matches"] == cpu["matches"] > 0
              and card["viz"] == viz and os.path.exists(viz),
              f"{label}: keypoints {card['keypoints']}, matches "
              f"{card['matches']} on the card = on the CPU; -o written")
        check(launches == {"fed_cycle": 30 + launches.warmup_a,
                           "sample_patches": 4 + launches.warmup,
                           "knn2_hamming": 0},
              f"{label}: kernel A 15 and B 2 launches an image "
              f"({launches.warmup} kernel-B launches in ladder warm-ups)")
        runs[label] = (launches, secs)
    return runs


def cli_calibrate(torch, dev, root, store, frame):
    """(e) calibrate: the calibration phase's 12 boards as PNGs; K of
    -o cam.json within 1e-5 of the in-process calibrate_from_images on the
    same decoded images; localize --camera takes the file."""
    import os

    from cubesat_apds_tpu_torch.pipelines.calibrate import (
        calibrate_from_images, read_gray_images)
    from PIL import Image

    boards = os.path.join(root, "boards")
    os.makedirs(boards)
    for i, v in enumerate(calibration_boards(torch, dev,
                                             np.random.default_rng(SEED))):
        Image.fromarray(np.round(np.clip(v, 0, 1) * 255).astype(np.uint8)) \
            .save(os.path.join(boards, f"b{i:02d}.png"))
    cam = os.path.join(root, "cam.json")
    out, launches, secs = _cli(torch, ["--device", "cuda:0", "calibrate",
                                       boards, "7x6", "-o", cam])
    with open(cam) as f:
        K = np.asarray(json.load(f)["K"])
    res, found = calibrate_from_images(read_gray_images(boards), CAL_GRID,
                                       device=dev)
    err = float(np.abs(K - res.camera.K.cpu().numpy()).max())
    check(f"views used: {CAL_VIEWS}/{CAL_VIEWS}" in out and err <= 1e-5,
          f"calibrate: every view used; K within 1e-5 of the in-process "
          f"calibration ({err:.2e}; fx {K[0, 0]:.3f}, cx {K[0, 2]:.3f})")
    out_l, _, _ = _cli(torch, ["--device", "cuda:0", "localize", "--store",
                               store, "--frame", frame, "--camera", cam])
    check("homography" in _cli_json(out_l),
          "localize --camera cam.json takes the calibrated camera")
    return {"calibrate": (launches, secs)}


def cli_store(torch, root, store, frame, ref):
    """(f) store: info, delete (the coarsest LoD's tile) and compact on a
    copy of (a)'s store; the live counts add up and the compacted store
    serves (b)'s frame with the same H."""
    import os
    import shutil

    from cubesat_apds_tpu_torch.store import open_store

    copy = os.path.join(root, "store_admin")
    shutil.copytree(store, copy)
    info = _cli_json(_cli(torch, ["store", "info", copy])[0])
    images = open_store(copy).images
    coarse = max(images, key=lambda i: images[i].level_of_detail)
    dele = _cli_json(_cli(torch, ["store", "delete", copy, "--image-id",
                                  str(coarse)])[0])
    comp = _cli_json(_cli(torch, ["store", "compact", copy])[0])
    after = _cli_json(_cli(torch, ["store", "info", copy])[0])
    check(dele["keypoints_removed"] + dele["keypoints_live"]
          == info["keypoints_live"] == info["keypoints_total"]
          and comp["kept"] == dele["keypoints_live"] == after["keypoints_live"]
          == after["keypoints_total"]
          and comp["dropped"] == dele["keypoints_removed"] > 0
          and after["tiles"] == info["tiles"] - 1,
          f"store: {info['keypoints_live']} live = {dele['keypoints_live']} "
          f"kept + {dele['keypoints_removed']} removed (tile {coarse}, LoD "
          f"{images[coarse].level_of_detail}); compacted to one segment")
    got = _cli_json(_cli(torch, ["--device", "cuda:0", "localize", "--store",
                                 copy, "--frame", frame])[0])
    check(got["homography"] == ref["homography"]
          and got["keypoints"] == ref["keypoints"]
          and got["matches"] == ref["matches"],
          "store: the compacted store serves the frame with the same H")


def cli_phase(torch, dev, card, crop):
    """The port's command line on cuda:0, through cli.main in-process:
    (a) preprocess, (b) localize, (c) stream, (d) match, (e) calibrate,
    (f) store, (g) bench.run, (h) one real `python -m` process."""
    import os

    from cubesat_apds_tpu_torch import bench

    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as root:
        store, ds, runs = cli_build(torch, dev, root, crop)
        launches.update(runs)
        frame, ref, runs = cli_localize(torch, dev, root, store, ds)
        launches.update(runs)
        runs, mesh_summary, pruned_summary = cli_stream(torch, dev, root)
        launches.update(runs)
        launches.update(cli_match(torch, root))
        launches.update(cli_calibrate(torch, dev, root, store, frame))
        cli_store(torch, root, store, frame, ref)

        _reset_launches()
        line = bench.run(iters=10, reps=3, device=dev)
        torch.cuda.synchronize()
        bench_launches = _read_launches()
        print(json.dumps(line), flush=True)
        check(line["value"] > 0
              and torch.cuda.get_device_name(0) in line["device"]
              and bench_launches == {"fed_cycle": 15 * 34
                                     + bench_launches.warmup_a,
                                     "sample_patches": 2 * 34
                                     + bench_launches.warmup,
                                     "knn2_hamming": 0},
              f"bench.run(iters=10, reps=3): {line['value']} frames/s on "
              f"{line['device']}; kernels A and B in each of 34 "
              "extractions (the DB's, 3 warm-up and 30 timed steps; "
              f"{bench_launches.warmup} kernel-B launches in ladder "
              "warm-ups)")
        launches["bench"] = (bench_launches, None)

        repo = os.path.dirname(os.path.abspath(__file__))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "cubesat_apds_tpu_torch.cli", "localize",
             "--store", store, "--frame", frame], cwd=repo,
            capture_output=True, text=True, timeout=300)
        cold_s = time.perf_counter() - t0
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
        cold = _cli_json(proc.stdout) if proc.returncode == 0 else {}
        check(proc.returncode == 0
              and {k: v for k, v in cold.items() if k != "seconds"}
              == {k: v for k, v in ref.items() if k != "seconds"},
              f"python -m cubesat_apds_tpu_torch.cli localize (a process of "
              f"its own, default device): exit 0, the JSON of (b), in "
              f"{cold_s:.2f} s wall")
    secs = time.perf_counter() - t_phase
    for label, (l, s) in launches.items():
        if not label.startswith(("calibrate", "store")):
            check(l["fed_cycle"] > 0 and l["sample_patches"] > 0,
                  f"{label}: kernels A and B launched")
    log(f"card: {card} — CLI phase {secs:.1f} s; bench {line['value']} "
        f"frames/s (reps {line['reps']}); cold `python -m` localize "
        f"{cold_s:.2f} s; stream --mesh 2x2 {mesh_summary['sustained_fps']} "
        f"frames/s, --pruned {pruned_summary['sustained_fps']} frames/s")
    return {"seconds": secs, "bench": line, "cold_start_s": cold_s,
            "launches": {k: v[0] for k, v in launches.items()}}


def profile_step(torch, step, out_dir, name, frames_per_step=1):
    """torch.profiler over one warmed step: a table by kernel and a Chrome
    trace in out_dir, and the step's device-busy time and kernel count."""
    import os
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    with open(os.path.join(out_dir, f"{name}_profile.txt"), "w") as f:
        f.write(table)
    prof.export_chrome_trace(os.path.join(out_dir, f"{name}_trace.json"))
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    log(f"profile of one warmed {name} step written to {out_dir}: "
        f"{len(kernels)} device kernels, {busy_ms:.3f} ms device-busy of "
        f"{wall_ms:.2f} ms under the profiler "
        f"(idle share {1.0 - busy_ms / wall_ms:.4f})"
        + (f"; per frame of {frames_per_step}: "
           f"{len(kernels) / frames_per_step:.1f} kernels, "
           f"{busy_ms / frames_per_step:.3f} ms device-busy"
           if frames_per_step > 1 else ""))


def _mark(t_start, label):
    """The seconds since the script started, when a phase has ended."""
    log(f"[{time.perf_counter() - t_start:.1f} s] {label} done")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler table + trace of one "
                    "step of each path")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false — this "
              "smoke run needs an NVIDIA GPU and a CUDA build of PyTorch",
              file=sys.stderr)
        return 2
    try:
        from cubesat_apds_tpu_torch.ops.kernels import build
    except ImportError as e:
        print(f"chip_smoke: FAIL: cannot import cubesat_apds_tpu_torch ({e}); "
              "run from the repository root", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    try:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = card_line()
        log(f"card: {card}")
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"python {sys.version.split()[0]}")
        t0 = time.perf_counter()
        lib = build.load_kernels()
        log(f"kernels built/loaded in {time.perf_counter() - t0:.1f} s: "
            f"{lib.path}")
        if lib.build_log:
            print(lib.build_log, file=sys.stderr)

        t0 = time.perf_counter()
        terrain = synth_satellite(MOSAIC_N, SEED)
        image = build_image(terrain)
        log(f"terrain and build image {MOSAIC_N}² from seed {SEED} in "
            f"{time.perf_counter() - t0:.1f} s")
        rungs = path_rungs(torch, dev, image)
        kernels = kernel_phase(torch, dev, rungs["frame"]) + [
            knn_phase(torch, dev)]
        kernels[-1]["batch_step_shape"] = knn_batch_phase(torch, dev)
        _mark(t_start, "kernel phases")
        a_batch_ms, b_batch_ms = batch_kernel_phase(torch, dev)
        build_kernels = build_kernel_phase(torch, dev, rungs["build"])
        _mark(t_start, "build kernel phase")
        launches, step_s, loc10k, frame_t, path_S, slice_graph = \
            slice_phase(torch, dev, args.profile)
        _mark(t_start, "slice phase")
        big_launches, big_s, loc, big_res, big_frame, big_graph = \
            bigdb_phase(torch, dev, args.profile)
        _mark(t_start, "big-DB phase")
        _, pruned_s, pruned_graph = pruned_phase(
            torch, dev, loc, big_res, big_frame, args.profile)
        _mark(t_start, "pruned phase")
        del big_res
        kernels.append(procrustes_phase(torch, dev, path_S,
                                        launches["procrustes3"]))
        _mark(t_start, "Procrustes phase")
        paired = paired_graphs = graph_pair_phase(torch, dev, loc10k, loc,
                                                  frame_t)
        _mark(t_start, "paired phase")
        streams, stream_ctx = stream_phase(torch, dev, args.profile)
        _mark(t_start, "stream phase")
        mesh = mesh_phase(torch, dev, loc, stream_ctx, image)
        _mark(t_start, "mesh phase")
        hooks = hooks_phase(torch, dev)
        _mark(t_start, "hooks phase")
        del loc, stream_ctx
        with tempfile.TemporaryDirectory() as root:
            store, ds, db_build, tiles_dir, crop = build_phase(torch, dev, root,
                                                            image)
            db_build.update(build_cpu_check(torch, store, ds, tiles_dir))
            db_build.update(build_breakdown(
                torch, ds, len(db_build["keypoints_per_lod"]),
                db_build["seconds"]))
            path = store_write_phase(torch, dev, root, store, crop)
            serve = serve_phase(torch, dev, path, ds,
                                db_build["keypoints_per_lod"])
            del store, ds
            _mark(t_start, "build, serve and store phases")
        tiled = tiled_phase(torch, dev, terrain, image)
        _mark(t_start, "tiled phase")
        part_a = sync_phase(torch, dev, loc10k, frame_t, image)
        _mark(t_start, "sync phase")
        ladder_run = ladder_phase(torch, dev, image)
        _mark(t_start, "ladder phase")
        cli_crop = image[:CLI_CROP, :CLI_CROP].copy()
        del loc10k, image, terrain
        accuracy = accuracy_phase(torch, dev)
        _mark(t_start, "accuracy phase")
        calibration = calibration_phase(torch, dev, card)
        _mark(t_start, "calibration phase")
        modes = modes_phase(torch, dev)
        _mark(t_start, "modes phase")
        cli = cli_phase(torch, dev, card, cli_crop)
        _mark(t_start, "CLI phase")
        launches = dict(launches, knn2_hamming=big_launches["knn2_hamming"])
        kernels[3]["stream_launches_per_batch"] = {
            label: r["launches_per_batch"]["procrustes3"]
            for label, r in streams.items()}
        for k in kernels[:3]:
            name = k["name"]
            k["launches"] = launches[name]
            k["stream_launches_per_batch"] = {
                label: r["launches_per_batch"][name]
                for label, r in streams.items()}
            k["stream_back_half_kernels_per_batch"] = {
                label: r["back_half_kernels_per_batch"]
                for label, r in streams.items()}
            k["build_launches_per_batch"] = db_build["launches_per_batch"][name]
            k["serve_check_launches"] = serve["launches"][name]
            k["tiled_8192_launches"] = tiled["launches"][name]
            k["accuracy_launches_per_frame"] = \
                accuracy["launches_per_frame"][name]
            k["accuracy_launches_per_build"] = \
                accuracy["launches_per_build"][name]
            k["mesh_serve_launches_per_batch"] = \
                mesh["serve"]["launches_per_batch"][name]
            k["mesh_stream_launches_per_batch"] = \
                mesh["stream"]["launches_per_batch"][name]
            k["mesh_build_launches"] = mesh["build"]["launches"][name]
            k["modes_launches_per_frame"] = {
                label: r["launches"][name]
                for label, r in modes["features"].items()}
            k["cli_launches"] = {label: r[name]
                                 for label, r in cli["launches"].items()}
        for k in kernels[:4]:
            k["hooks_entry_launches"] = hooks["entry"]["launches"][k["name"]]
            k["hooks_dryrun_launches"] = \
                hooks["dryrun"]["launches"][k["name"]]
        kernels[2]["mesh_knn_launches_per_call"] = {
            label: r["launches"] for label, r in mesh["knn"].items()}
        kernels[2]["mesh_knn_ms"] = {label: r["ms"]
                                     for label, r in mesh["knn"].items()}
        kernels[2]["mesh_knn_eager_ms"] = {
            label: r["eager_ms"] for label, r in mesh["knn"].items()}
        kernels[1]["modes_describe_device_ms"] = {
            label: r["describe_device_ms"]
            for label, r in modes["features"].items()}
        kernels[0]["batch8_device_ms_per_frame"] = a_batch_ms
        kernels[1]["batch8_device_ms_per_frame"] = b_batch_ms
        kernels[0]["build_tile_b8_device_ms"] = build_kernels["256_b8_device_ms"]
        kernels[0]["tiled_1024_device_ms"] = build_kernels["1024_b1_device_ms"]
        kernels[1]["build_batch"] = {
            "K": build_kernels["B_K"],
            "device_ms": (build_kernels["B_S109_device_ms"]
                          + build_kernels["B_S441_device_ms"]),
            "bound_ms": build_kernels["B_bound_ms"],
            "at_capacity": {
                "K": build_kernels["B_capacity_K"],
                "device_ms": (build_kernels["B_capacity_S109_device_ms"]
                              + build_kernels["B_capacity_S441_device_ms"]),
                "bound_ms": build_kernels["B_capacity_bound_ms"]}}
        kernels[1]["ladder"] = {
            label: {k: r[k] for k in ("K", "rung", "rung_slots", "live",
                                      "capacity_ms", "rung_ms", "live_ms",
                                      "graph_call_ms", "pool_mib",
                                      "eager_peak_mib")}
            for label, r in ladder_run["cases"].items()}
        log(f"card: {card} — slice {1.0 / step_s:.2f} frames/s, big DB "
            f"{1.0 / big_s:.2f} frames/s, pruned {1.0 / pruned_s:.2f} "
            f"frames/s; streams: " + ", ".join(
                f"{label} {r['frames_per_s']:.2f} frames/s (p50 "
                f"{r['p50_s']:.3f} s, p95 {r['p95_s']:.3f} s; "
                f"{r['kernels_per_frame']:.1f} kernels a frame, "
                f"{r['back_half_kernels_per_batch']} in a batch's back half, "
                f"idle {r['idle_share']:.3f})"
                for label, r in streams.items()))
        log(f"card: {card} — syncs: main-path step "
            f"{sum(part_a['sync_sites'].values())}, stream batch of "
            f"{STREAM_BATCH} {sum(part_a['batch_sync_sites'].values())} "
            f"outside its fetch, its fetch "
            f"{sum(part_a['fetch_sync_sites'].values())}")
        log(f"card: {card} — the serving step's graphs (back half, with "
            f"the front half's under 'front'): slice {slice_graph}, big DB "
            f"{big_graph}, pruned {pruned_graph}; paired legs: " + "; ".join(
                f"{label} frames/s " + ", ".join(
                    f"{m} {v}" for m, v in r["frames_per_s"].items())
                + f", host launches {r['host_launches']}, back pool "
                f"{r['pool_mib']:.1f} MiB, capture {r['capture_s']:.3f} s"
                for label, r in paired.items()))
        log(f"card: {card} — build {db_build['seconds']:.2f} s "
            f"({db_build['tiles_per_s']:.2f} tiles/s), serve check LoD "
            f"{serve['lod']} corner error {serve['corner_err_px']:.3f} px, "
            f"tiled 8192² {tiled['tiled_8192_s']:.3f} s, sweep ms "
            f"{tiled['sweep_ms']}; per-keypoint stages "
            f"{part_a['per_keypoint_stages']}")
        log(f"card: {card} — accuracy phase {accuracy['seconds']:.2f} s "
            f"({accuracy['frames']} frames, {accuracy['frames_per_s']:.3f} "
            f"frames/s with rendering, {accuracy['builds']} builds in "
            f"{accuracy['build_s']:.2f} s); calibration: render "
            f"{calibration['render_s']:.3f} s, calibrate "
            f"{calibration['calibrate_warm_s']:.3f} s warm, RMS "
            f"{calibration['rms']:.4f} px, undistort 8 × 512² "
            f"{calibration['undistort_8x512_ms']:.4f} ms")
        log(f"card: {card} — mesh phase {mesh['seconds']:.1f} s: serve "
            f"dp2 x tp2 {mesh['serve']['frames_per_s']:.2f} frames/s "
            f"(paired eager {mesh['serve']['paired_frames_per_s']['eager']}"
            f", graphed {mesh['serve']['paired_frames_per_s']['graphed']}; "
            f"host launches {mesh['serve']['host_launches']}), mesh "
            f"stream {mesh['stream']['frames_per_s']:.2f} frames/s (p50 "
            f"{mesh['stream']['p50_s']:.2f} s, p95 "
            f"{mesh['stream']['p95_s']:.2f} s, idle "
            f"{mesh['stream']['idle_share']:.3f}; again "
            f"{mesh['stream']['frames_per_s_again']:.2f}), sharded kNN-2 ms "
            + ", ".join(f"{k} {v['ms']:.3f} graphed, {v['eager_ms']:.3f} "
                        f"eager (merge {v['merge_ms']:.3f}), one launch "
                        f"{v['one_launch_ms']:.3f}"
                        for k, v in mesh["knn"].items())
            + f"; pools at the phase's end {mesh['pools_mib']} MiB")
        log(f"card: {card} — modes phase {modes['seconds']:.1f} s: slice "
            "step ms " + ", ".join(
                f"{k} {v['step_ms']:.2f} (Jaccard {v['jaccard_vs_exact']:.3f})"
                for k, v in modes["slice"].items()))
        paired = db_build["paired_s"]
        log(f"card: {card} — ladder phase {ladder_run['seconds']:.1f} s: "
            + ", ".join(f"{label} rung {r['rung']} ({r['rung_slots']} "
                        f"slots, {r['live']} live), stage "
                        f"{r['capacity_ms']:.3f} / {r['rung_ms']:.3f} / "
                        f"{r['live_ms']:.3f} ms "
                        f"(capacity / rung / live), pool {r['pool_mib']:.0f}"
                        f" MiB (eager peak {r['eager_peak_mib']:.0f})"
                        for label, r in ladder_run["cases"].items())
            + f"; paired build s: every slot {paired['every slot']}, "
            f"ladder {paired['ladder']}")
        fronts = dict(ladder_run["fronts"], **{
            "slice": slice_graph["front"], "big DB": big_graph["front"],
            "pruned": pruned_graph["front"],
            f"paired B = {STREAM_BATCH}":
                paired_graphs[f"10k slice, B = {STREAM_BATCH}"]["front"],
            "build batch": db_build["front"], "tiled tile": tiled["front"]})
        log(f"card: {card} — the front half's graphs, pool / eager front "
            "end's peak MiB: " + "; ".join(
                f"{label} {r['pool_mib']:.1f} / {r['eager_peak_mib']:.1f}"
                for label, r in fronts.items())
            + f"; host launches in a warmed step: slice "
            f"{slice_graph['host_launches']}, big DB "
            f"{big_graph['host_launches']}, pruned "
            f"{pruned_graph['host_launches']}, build tile batch "
            f"{db_build['front']['host_launches']}; every cached pool at "
            f"the build phase's end {db_build['graph_pools_mib']} MiB")
        log(f"card: {card} — every phase in "
            f"{time.perf_counter() - t_start:.1f} s, the kernels' build "
            "included")
        print(json.dumps({"kernels": kernels}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    except Exception:                       # report any failed phase, exit 1
        traceback.print_exc()
        print("chip_smoke: FAIL", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
