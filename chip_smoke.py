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
   sampler, a direct gather) at K=2048 with S=109 and S=441 (bit-exact),
   beside one index_select of the same samples; kernel 4 (Hamming kNN-2
   on int8 tensor cores) bit-exact on d0, d1 and i0 at Q=2048 ×
   M=1,048,576, on a ragged M=1,000,003 with ~5% invalid rows and on rows
   duplicated across the kernel's chunk edges, beside torch._int_mm of the
   same bits (the products alone), with its compiled tile shape, shared
   memory, blocks per SM and, where cuobjdump is at hand, its tensor-core
   (IGMMA) instructions —
   with median times of each kernel and its twin from CUDA events around
   back-to-back eager calls ("ms", what the main path pays per call), each
   kernel's and library call's device time from CUDA-graph replays
   ("device_ms", the host's per-call cost left out), and each kernel's
   bound (the least time the card could take for the same work).
3. Slice phase: bench.py's scene (512² frame from seed 42, a 10,240-row DB
   built by the port from the frame rolled by (7, 13)) through
   Localizer.localize with solve_pose=True: the homography must recover the
   (13, 7) px shift within 1 px, the launch counters must show 15 kernel-A
   and 2 kernel-B launches for the frame, and the same frame run through
   the port on the CPU must agree (homography-inlier Jaccard ≥ 0.95, pose
   ok flag equal, rotation within 0.1°). Times the warmed step: median of
   10, host clock around a synchronised step, with CUDA events recorded
   around each step beside it.
4. Big-DB phase: bench_localize_bigdb.py's scene made on the card from a
   seeded torch.Generator — the 2,048 real rows of the rolled frame, then
   uniform random filler to 1,048,576 rows, xy uniform over [0, 8192)² —
   through Localizer.localize: one kNN-2 launch per frame (plus 15
   kernel-A and 2 kernel-B), (13, 7) within 1 px, matches identical to the
   kernel="scan" twin on the same features, and the warmed step time.
   (The kernel phase also runs kernels A and B on a batch of 8 frames:
   kernel A once per level for the batch, every main-path level, with its
   plan and device time per image; kernel B on 8 stacks folded into its
   stack axis; both bit-exact per image against the twins.)
5. Pruned phase: the same DB with the first 32,768 rows as the coarse DB
   and a window capacity of 16,384, through localize_frame_pruned: coarse
   fix ok, no overflow, (13, 7) within 1 px, and ≥ 0.9 of the big-DB
   step's homography inliers (by global row id) kept; the warmed step time.
6. Stream phase: from seed 42, the 10k scene written as an npz
   FeatureStore and the 1,048,576-row scene as a binary store (LoD 1 = its
   first 32,768 rows), both with a geotransform and an elevation raster;
   loaded through open_store → load_device_db / load_pruned_device_db
   (rows equal to those written, ECEF world points); then 60 frames (a
   pool of 8 seeded shifted 512² uint8 frames, cycled) through
   StreamingLocalizer: 10k at batch 1 and 8, 1M full DB at batch 8, 1M
   pruned at batch 1 and 8. Every frame must recover its shift within
   1 px, its features and matches must equal Localizer.localize's
   (localize_frame_pruned's when pruned) on the same frame and DB, and
   its packed outputs too (or H within 0.01 px at the corners, equal ok
   flags and inlier Jaccard ≥ 0.95). Kernel A launches 15 times and
   kernel B twice per batch, kernel 4 once per frame on the full 1M DB.
   Prints frames/s, ms per frame, latency p50/p95, the stage times,
   fallback frames and launches per batch of each run.

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


def make_frame(rng, n=512):
    """bench.py:_make_frame — corner-rich synthetic satellite frame."""
    img = np.zeros((n, n), np.float32)
    for _ in range(120):
        cy, cx = rng.integers(10, n - 50, 2)
        s = int(rng.integers(8, 40))
        img[cy:cy + s, cx:cx + s] = rng.uniform(0.2, 1.0)
    return img


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


def kernel_phase(torch, dev):
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

    log("kernel B (patch sampler) vs plain twin on the card:")
    L, H, W, K = 16, 512, 512, 2048
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
    b_err, b_bytes = 0.0, 0
    b_ms = b_dev_ms = b_plain_ms = b_lib_ms = b_lib_dev_ms = 0.0
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
        b_err = max(b_err, err)
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
            b_ms += ms
            b_dev_ms += dms
            b_plain_ms += pms
            b_lib_ms += lms
            b_lib_dev_ms += dlms
            # Per sample: iy and ix read, one 8-byte texel read, 16 bytes
            # written.
            b_bytes += K * S * 32
    a_bound = max(a_bytes / HBM_BYTES_PER_S, a_flops / FP32_FLOPS) * 1e3
    b_bound = b_bytes / HBM_BYTES_PER_S * 1e3
    log(f"bounds: kernel A {a_bound:.5f} ms ({a_bytes} B, {a_flops} flops "
        f"over the frame's 15 cycles), kernel B {b_bound:.5f} ms "
        f"({b_bytes} B at S=109+441); kernel B at S=109+441 "
        f"{b_ms:.4f} ms = {b_ms / b_lib_ms:.3f} x index_select (device "
        f"{b_dev_ms:.4f} ms = {b_dev_ms / b_lib_dev_ms:.3f} x)")
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
         "max_abs_err": b_err, "ms": b_ms, "device_ms": b_dev_ms,
         "plain_ms": b_plain_ms, "bound_ms": b_bound, "bound_by": "bytes",
         "library_ms": b_lib_ms, "library_device_ms": b_lib_dev_ms},
    ]


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


def slice_phase(torch, dev, profile_dir):
    from cubesat_apds_tpu_torch.core.config import (
        AkazeConfig, MatchConfig, PipelineConfig, PnPConfig, RansacConfig)
    from cubesat_apds_tpu_torch.core.types import CameraModel
    from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute
    from cubesat_apds_tpu_torch.ops.kernels import diffusion, sample_kernel
    from cubesat_apds_tpu_torch.pipelines.localize import DeviceDb, Localizer

    rng = np.random.default_rng(SEED)
    config = PipelineConfig(akaze=AkazeConfig(capacity=2048),
                            match=MatchConfig(ratio=0.75),
                            ransac=RansacConfig(num_hypotheses=256),
                            pnp=PnPConfig(num_hypotheses=64))
    frame = make_frame(rng)

    # bench.py's DB: the port's features of the frame rolled by (7, 13),
    # tiled to 10,240 rows and perturbed past the first copy.
    t0 = time.perf_counter()
    feats = detect_and_compute(
        torch.from_numpy(np.roll(frame, (7, 13), axis=(0, 1))).to(dev),
        AkazeConfig(capacity=2048))
    desc = feats.descriptors.cpu().numpy()
    xy = feats.keypoints.xy.cpu().numpy()
    valid = feats.keypoints.valid.cpu().numpy()
    log(f"DB features: {int(valid.sum())} keypoints "
        f"({time.perf_counter() - t0:.2f} s incl. first use)")
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
    db = DeviceDb(descriptors=torch.from_numpy(desc_db),
                  xy=torch.from_numpy(xy_db.astype(np.float32)),
                  valid=torch.from_numpy(valid_db),
                  obj_points=torch.from_numpy(obj.astype(np.float32)),
                  has_world=True)
    camera = CameraModel.ideal(500.0, 500.0, 256.0, 256.0)
    gpu = Localizer(db, camera, config, device=dev)
    frame_t = torch.from_numpy(frame)

    gpu.localize(frame_t)                                   # warm-up
    torch.cuda.synchronize()
    diffusion.fed_cycle_cuda.launches = 0
    sample_kernel.sample_patches_cuda.launches = 0
    res = gpu.localize(frame_t)
    torch.cuda.synchronize()
    launches = {"fed_cycle": diffusion.fed_cycle_cuda.launches,
                "sample_patches": sample_kernel.sample_patches_cuda.launches}
    log(f"launches in one frame: {launches}")
    check(launches == {"fed_cycle": 15, "sample_patches": 2},
          "15 kernel-A and 2 kernel-B launches per frame")

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
    return launches, med


def _reset_launches():
    from cubesat_apds_tpu_torch.ops.kernels import (
        diffusion, match_kernel, sample_kernel)
    diffusion.fed_cycle_cuda.launches = 0
    sample_kernel.sample_patches_cuda.launches = 0
    match_kernel.knn2_hamming_cuda.launches = 0


def _read_launches():
    from cubesat_apds_tpu_torch.ops.kernels import (
        diffusion, match_kernel, sample_kernel)
    return {"fed_cycle": diffusion.fed_cycle_cuda.launches,
            "sample_patches": sample_kernel.sample_patches_cuda.launches,
            "knn2_hamming": match_kernel.knn2_hamming_cuda.launches}


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
    from cubesat_apds_tpu_torch.core.config import (
        AkazeConfig, MatchConfig, PipelineConfig, PnPConfig, RansacConfig)
    return PipelineConfig(akaze=AkazeConfig(capacity=2048),
                          match=MatchConfig(ratio=0.75),
                          ransac=RansacConfig(num_hypotheses=256),
                          pnp=PnPConfig(num_hypotheses=64))


def inlier_ids(res, sel=None):
    """Global DB row ids of a step's homography inliers among its matches."""
    m = (res.matches.valid & res.homography.inliers).cpu().numpy()
    ids = res.matches.train_idx.cpu().numpy()[m]
    if sel is not None:
        ids = sel.cpu().numpy()[ids]
    return set(ids.tolist())


def bigdb_phase(torch, dev, profile_dir):
    """bench_localize_bigdb.py's scene, made on the card, through
    Localizer.localize (the kNN-2 kernel with the DB's layout)."""
    import dataclasses

    from cubesat_apds_tpu_torch.core.types import CameraModel
    from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute
    from cubesat_apds_tpu_torch.pipelines.localize import (
        DeviceDb, Localizer, localize_from_features)

    config = serving_config()
    frame = make_frame(np.random.default_rng(SEED))
    frame_t = torch.from_numpy(frame)
    t0 = time.perf_counter()
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
    db = DeviceDb(descriptors=desc, xy=xy, valid=valid, obj_points=obj,
                  has_world=True)
    camera = CameraModel.ideal(500.0, 500.0, 256.0, 256.0)
    loc = Localizer(db, camera, config, device=dev)
    torch.cuda.synchronize()
    log(f"big DB: {m} rows ({n_real} real, "
        f"{int(feats.keypoints.valid.sum())} valid) built with its kNN-2 "
        f"layout in {time.perf_counter() - t0:.2f} s")
    check(loc.db.match_layout is not None, "Localizer made the kNN-2 layout")

    loc.localize(frame_t)                                   # warm-up
    torch.cuda.synchronize()
    _reset_launches()
    res = loc.localize(frame_t)
    torch.cuda.synchronize()
    launches = _read_launches()
    log(f"big-DB launches in one frame: {launches}")
    check(launches == {"fed_cycle": 15, "sample_patches": 2,
                       "knn2_hamming": 1},
          "1 kNN-2, 15 kernel-A and 2 kernel-B launches per big-DB frame")
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

    med = timed_steps(torch, lambda: loc.localize(frame_t), "big-DB")
    if profile_dir:
        profile_step(torch, lambda: loc.localize(frame_t), profile_dir,
                     "bigdb")
    return launches, med, loc, res, frame_t


def pruned_phase(torch, dev, loc, full_res, frame_t, profile_dir):
    """The big DB pruned: the first 32,768 rows as the coarse DB, a window
    capacity of 16,384, through localize_frame_pruned."""
    from cubesat_apds_tpu_torch.pipelines.localize import (
        DeviceDb, localize_frame_pruned, make_pruned_db)

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
        return localize_frame_pruned(frame_t, pdb, loc.camera, config,
                                     solve_pose=True)

    step()                                                  # warm-up
    torch.cuda.synchronize()
    _reset_launches()
    pr = step()
    torch.cuda.synchronize()
    launches = _read_launches()
    log(f"pruned launches in one frame: {launches} (the coarse and window "
        f"DBs are below db_block: dense matches)")
    check(launches == {"fed_cycle": 15, "sample_patches": 2,
                       "knn2_hamming": 0},
          "15 kernel-A and 2 kernel-B launches per pruned frame")
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
    med = timed_steps(torch, step, "pruned")
    if profile_dir:
        profile_step(torch, step, profile_dir, "pruned")
    return launches, med


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
    back half's per-frame features and results recorded (device tensors,
    no copies), then every frame checked against its reference."""
    from cubesat_apds_tpu_torch.pipelines import stream as stream_mod

    s = make_stream()
    b = s.batch
    list(s.run(frames[:b]))                        # warm-up, outside
    torch.cuda.synchronize()
    s.times = type(s.times)()
    record = []
    name = "_pruned_back_half" if kind == "pruned" else \
        "localize_from_features"
    orig = getattr(stream_mod, name)

    def recorded(feats, *a, **k):
        out = orig(feats, *a, **k)
        record.append((feats, out.result if kind == "pruned" else out))
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
    check(launches["fed_cycle"] == 15 * (steps + s.fallback_frames)
          and launches["sample_patches"] == 2 * (steps + s.fallback_frames),
          f"{label}: 15 kernel-A and 2 kernel-B launches per batch of "
          f"{b} ({launches['fed_cycle']} and {launches['sample_patches']} "
          f"for {steps} batches, {s.fallback_frames} fallback frames)")
    if kind == "full1M":
        check(launches["knn2_hamming"] == steps * b + s.fallback_frames,
              f"{label}: one kNN-2 launch per frame served "
              f"({launches['knn2_hamming']} for {steps} x {b} rows)")
    bad = []
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
            log(f"  {label} frame {i}: packed differs in {why}, within the "
                f"stated tolerance")
    lat = sorted(r.latency_s for r in results)
    fps = len(results) / wall
    log(f"{label}: {len(results)} frames in {wall:.3f} s = {fps:.2f} "
        f"frames/s, {wall / len(results) * 1e3:.2f} ms per frame; latency "
        f"p50 {lat[len(lat) // 2] * 1e3:.2f} ms, p95 "
        f"{lat[int(0.95 * len(lat)) - 1] * 1e3:.2f} ms; fallback_frames "
        f"{s.fallback_frames}; launches per batch: "
        f"{ {k: v / steps for k, v in launches.items()} }")
    log("\n".join("    " + ln for ln in s.times.report().splitlines()))
    check(not bad, f"{label}: every frame recovers its shift within 1 px "
          f"and agrees with its reference" + ("" if not bad else
                                              ": " + "; ".join(bad[:5])))
    return {"frames_per_s": fps, "ms_per_frame": wall / len(results) * 1e3,
            "launches_per_batch": {k: v / steps for k, v in launches.items()},
            "fallback_frames": s.fallback_frames}


def stream_phase(torch, dev, profile_dir):
    """bench_stream.py's scene from stores on disk: 60 frames (a pool of 8
    seeded shifted 512² uint8 frames, cycled; capacity 2048) through
    StreamingLocalizer from the 10k npz store at batch 1 and 8, the
    1,048,576-row binary store at batch 8 (full DB, kernel 4 per frame)
    and pruned at batch 1 and 8."""
    import tempfile

    from cubesat_apds_tpu_torch.core.types import CameraModel
    from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute
    from cubesat_apds_tpu_torch.pipelines.localize import (
        Localizer, load_device_db, load_pruned_device_db,
        localize_frame_pruned)
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
                res = localize_frame_pruned(ft, db, camera, config,
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

    runs = [("10k store, batch 1", db10, 1, "full"),
            ("10k store, batch 8", db10, STREAM_BATCH, "full"),
            ("1M store, full DB, batch 8", dbbig, STREAM_BATCH, "full1M"),
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
    return out


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

        kernels = kernel_phase(torch, dev) + [knn_phase(torch, dev)]
        a_batch_ms, b_batch_ms = batch_kernel_phase(torch, dev)
        launches, step_s = slice_phase(torch, dev, args.profile)
        big_launches, big_s, loc, big_res, frame_t = bigdb_phase(
            torch, dev, args.profile)
        _, pruned_s = pruned_phase(torch, dev, loc, big_res, frame_t,
                                   args.profile)
        del loc, big_res
        streams = stream_phase(torch, dev, args.profile)
        launches = dict(launches, knn2_hamming=big_launches["knn2_hamming"])
        for k in kernels:
            k["launches"] = launches[k["name"]]
            k["stream_launches_per_batch"] = {
                label: r["launches_per_batch"][k["name"]]
                for label, r in streams.items()}
        kernels[0]["batch8_device_ms_per_frame"] = a_batch_ms
        kernels[1]["batch8_device_ms_per_frame"] = b_batch_ms
        log(f"card: {card} — slice {1.0 / step_s:.2f} frames/s, big DB "
            f"{1.0 / big_s:.2f} frames/s, pruned {1.0 / pruned_s:.2f} "
            f"frames/s; streams: " + ", ".join(
                f"{label} {r['frames_per_s']:.2f} frames/s"
                for label, r in streams.items()))
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
