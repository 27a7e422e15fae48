"""One run of one cell of the benchmark of `cubesat_apds_tpu_torch`.

    python3 -m apds_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. The run

1. loads the cell from BENCHMARK.json and its files by name (spec.py);
2. makes the frame pool and the DB from `--seed` (inputs.py);
3. builds the port's serving state (`serve/<mode>.py`) and a
   `StreamingLocalizer` at the cell's batch and prefetch, and warms up the
   cell's own graph keys through the stream itself;
4. drives `StreamingLocalizer.run` for `--seconds` through the frame
   iterable of `loops/<loop>.py`;
5. with `--trace 1`, profiles a short steady stretch of the window and
   reads the cell's per-layer metrics (`metrics/<name>.py`) after it;
6. frees the program's state and runs the plain reference (reference/)
   over a seeded sample of the window's batches (check.py);
7. prints the compared numbers beside their limits as the last lines of
   standard error, and one JSON line as the last line of standard output.

Without a card (or with fewer than the cell asks for) it prints no
result and exits 2. If JAX or the JAX package is loaded once the window
has closed it prints no result and exits 3.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The process's start on the perf_counter clock (Linux's
    /proc/self/stat; now where that cannot be read)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return now - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return now


T_PROCESS = _process_start()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from apds_bench import check, inputs, spec, trace  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "cubesat_apds_tpu")
WARM_BATCHES = 3
TIMED_CALLS = 10
STRETCH_AT = 0.4      # the traced stretch starts at this share of the window
STRETCH_S = 0.5       # and lasts this long


def banned_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in BANNED})


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"],
            capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return "not read"


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of the
    values at or under it."""
    xs = sorted(values)
    return xs[max(math.ceil(q / 100.0 * len(xs)) - 1, 0)]


class Context:
    """What the per-layer readers read (metrics/_layers.py): the window's
    stage times, the traced stretch, and calls into the program at the
    cell's shapes."""

    def __init__(self, stream, serve, pcfg, batch_u8, device, stretch):
        self.stream = stream
        self.serve = serve
        self.pcfg = pcfg
        self.device = device
        self.times = stream.times
        self.stretch = stretch
        self._frames = inputs.as_float(torch.from_numpy(batch_u8).to(device))
        self._feats = None

    def cuda_ms(self, fn, iters: int = TIMED_CALLS):
        """ms a call of fn() on the card, CUDA events over `iters`
        back-to-back calls after one; None off the card."""
        if self.device.type != "cuda":
            return None
        fn()
        torch.cuda.synchronize(self.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(self.device)
        return start.elapsed_time(end) / iters

    def front_call(self):
        from cubesat_apds_tpu_torch.ops.features.akaze import (
            detect_and_compute_batch)
        return lambda: detect_and_compute_batch(self._frames, self.pcfg.akaze)

    def features(self):
        if self._feats is None:
            self._feats = self.front_call()()
        return self._feats

    def back_call(self):
        feats, hw = self.features(), tuple(self._frames.shape[1:])
        return lambda: self.serve.back_half(self.stream, feats, hw)

    def knn2_call(self):
        """(fn, Q, M) of kernel 4 alone on this batch's queries against the
        stream's DB, or None where the stream's path never calls it."""
        layout = getattr(self.stream.db, "match_layout", None)
        if layout is None or self.device.type != "cuda":
            return None
        from cubesat_apds_tpu_torch.ops.kernels.match_kernel import (
            knn2_hamming_cuda, pack_words)
        desc = self.features().descriptors
        q_words = pack_words(desc.reshape(-1, desc.shape[-1])).contiguous()
        words, vpop = layout
        return (lambda: knn2_hamming_cuda(q_words, words, vpop),
                q_words.shape[0], words.shape[0])


def _free_program_state(device) -> None:
    from cubesat_apds_tpu_torch.ops.features import akaze, ladder
    from cubesat_apds_tpu_torch.pipelines import step_graph
    akaze.clear_front_graphs()
    ladder.clear_ladder_graphs()
    step_graph.clear_step_graphs()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def reference_check(cell, pool, raw, results, batch, seed, device) -> dict:
    """The compared numbers over a seeded sample of the window's batches:
    the reference over each sampled batch, as the stream formed it."""
    picked = check.sample_batches(len(results) // batch,
                                  cell.traffic["check_batches"], seed)
    ref = check.reference_rows(cell, pool, raw, picked, batch, device)
    prog = [None if results[i] is None else check.program_row(results[i])
            for b in picked for i in range(b * batch, (b + 1) * batch)]
    numbers = check.compare(prog, ref, pool.shape[1:])
    numbers["frames_checked"] = len(ref)
    return numbers


def execute(cell, seed: int, seconds: float, traced: bool, device,
            t_process: float = T_PROCESS) -> tuple:
    """One run on `device`: (the result dict, the check table)."""
    from cubesat_apds_tpu_torch.core.types import CameraModel
    from cubesat_apds_tpu_torch.pipelines.stream import StreamingLocalizer
    from cubesat_apds_tpu_torch.utils.profiling import StageTimes

    cfg, traffic = cell.config, cell.traffic
    batch = int(traffic["batch"])
    phases = [("imports", time.perf_counter())]
    pool = inputs.frame_pool(cfg, traffic, seed)
    phases.append(("frame pool", time.perf_counter()))
    raw = inputs.make_db(cfg, seed, device)
    phases.append(("DB", time.perf_counter()))
    pcfg = inputs.program_config(cfg)
    serve = spec.serve_module(traffic["serve"])
    camera = CameraModel.ideal(*inputs.camera_args(cfg), device=device)
    stream = StreamingLocalizer(
        serve.program_db(raw, cfg, pcfg, device), camera, pcfg,
        solve_pose=cfg["solve_pose"], prefetch=int(traffic["prefetch"]),
        batch=batch, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phases.append(("serving state", time.perf_counter()))

    # Warm-up: the cell's own keys, through the stream itself.
    for _ in stream.run(pool[:WARM_BATCHES * batch]):
        pass
    serve.warm_extra(stream, pool[0])
    if traced:
        trace.warm_profiler()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phases.append(("warm-up", time.perf_counter()))
    stream.times = StageTimes()
    stream.fallback_frames = 0
    gc.collect()
    gc.freeze()

    loop = spec.loop_module(traffic["loop"]).Loop(traffic, pool, seconds)
    got: dict = {}
    prof, stretch, n_disp = None, None, 0
    t_on = None
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    loop.start(t0)
    for r in stream.run(loop.frames()):
        t = time.perf_counter()
        got[r.frame_id] = (r, t)
        if not traced:
            continue
        if prof is None and stretch is None \
                and t >= t0 + STRETCH_AT * seconds:
            prof = trace.profiler()
            prof.start()
            t_on = time.perf_counter()
            n_disp = len(stream.times.values("dispatch"))
        elif prof is not None and t >= t_on + STRETCH_S:
            t_off = time.perf_counter()
            prof.stop()
            stretch = trace.reduce(
                prof, t_off - t_on,
                len(stream.times.values("dispatch")) - n_disp)
            prof = None
    if prof is not None:        # the window ended inside the stretch
        t_off = time.perf_counter()
        prof.stop()
        stretch = trace.reduce(prof, t_off - t_on,
                               len(stream.times.values("dispatch")) - n_disp)
    gc.unfreeze()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = int(torch.cuda.max_memory_allocated(device))
    else:
        peak = 0
    t_end = t0 + seconds

    attempted = len(loop.handed)
    results = [got.get(i, (None, None))[0] for i in range(attempted)]
    failed = sum(1 for r in results if r is None or not r.homography_ok)
    note = sys.stderr
    steps = [f"{name} {b - a:.2f} s" for (_, a), (name, b)
             in zip([("start", t_process)] + phases, phases)]
    print(f"[apds_bench] set-up: {', '.join(steps)}", file=note, flush=True)
    print(f"[apds_bench] {cell.name} seed {seed}: {attempted} frames sent, "
          f"{len(got)} returned, {failed} failed, fallback frames "
          f"{stream.fallback_frames}, pose_ok "
          f"{sum(1 for r in results if r is not None and r.pose_ok)}",
          file=note, flush=True)

    per_s = np.bincount([int(t - t0) for _, t in got.values() if t <= t_end],
                        minlength=int(math.ceil(seconds)))
    print(f"[apds_bench] frames returned a second: {per_s.tolist()}",
          file=note, flush=True)

    metrics: dict = {}
    e2e = {m["name"]: m for m in cell.end_to_end}
    if not traced:
        returned = sum(1 for _, t in got.values() if t <= t_end)
        values = {"setup_s": setup_s, "frames_per_s": returned / seconds}
        due = [loop.due(i) for i in range(attempted)]
        if due and due[0] is not None:
            lat = [math.inf if r is None or not r.homography_ok
                   else got[i][1] - due[i] for i, r in enumerate(results)]
            late = [h - d for h, d in zip(loop.handed, due)]
            print(f"[apds_bench] generator lateness: p95 "
                  f"{1e3 * percentile(late, 95):.3f} ms, max "
                  f"{1e3 * max(late):.3f} ms over {len(late)} frames",
                  file=note, flush=True)
            values["latency_p50_ms"] = 1e3 * percentile(lat, 50)
            values["latency_p95_ms"] = 1e3 * percentile(lat, 95)
        for name, m in e2e.items():
            # `<quantity>.<group>` reports the quantity: a group of cells
            # with a bound of its own (`frames_per_s.pruned`).
            v = values[name.split(".")[0]]
            if not math.isfinite(v):
                print(f"[apds_bench] {name}: infinite (failed frames)",
                      file=note, flush=True)
                v = 1e12
            metrics[name] = {"value": v, "unit": m["unit"]}
    else:
        ctx = Context(stream, serve, pcfg, np.stack(pool[:batch]), device,
                      stretch)
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        del ctx
        if stretch is not None:
            print(f"[apds_bench] traced stretch: {stretch.window_s:.4f} s, "
                  f"device busy {stretch.busy_s:.4f} s, "
                  f"{stretch.device_events} device events over "
                  f"{stretch.batches} batches "
                  f"({stretch.device_events / max(stretch.batches, 1):.0f} "
                  f"a batch)", file=note, flush=True)

    stream.times = None
    del stream
    _free_program_state(device)
    t_check = time.perf_counter()
    numbers = reference_check(cell, pool, raw, results, batch, seed, device)
    print(f"[apds_bench] checked {numbers.pop('frames_checked')} frames "
          f"against the reference in {time.perf_counter() - t_check:.1f} s",
          file=note, flush=True)
    correct, table = check.judge(numbers, check.limits(cell.name))

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": 1, "memory_peak_bytes": peak,
           "power": power_limit() if device.type == "cuda" else "n/a"}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if traced and stretch is not None:
        dev["busy_s"] = stretch.busy_s
        dev["window_s"] = stretch.window_s
        out["breakdown"] = {"device_ops": stretch.device_ops,
                            "idle_gaps": stretch.idle_gaps}
    out["checks"] = table
    return out, table


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m apds_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec.cell(args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"apds_bench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"this machine has {cards}: no result", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    torch.set_num_threads(1)      # one host thread of CPU ops: less jitter
    out, table = execute(cell, args.seed, args.seconds, bool(args.trace),
                         device)
    found = banned_modules()
    if found:
        print(f"apds_bench: JAX or the JAX package is loaded: {found}; "
              "no result", file=sys.stderr)
        return 3
    for name, v in table.items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
