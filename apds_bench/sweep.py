"""The knee of a periodic cell: the highest periodic rate at which the
program returns every due frame without a backlog that grows over the
window. One process, one set-up, one short window a rate:

    python3 -m apds_bench.sweep --workload <cell> --seed <n> --seconds 10 \
        --rates 16 18 20 22 24

prints one JSON line a rate: frames due and returned, the latency's
median and 95th percentile, and the median latency of the first and of
the last fifth of the frames (a growing backlog shows as the last above
the first). The knee is found once, on the chip, and written into the
cell's traffic file as `rate_fps` (0.8 × the knee)."""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from apds_bench import inputs, run, spec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m apds_bench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("apds_bench.sweep: no CUDA card", file=sys.stderr)
        return 2
    from cubesat_apds_tpu_torch.core.types import CameraModel
    from cubesat_apds_tpu_torch.pipelines.stream import StreamingLocalizer

    cell = spec.cell(args.workload)
    cfg, traffic = cell.config, cell.traffic
    device = torch.device("cuda:0")
    pool = inputs.frame_pool(cfg, traffic, args.seed)
    raw = inputs.make_db(cfg, args.seed, device)
    pcfg = inputs.program_config(cfg)
    serve = spec.serve_module(traffic["serve"])
    camera = CameraModel.ideal(*inputs.camera_args(cfg), device=device)
    stream = StreamingLocalizer(
        serve.program_db(raw, cfg, pcfg, device), camera, pcfg,
        solve_pose=cfg["solve_pose"], prefetch=int(traffic["prefetch"]),
        batch=int(traffic["batch"]), device=device)
    for _ in stream.run(pool[:run.WARM_BATCHES * int(traffic["batch"])]):
        pass
    torch.cuda.synchronize(device)
    for rate in args.rates:
        loop = spec.loop_module(traffic["loop"]).Loop(
            dict(traffic, rate_fps=rate), pool, args.seconds)
        got = {}
        t0 = time.perf_counter()
        loop.start(t0)
        for r in stream.run(loop.frames()):
            got[r.frame_id] = (r, time.perf_counter())
        n = loop.n_due
        lat = [1e3 * (got[i][1] - loop.due(i)) for i in range(n) if i in got]
        fifth = max(n // 5, 1)
        print(json.dumps({
            "rate_fps": rate, "due": n, "returned": len(got),
            "ok": sum(1 for r, _ in got.values() if r.homography_ok),
            "p50_ms": run.percentile(lat, 50),
            "p95_ms": run.percentile(lat, 95),
            "first_fifth_p50_ms": statistics.median(lat[:fifth]),
            "last_fifth_p50_ms": statistics.median(lat[-fifth:]),
            "late_max_ms": 1e3 * max(h - loop.due(i)
                                     for i, h in enumerate(loop.handed))}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
