"""The 10k stream of bench.py's scene at batch 1 and 8, from the port in
the tree given, for a paired comparison of two trees on one GPU.

    python3 stream_pair.py TREE

TREE is a checkout of this repository (`.` for this one). Prints one JSON
line: per batch size the frames/s of 48 frames (8 seeded shifts of the
frame, cycled) through StreamingLocalizer, their latency p50/p95, and
one warmed step under torch.profiler: its device kernels, device-busy ms,
wall ms and idle share. Compare two trees as A, B, B, A, back to back:

    for t in parent . . parent; do python3 stream_pair.py $t; done
"""
import json
import sys
import time

sys.path.insert(0, sys.argv[1])

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from cubesat_apds_tpu_torch.bench import scene  # noqa: E402
from cubesat_apds_tpu_torch.pipelines.stream import (  # noqa: E402
    StreamingLocalizer)

dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
frame, db, camera, config = scene(dev)
shifts = np.random.default_rng(45).integers(-4, 5, (8, 2))
base = (frame * 255).astype(np.uint8)
pool = [np.roll(base, (-dy, -dx), axis=(0, 1)) for dx, dy in shifts]
frames = [pool[i % 8] for i in range(48)]
out = {"tree": sys.argv[1]}
for b in (1, 8):
    s = StreamingLocalizer(db, camera, config, solve_pose=True,
                           prefetch=2 * b, batch=b, device=dev)
    list(s.run(frames[:b]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = list(s.run(frames))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lat = sorted(r.latency_s for r in res)
    x = torch.stack([torch.from_numpy(f) for f in pool[:b]]).to(dev)
    s._step(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s._step(x)
        torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    out[f"b{b}"] = {"frames_per_s": len(res) / wall,
                    "p50_s": lat[len(lat) // 2],
                    "p95_s": lat[int(0.95 * len(lat)) - 1],
                    "kernels_per_step": len(ev), "busy_ms": busy,
                    "profiled_step_ms": step_ms, "idle": 1 - busy / step_ms,
                    "h_ok": int(sum(r.homography_ok for r in res))}
print(json.dumps(out), flush=True)
