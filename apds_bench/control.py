"""The control of the check: the reference with its scale space in
bfloat16 (the nearest precision below the configuration's float32) put in
the program's place, judged against the float32 reference on the frames
a run checks. It has to come out as not correct.

    python3 -m apds_bench.control --workload <cell> --seeds 1 2 3

prints one JSON line a seed with the compared numbers (the upper
readings of limits/<cell>.json). The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from apds_bench import check, inputs, spec


def readings(cell, seed: int, device, precision: str = "bfloat16") -> dict:
    """The numbers of the reference at `precision` against the float32
    reference, over batches drawn as a run draws them; frames cycle the
    pool, so the pool's batches hold every frame a run checks."""
    batch = int(cell.traffic["batch"])
    pool = inputs.frame_pool(cell.config, cell.traffic, seed)
    raw = inputs.make_db(cell.config, seed, device)
    picked = check.sample_batches(len(pool) // batch,
                                  cell.traffic["check_batches"], seed)
    ref = check.reference_rows(cell, pool, raw, picked, batch, device)
    low = check.reference_rows(cell, pool, raw, picked, batch, device,
                               precision)
    numbers = check.compare(low, ref, pool.shape[1:])
    numbers["frames_checked"] = len(ref)
    return numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m apds_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("apds_bench.control: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    device = torch.device("cuda:0")
    lims = check.limits(cell.name)
    for seed in args.seeds:
        numbers = readings(cell, seed, device)
        n = numbers.pop("frames_checked")
        correct, _ = check.judge(numbers, lims)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "frames": n, "correct": correct,
                          "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
