"""Toy sizes of the benchmark's cells for CPU tests: 128² frames,
capacity 256, DBs of a few thousand rows, a pool of 8 frames, batch 2."""

from __future__ import annotations

from apds_bench import spec

SEED = 2**31 + 12345

_SMALL = {"frame_size": 128,
          "akaze": {"capacity": 256, "descriptor_mode": "exact",
                    "orientation_mode": "exact"}}
_BIG = {"db_rows": 4096, "filler_extent": 512.0, "coarse_rows": 1024,
        "window_capacity": 512, "match": {"ratio": 0.75, "db_block": 1024}}


def cell(name: str):
    """The cell `name` at toy size (its loop, serving path, traffic and
    DB layout as the manifest has them)."""
    c = spec.cell(name)
    c.config.update(_SMALL)
    if c.config["db"] == "filler":
        c.config.update(_BIG)
    else:
        c.config.update(db_rows=1024)
    c.traffic.update(pool=8, check_batches=2)
    if c.traffic["loop"] == "closed":
        c.traffic.update(batch=2, prefetch=4)
    else:
        c.traffic.update(rate_fps=4.0, check_batches=3)
    return c
