"""The back half of a serving step as one CUDA graph a key: the port's
counterpart of the JAX package's `jit` of its serving steps.

The JAX package compiles each serving step into one executable the host
dispatches once: `localize_frame_jit`, `localize_frame_pruned_jit` and
`localize_frame_pruned_fallback_jit` (cubesat_apds_tpu/pipelines/
localize.py:161, :524, :549) and the stream's batch steps
(cubesat_apds_tpu/pipelines/stream.py:70, :80, :98,
`_make_pruned_batch_step` :112, `_make_local_batch_step` :143). Eager
PyTorch launches every kernel from the host, ~20.5k of them for a back
half (match, RANSAC homography, PnP-RANSAC) whatever the batch. On the
card `run` captures the back half once a key and replays it with one
launch. The front half (the scale space with kernel A, detection and
the level stacks) replays a graph of its own
(ops/features/akaze.py:detect_and_compute_batch), and the capacity
ladder's per-keypoint stage its own (ops/features/ladder.py), so a
warmed step is three graph launches and their copies and clones.

The capture machinery (the key, the warm-up, the static buffers, the
clones) is core/step_graph.py's, shared with the front half; this
module keeps the back half's graphs: up to `STEP_GRAPHS` of them (an
evicted graph frees its memory pool) and `clear_step_graphs()` drops
them all. On the CPU there are no graphs: `run` calls the function.
"""

from __future__ import annotations

from cubesat_apds_tpu_torch.core import step_graph as _core
from cubesat_apds_tpu_torch.core.graph_cache import GraphCache, close_all
from cubesat_apds_tpu_torch.core.step_graph import (  # noqa: F401
    COUNTED, StepGraph, leaves, spec, step_key, warmup_launches)

STEP_GRAPHS = 8
_GRAPHS = GraphCache(STEP_GRAPHS)


def clear_step_graphs() -> int:
    """Drop every cached step graph and free its memory pool; returns how
    many there were."""
    entries = _GRAPHS.clear()
    close_all(entries)
    return len(entries)


def step_graphs() -> list:
    """The cached graphs, least recently used first (their `key`,
    `nodes`, `pool_bytes`, `warmup_s`, `capture_s` and
    `warmup_launches`)."""
    return _GRAPHS.entries()


def run(fn, *args):
    """`fn(*args)`: on the card through this key's CUDA graph (captured at
    its first call), on the CPU as it is. `args` hold tensors on one
    device (nested in dataclasses and tuples) and hashable values."""
    return _core.run(_GRAPHS, fn, *args)
