"""The capacity ladder on the card: orientation and MLDB on a rung the
device picks (the counterpart of the JAX package's `lax.switch` in
ops/features/akaze.py:_adaptive_orient_describe_batched).

The valid keypoints of every image are a response-sorted prefix, so the
per-keypoint stages may run on any prefix of the capacity that holds the
batch's largest live count and give the same bits. The JAX package
switches over a ladder of such prefixes (`_bucket_sizes`) on that count.
Eager PyTorch has no device-side branch, so the card runs a CUDA graph:

    head -> select -> SWITCH(body 0 | ... | body n-1)

`head` computes the rung index of the batch's largest live count and
zeroes the outputs, `select` copies the index into the switch's handle,
and body r runs the stage on the first `buckets[r]` slots, writing its
prefix of the outputs (csrc/ladder_graph.cu assembles the graph; torch
2.11 has no conditional nodes of its own). Nothing is read back to the
host, so a warmed call only queues work.

One graph a key (device, stream, batch, stack shape, capacity, modes,
ladder), in a bounded LRU (`LADDER_GRAPHS` of them, core/graph_cache.py's
cache, which the serving step's graphs share); an evicted graph
frees its memory pool, and `clear_ladder_graphs()` drops them all. The
first call of a key warms every rung up eagerly on a side stream, then
captures, and may synchronise; a warm call copies its inputs into the
graph's static buffers, launches it and returns clones of the outputs,
all on the current stream. The stream is part of the key, so two streams
never share the static buffers, and the clones keep a caller's result
unchanged by the next call.
"""

from __future__ import annotations

import ctypes
import threading
import time

import torch

from cubesat_apds_tpu_torch.core.graph_cache import (
    GraphCache, close_all as _close_all, pool_bytes)
from cubesat_apds_tpu_torch.ops.kernels import build, sample_kernel

LADDER_GRAPHS = 8
_WARMUP = {"launches": 0}
_WARMUP_LOCK = threading.Lock()


def warmup_launches() -> int:
    """Kernel B's launches in every ladder warm-up so far, as its device
    counter saw them (they are part of `sample_kernel.device_launches`)."""
    return _WARMUP["launches"]


def ladder_key(device, stream: int, batch: int, packed_shape, capacity: int,
               config, buckets) -> tuple:
    """The cache key of a ladder graph: everything its capture fixes.
    The stream (its raw handle) keeps two streams' static buffers apart;
    the configuration enters through the three fields the stage reads."""
    return (str(device), int(stream), int(batch), tuple(packed_shape),
            int(capacity), config.descriptor_mode, config.orientation_mode,
            config.hybrid_subcells, tuple(buckets))


_GRAPHS = GraphCache(LADDER_GRAPHS)


def clear_ladder_graphs() -> int:
    """Drop every cached ladder graph and free its memory pool; returns
    how many there were."""
    entries = _GRAPHS.clear()
    _close_all(entries)
    return len(entries)


def ladder_graphs() -> list:
    """The cached graphs, least recently used first (their `key`,
    `pool_bytes`, `warmup_launches`, `capture_s` and `last_rung()`)."""
    return _GRAPHS.entries()


class LadderGraph:
    """One key's captured ladder: static inputs, static outputs, the
    rung index, the PyTorch graphs of the head and the bodies (they hold
    the memory pool) and the assembled executable."""

    def __init__(self, key, device, stage, rung_of, fields, config, buckets):
        self.key = key
        self.device = device
        self.buckets = tuple(buckets)
        bsz, capacity = fields[0].shape[:2]
        # Static buffers, outside the pool: the inputs' copies, the
        # outputs the bodies write and the rung index.
        self.static = [t.clone() for t in fields]
        self.angle = torch.empty((bsz, capacity), dtype=torch.float32,
                                 device=device)
        self.desc = torch.empty((bsz, capacity, 61), dtype=torch.uint8,
                                device=device)
        self.rung = torch.zeros((), dtype=torch.int32, device=device)
        self._stage = stage
        self._config = config

        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        # Warm-up, one eager run of every rung: the stage's constants are
        # uploaded (device_const, which refuses an upload under capture),
        # the kernel library is loaded and every op has run once. Its
        # kernel-B launches count on the device like any other; they are
        # also totalled apart (`warmup_launches`).
        t0 = time.perf_counter()
        before = sample_kernel.device_launches(device)
        with torch.cuda.stream(side):
            for kb in self.buckets:
                self._run_stage(kb)
        self.warmup_launches = sample_kernel.device_launches(device) - before
        with _WARMUP_LOCK:
            _WARMUP["launches"] += self.warmup_launches
        self.warmup_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        pool = torch.cuda.graph_pool_handle()

        def capture(fn):
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph, pool=pool, stream=side,
                                  capture_error_mode="thread_local"):
                fn()
            return graph

        valid = self.static[4]

        def head():
            self.rung.copy_(rung_of(valid.sum(-1).max(), self.buckets))
            self.angle.zero_()
            self.desc.zero_()

        self._head = capture(head)
        # The largest rung first: its freed blocks split to serve every
        # smaller body, so the pool holds about one rung's intermediates
        # (smallest first, each body's larger blocks would need segments
        # of their own: the sum of all rungs).
        bodies = {kb: capture(lambda kb=kb: self._run_stage(kb))
                  for kb in sorted(self.buckets, reverse=True)}
        self._bodies = [bodies[kb] for kb in self.buckets]
        self.pool_bytes = pool_bytes(pool)

        lib = build.load_kernels().lib
        bodies = (ctypes.c_void_p * len(self._bodies))(
            *(g.raw_cuda_graph() for g in self._bodies))
        out = (ctypes.c_void_p * 2)()
        build.check_launch(
            "apds_ladder_graph (a CUDA graph with a conditional SWITCH "
            "node, which needs a CUDA 12.8+ runtime and driver)",
            lib.apds_ladder_graph(device.index, self._head.raw_cuda_graph(),
                                  bodies, len(self._bodies),
                                  build.ptr(self.rung), out))
        self._graph, self._exec = out[0], out[1]
        self.capture_s = time.perf_counter() - t0

    def _run_stage(self, kb: int):
        """The stage on the first kb slots of the static inputs, into the
        static outputs' prefix (every replay's head zeroes them first)."""
        s = self.static
        self.angle[:, :kb], self.desc[:, :kb] = self._stage(
            *s[:7], kb, self._config, tuple(s[7:]) or None)

    def __call__(self, fields):
        """Copy `fields` into the static inputs, launch the graph, return
        fresh (angle, desc); everything on the current stream."""
        for dst, src in zip(self.static, fields):
            dst.copy_(src)
        lib = build.load_kernels().lib
        build.check_launch("apds_graph_launch", lib.apds_graph_launch(
            self._exec, build.stream_of(self.rung)))
        return self.angle.clone(), self.desc.clone()

    def last_rung(self) -> int:
        """The rung index of the last launch (reads it back: a sync)."""
        return int(self.rung)

    def close(self) -> bool:
        """Destroy the executable and drop the PyTorch graphs, which
        releases the pool; True if there was one to close."""
        if self._exec is None:
            return False
        torch.cuda.synchronize(self.device)       # no launch still running
        err = build.load_kernels().lib.apds_graph_destroy(self._graph,
                                                          self._exec)
        self._graph = self._exec = None
        self._head = self._bodies = None
        self.static = []
        build.check_launch("apds_graph_destroy", err)
        return True


def run_ladder(stage, rung_of, fields, config, buckets):
    """(angle [B, capacity], desc [B, capacity, 61]) of the stage on the
    rung the device picks, through this key's graph (captured at its
    first call).

    stage(xy, size, class_id, octave, valid, packed, level_hw, n, config,
    grids) → (angle [B, n], desc [B, n, 61]) is the stage on the first n
    slots; rung_of(count, buckets) the rung index of a live count (torch
    ops on its device); fields = [xy, size, class_id, octave, valid,
    packed, level_hw, *grids] on one CUDA device."""
    packed = fields[5]
    device = packed.device
    if device.type != "cuda":
        raise ValueError(f"run_ladder: tensors on {device}, not CUDA")
    bsz, capacity = fields[4].shape
    key = ladder_key(device, build.stream_of(packed), bsz, packed.shape,
                     capacity, config, buckets)
    entry = _GRAPHS.get(key)
    if entry is None:
        # The least recently used graph goes before the capture, so its
        # pool is free for the new one.
        _close_all(_GRAPHS.make_room())
        entry = LadderGraph(key, device, stage, rung_of, fields, config,
                            buckets)
        _GRAPHS.put(key, entry)
    return entry(fields)
