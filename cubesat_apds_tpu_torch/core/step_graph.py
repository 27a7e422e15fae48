"""A function's work on the card as one CUDA graph a key: the port's
counterpart of a `jit`ted function, shared by the serving step's front
half (ops/features/akaze.py, the JAX package's jit of
`detect_and_compute_batch`) and its back half (pipelines/step_graph.py,
the jit of its serving steps). Each keeps its graphs in its own
`GraphCache` (core/graph_cache.py) and calls `run` with it.

The key is what `jit` keys on: the function, the shapes and dtypes of
every tensor of its arguments, every other argument as a value, and the
device; plus the current stream, as the ladder's key has it, so two
streams never share the static buffers.

The first call of a key runs the function once eagerly on a side stream
(the warm-up fills the caches a capture may not fill: the draws and
constants of `device_const`, the kernels' launch counters and launch
attributes, `jacfwd`'s first-call import), then captures it and may
synchronise. With `prime_pool` the warm-up's peak allocation sizes the
graph's memory pool: the pool starts as one free block of that size,
which the capture's tensors split and coalesce back into, so it stays
near the eager peak (the front half's pool, grown a segment at a time,
came to 1.6-1.9x its eager peak on an H100); measuring the peak resets
the device's peak-memory statistic (`torch.cuda.reset_peak_memory_stats`).
Without it the pool grows as the capture allocates (the back half's
stays within ~1.1x its peak that way, and its warm-up can peak at a
third of the card, where one block of that size need not fit beside the
cached graphs). Every call copies its tensors into the graph's static
buffers, as a jitted function takes a traced argument, except a tensor
that is the same object, not written since, as the one copied last time
(a resident DB is copied once; a new DB of the same shapes is copied
into the same graph), then replays the graph and returns clones of its
outputs (an output that is an input is the caller's own tensor), all on
the current stream, so a held result survives the next call. A warm call
reads nothing back to the host.

On the CPU there are no graphs: `run` calls the function. On the card a
failed capture or replay raises; nothing retries eagerly.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import weakref

import torch

from cubesat_apds_tpu_torch.core.graph_cache import (
    close_all, node_counts, pool_bytes)
from cubesat_apds_tpu_torch.core.types import _map_tensors
from cubesat_apds_tpu_torch.ops.kernels import build

# The kernels that count their launches on the device and run in these
# graphs (kernel A in the front half; kernel 4 and the Procrustes kernel
# in the back half): their launches in warm-ups are totalled apart
# (`warmup_launches`).
COUNTED = ("fed_cycle", "knn2_hamming", "procrustes3")
_WARMUP = {k: 0 for k in COUNTED}
_WARMUP_LOCK = threading.Lock()


def leaves(obj) -> list:
    """The tensors of `obj` (tensors, tuples, dataclasses, nested), in
    the order `core.types._map_tensors` visits them."""
    out = []

    def visit(t):
        out.append(t)
        return t

    _map_tensors(obj, visit)
    return out


def spec(obj):
    """The hashable structure of `obj`: every tensor as (shape, dtype,
    device), every dataclass as its type and fields, every other value
    as itself."""
    if isinstance(obj, torch.Tensor):
        return ("tensor", tuple(obj.shape), obj.dtype, str(obj.device))
    if isinstance(obj, (tuple, list)):
        return (type(obj).__name__,) + tuple(spec(x) for x in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__qualname__,) + tuple(
            (f.name, spec(getattr(obj, f.name)))
            for f in dataclasses.fields(obj))
    return obj


def step_key(fn, args: tuple, stream: int) -> tuple:
    """The cache key of a graph: the function, the structure of its
    arguments (shapes, dtypes and devices of the tensors, the other
    values as they are) and the stream (its raw handle)."""
    return (fn, int(stream), spec(args))


def warmup_launches() -> dict:
    """The device-counted launches of kernel A, kernel 4 and the
    Procrustes kernel in every warm-up of a front- or back-half graph so
    far (they are part of each kernel's `device_launches`)."""
    return dict(_WARMUP)


def _counted(device) -> dict:
    return {k: build.device_launches(k, device) for k in COUNTED}


class StepGraph:
    """One key's captured function: the static inputs (copies of the
    first call's arguments), the captured outputs and the graph, which
    holds the memory pool."""

    def __init__(self, key, fn, args, device, prime_pool=False):
        self.key = key
        self.device = device
        self.static_args = _map_tensors(args, lambda t: t.clone())
        self._static = leaves(self.static_args)
        # What each static input last took: (a weak reference to the
        # caller's tensor, its version then).
        self._last = [(weakref.ref(t), t._version) for t in leaves(args)]
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)

        t0 = time.perf_counter()
        before = _counted(device)
        base = torch.cuda.memory_allocated(device)
        if prime_pool:
            torch.cuda.reset_peak_memory_stats(device)
        with torch.cuda.stream(side):
            fn(*self.static_args)
        after = _counted(device)
        self.warmup_peak_bytes = (torch.cuda.max_memory_allocated(device)
                                  - base) if prime_pool else None
        self.warmup_launches = {k: after[k] - before[k] for k in COUNTED}
        with _WARMUP_LOCK:
            for k, n in self.warmup_launches.items():
                _WARMUP[k] += n
        self.warmup_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        self._pool = torch.cuda.MemPool()
        if prime_pool:
            with torch.cuda.stream(side), \
                    torch.cuda.use_mem_pool(self._pool):
                # Allocated on the capturing stream and freed at once: the
                # pool's first free block.
                torch.empty(self.warmup_peak_bytes, dtype=torch.uint8,
                            device=device)
        self._graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(self._graph, pool=self._pool.id, stream=side,
                              capture_error_mode="thread_local"):
            self._out = fn(*self.static_args)
        self.nodes = node_counts(self._graph)
        self._graph.instantiate()
        current.wait_stream(side)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = pool_bytes(self._pool.id)
        # Outputs that are inputs (the features' keypoints) are handed back
        # as the caller's own tensors.
        self._alias = {id(t): i for i, t in enumerate(self._static)}

    def __call__(self, args):
        """Copy `args`' tensors into the static inputs (those not already
        there), replay, and return fresh outputs; all on the current
        stream."""
        given = leaves(args)
        for i, (dst, src) in enumerate(zip(self._static, given)):
            last = self._last[i]
            if last is not None and last[0]() is src \
                    and last[1] == src._version:
                continue
            dst.copy_(src)
            self._last[i] = (weakref.ref(src), src._version)
        self._graph.replay()
        return _map_tensors(self._out, lambda t: given[self._alias[id(t)]]
                            if id(t) in self._alias else t.clone())

    def close(self) -> bool:
        """Drop the graph, its outputs and static inputs, which releases
        the pool; True if there was one to close."""
        if self._graph is None:
            return False
        torch.cuda.synchronize(self.device)       # no replay still running
        self._graph.reset()
        self._graph = self._out = self._pool = None
        self._static = self._last = []
        self.static_args = None
        return True


def run(cache, fn, *args, prime_pool=False):
    """`fn(*args)`: on the card through this key's CUDA graph in `cache`
    (a `GraphCache`; captured at the key's first call, its pool primed
    with the warm-up's peak if `prime_pool`), on the CPU as it is. `args`
    hold tensors on one device (nested in dataclasses and tuples) and
    hashable values."""
    tensors = leaves(args)
    device = tensors[0].device
    if device.type == "cpu":
        return fn(*args)
    if device.type != "cuda":
        raise ValueError(f"step_graph.run: tensors on {device}, neither "
                         "CPU nor CUDA")
    with build.on_device(device):
        key = step_key(fn, args, build.stream_of(tensors[0]))
        entry = cache.get(key)
        if entry is None:
            # The least recently used graph goes before the capture, so
            # its pool is free for the new one.
            close_all(cache.make_room())
            entry = StepGraph(key, fn, args, device, prime_pool)
            cache.put(key, entry)
        return entry(args)
