"""What the port's CUDA graphs share: a bounded LRU of captured graphs,
the closing of the graphs it drops, a memory pool's size, and a graph's
node counts.

Three kinds of graph use it: the serving step's front half
(ops/features/akaze.py), the capacity ladder's (ops/features/ladder.py)
and the serving step's back half (pipelines/step_graph.py). Each keeps
one graph a key in its own cache; an entry is any object with a
`close()` that frees its graph and pool and says whether there was one
on a card.
"""

from __future__ import annotations

import collections
import ctypes
import threading

import torch


class GraphCache:
    """A bounded LRU of captured graphs. `make_room` evicts down to one
    below the bound before a capture, `clear` empties the cache; both
    return the entries they drop, for the caller to close."""

    def __init__(self, size: int):
        self.size = size
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self) -> list:
        with self._lock:
            return list(self._entries)

    def get(self, key):
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
            return entry

    def make_room(self) -> list:
        with self._lock:
            evicted = []
            while len(self._entries) >= self.size:
                evicted.append(self._entries.popitem(last=False)[1])
            return evicted

    def put(self, key, entry) -> None:
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)

    def clear(self) -> list:
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
            return entries

    def entries(self) -> list:
        """The cached entries, least recently used first."""
        with self._lock:
            return list(self._entries.values())


def close_all(entries) -> None:
    """Close evicted or cleared graphs; a card's freed pools go back to
    the device at once."""
    on_card = False
    for entry in entries:
        on_card |= entry.close()
    if on_card:
        torch.cuda.empty_cache()


def pool_bytes(pool) -> int:
    """Bytes the caching allocator holds in the graph memory pool
    `pool` (a `torch.cuda.graph_pool_handle()`)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool))


def node_counts(graph) -> dict:
    """The nodes of a captured `torch.cuda.CUDAGraph(keep_graph=True)`:
    all of them, its kernels, memory copies and memsets (what one replay
    runs on the device)."""
    from cubesat_apds_tpu_torch.ops.kernels import build

    counts = (ctypes.c_int * 4)()
    build.check_launch("apds_graph_node_counts",
                       build.load_kernels().lib.apds_graph_node_counts(
                           graph.raw_cuda_graph(), counts))
    return dict(zip(("nodes", "kernels", "copies", "memsets"), counts))
