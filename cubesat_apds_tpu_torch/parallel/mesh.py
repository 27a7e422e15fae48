"""Device mesh for multi-device serving and DB builds (port of
parallel/mesh.py).

A `Mesh` is a [dp, tp] grid of device slots with two axes, as in the JAX
package:

  * "dp": data parallelism over frames or tiles;
  * "tp": the descriptor-DB axis of the Hamming kNN-2, each slot matching
    against its shard, the [Q]-sized top-2 partials merged after.

PyTorch has no virtual devices (the JAX package's tests force eight CPU
devices), so one device may fill several slots: a mesh of four slots
over one card cuts a DB into four shards and runs kernel 4 once per
shard, as four cards would, minus the overlap between cards. On the CPU
the tests build meshes of 1–8 `cpu` slots.

Across processes (`initialize_distributed`, a torch.distributed process
group), every process brings its own slots; `make_mesh()` spans them all,
in rank order, as the JAX package's global mesh spans every process's
devices. A process computes only on its own slots. The partials and the
replicated outputs cross processes through `all_reduce(MIN)` and
`broadcast`, the collectives that gloo and NCCL both run on CUDA tensors.

On the card the mesh's local work runs as CUDA graphs, one a key, as the
JAX package jits its mesh steps: a dp row's partials and their merge
(parallel/sharded_match.py), or, when one process holds the whole row on
one device, the row's whole back half (parallel/serve.py). Up to
`MESH_GRAPHS` of them stay cached (`mesh_graphs()`); `clear_mesh_graphs()`
drops them and frees their pools. The collectives stay outside every
graph: across processes a row's graphs end at its `all_reduce` and start
again after it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from cubesat_apds_tpu_torch.core import step_graph
from cubesat_apds_tpu_torch.core.graph_cache import GraphCache, close_all

_ENV = ("APDS_COORDINATOR", "APDS_NUM_PROCESSES", "APDS_PROCESS_ID")

MESH_GRAPHS = 8
_GRAPHS = GraphCache(MESH_GRAPHS)


def clear_mesh_graphs() -> int:
    """Drop every cached mesh graph and free its memory pool; returns how
    many there were."""
    entries = _GRAPHS.clear()
    close_all(entries)
    return len(entries)


def mesh_graphs() -> list:
    """The cached mesh graphs, least recently used first (their `key`,
    `nodes`, `pool_bytes`, `warmup_s`, `capture_s` and
    `warmup_launches`)."""
    return _GRAPHS.entries()


def run_graph(fn, *args):
    """`fn(*args)`: on the card through this key's CUDA graph in the mesh's
    cache (captured at its first call; its pool grows as the capture
    allocates), on the CPU as it is. `args` hold tensors on one device."""
    return step_graph.run(_GRAPHS, fn, *args)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: str = "gloo") -> bool:
    """Join this process to a torch.distributed group over
    tcp://<coordinator> (host:port of process 0).

    Arguments fall back to the APDS_COORDINATOR / APDS_NUM_PROCESSES /
    APDS_PROCESS_ID environment variables. Returns False when none is set
    (a single-process run) and refuses a partial set, naming what is
    missing. The backend is gloo (CPU and CUDA tensors) unless the caller
    names "nccl" (one rank per card). After it returns True, `make_mesh()`
    spans every process's slots. Safe to call twice: the second call
    returns True and does nothing.
    """
    coordinator = coordinator or os.environ.get("APDS_COORDINATOR")
    if num_processes is None and os.environ.get("APDS_NUM_PROCESSES"):
        num_processes = int(os.environ["APDS_NUM_PROCESSES"])
    if process_id is None and os.environ.get("APDS_PROCESS_ID"):
        process_id = int(os.environ["APDS_PROCESS_ID"])
    given = (coordinator, num_processes, process_id)
    if all(v is None for v in given):
        return False
    if any(v is None for v in given):
        missing = [name for name, v in zip(_ENV, given) if v is None]
        raise ValueError(
            "partial distributed configuration: set all of "
            "APDS_COORDINATOR, APDS_NUM_PROCESSES and APDS_PROCESS_ID "
            f"(or none of them for a single-process run); missing: "
            f"{', '.join(missing)}")
    if dist.is_initialized():
        return True
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return True


def _default_local_devices():
    """Every visible card; a CPU mesh only when the caller names it."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                           "devices=['cpu', ...] for a CPU mesh")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A [dp, tp] grid of device slots. `devices[i, j]` is slot (i, j)'s
    torch.device and `ranks[i, j]` the process that owns it; `rank` is this
    process. A device may fill several slots."""

    devices: np.ndarray
    ranks: np.ndarray
    rank: int = 0

    @property
    def shape(self) -> dict:
        dp, tp = self.devices.shape
        return {"dp": dp, "tp": tp}

    def is_local(self, i: int, j: int) -> bool:
        return int(self.ranks[i, j]) == self.rank

    @property
    def multiprocess(self) -> bool:
        return len(set(self.ranks.ravel().tolist())) > 1

    def row_groups(self, i: int) -> list:
        """This process's slots of dp row i as (device, columns) groups, one
        a device, ordered by their first column: the first group holds the
        row's first local slot."""
        groups: dict = {}
        for j in range(self.devices.shape[1]):
            if self.is_local(i, j):
                groups.setdefault(self.devices[i, j], []).append(j)
        return [(d, tuple(cols)) for d, cols in groups.items()]

    def row_device(self, i: int) -> Optional[torch.device]:
        """The device of dp row i when this process alone holds the whole
        row and on that one device (its work needs no collective), else
        None."""
        groups = self.row_groups(i)
        if self.multiprocess or len(groups) != 1:
            return None
        return groups[0][0]

    @property
    def home(self) -> torch.device:
        """This process's first slot (row-major): where its replicated
        outputs land."""
        for i, j in np.ndindex(*self.devices.shape):
            if self.is_local(i, j):
                return self.devices[i, j]
        raise ValueError(f"mesh has no slot of process {self.rank}")


def make_mesh(dp: Optional[int] = None, tp: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (dp, tp) mesh over `devices` (default: every visible card; with
    none, an error). The JAX package's defaults: all slots on tp.

    In a distributed run (`initialize_distributed` returned True), every
    process calls this together with ITS OWN slots, and the mesh spans
    all processes' slots in rank order."""
    local = [torch.device(d) for d in
             (devices if devices is not None else _default_local_devices())]
    rank = 0
    if dist.is_initialized() and dist.get_world_size() > 1:
        rank = dist.get_rank()
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, [str(d) for d in local])
        slots = [(r, torch.device(d)) for r, ds in enumerate(gathered)
                 for d in ds]
    else:
        slots = [(0, d) for d in local]
    n = len(slots)
    if dp is None and tp is None:
        dp, tp = 1, n
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    if dp * tp != n:
        raise ValueError(f"dp({dp})*tp({tp}) != slots({n})")
    devs = np.empty(n, dtype=object)
    devs[:] = [d for _, d in slots]
    ranks = np.array([r for r, _ in slots], np.int64)
    return Mesh(devices=devs.reshape(dp, tp), ranks=ranks.reshape(dp, tp),
                rank=rank)


@dataclasses.dataclass(frozen=True, eq=False)
class Placed:
    """A tensor placed on a mesh slot by slot: `parts[(i, j)]` is this
    process's slot (i, j)'s piece, its tp shard of the leading axis or
    the whole tensor when replicated. Slots that share a device share one
    tensor."""

    mesh: Mesh
    parts: dict
    sharded: bool
    shape: tuple

    @property
    def is_fully_replicated(self) -> bool:
        return not self.sharded


def _place(mesh: Mesh, x: torch.Tensor, sharded: bool) -> Placed:
    tp = mesh.shape["tp"]
    if sharded and x.shape[0] % tp:
        raise ValueError(f"leading axis {x.shape[0]} does not divide over "
                         f"tp={tp}: pad with invalid rows first")
    m = x.shape[0] // tp if sharded else x.shape[0]
    parts, cache = {}, {}
    for i, j in np.ndindex(*mesh.devices.shape):
        if not mesh.is_local(i, j):
            continue
        key = (j if sharded else 0, str(mesh.devices[i, j]))
        if key not in cache:
            piece = x[j * m:(j + 1) * m] if sharded else x
            cache[key] = piece.to(mesh.devices[i, j]).contiguous()
        parts[(i, j)] = cache[key]
    return Placed(mesh=mesh, parts=parts, sharded=sharded,
                  shape=tuple(x.shape))


def shard_db(mesh: Mesh, db_leaves):
    """Place DB tensors (one or a tuple) sharded over tp along their
    leading (M) axis, replicated over dp."""
    if isinstance(db_leaves, torch.Tensor):
        return _place(mesh, db_leaves, True)
    return tuple(_place(mesh, x, True) for x in db_leaves)


def replicate(mesh: Mesh, leaves):
    """Place tensors (one or a tuple) whole on every slot."""
    if isinstance(leaves, torch.Tensor):
        return _place(mesh, leaves, False)
    return tuple(_place(mesh, x, False) for x in leaves)


# ---- replicating outputs across processes ----------------------------------

_DTYPES = (torch.float32, torch.int32, torch.int64, torch.uint8, torch.bool)


def broadcast_tensors(tensors, src: int, n: int, device) -> list:
    """`n` tensors from process `src` to every process (their shapes and
    dtypes too: receivers pass tensors=None). bool goes as uint8."""
    hdr = torch.zeros((n, 6), dtype=torch.int64, device=device)
    if dist.get_rank() == src:
        for k, t in enumerate(tensors):
            if t.dim() > 4:
                raise ValueError(f"broadcast_tensors: {t.dim()}-d tensor")
            hdr[k, 0] = _DTYPES.index(t.dtype)
            hdr[k, 1] = t.dim()
            hdr[k, 2:2 + t.dim()] = torch.tensor(t.shape)
    dist.broadcast(hdr, src)
    out = []
    for k, row in enumerate(hdr.tolist()):
        dtype = _DTYPES[row[0]]
        wire = torch.uint8 if dtype == torch.bool else dtype
        shape = tuple(row[2:2 + row[1]])
        if dist.get_rank() == src:
            buf = tensors[k].to(device=device, dtype=wire).contiguous()
        else:
            buf = torch.empty(shape, dtype=wire, device=device)
        dist.broadcast(buf, src)
        out.append(buf.to(dtype))
    return out
