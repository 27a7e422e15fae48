"""Kernel A: one FED nonlinear-diffusion cycle (csrc/fed_cycle.cu), with
its plain PyTorch twin and its launch plan.

A cycle runs n explicit steps L ← L + τₖ/2 · Σ₄ (g_p+g_q)(L_q−L_p) with
the conductance g fixed and a Neumann (edge-clamped) boundary. The
plain twin does each step as whole-image tensor ops (2·n device-memory
transits of L); the kernel runs all n steps in one launch on output
tiles staged with a halo of n cells (2 transits). A batch of images of
one shape takes one launch, its images along the grid's z. `fed_plan`
picks the launch: plain tiles, one CTA each, where the batch's tile grid
fills the card, and otherwise tiles shared by a thread-block cluster of
up to 16 CTAs that each hold a strip of the tile's rows, so the small
levels run on many SMs.

`fed_cycle_fused` dispatches on the device of its input: CPU tensors go
to the twin, CUDA tensors to the kernel, anything else raises. The
kernel counts its own launches on the device, eager or replayed from a
CUDA graph (`device_launches`).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from cubesat_apds_tpu_torch.ops.kernels import build

MAX_STEPS = 128                     # FED_MAX_STEPS in fed_cycle.cu
MAX_THREADS = 512                   # FED_MAX_THREADS in fed_cycle.cu
CELLS_PER_THREAD = (1, 2, 4, 8, 16)  # the kernel's instantiations
CLUSTER_SIZES = (2, 4, 8, 16)       # 16 is past the portable 8: allowed
                                    # by a function attribute on Hopper
SMEM_LIMIT = 227 * 1024             # dynamic shared memory per block, H100
NUM_SMS = 132                       # H100 SXM


def _shift(x, dy: int, dx: int):
    """Edge-clamped shift of [..., H, W]: out[i, j] = x[clamp(i+dy), clamp(j+dx)]."""
    if dy == 1:
        return torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)
    if dy == -1:
        return torch.cat([x[..., :1, :], x[..., :-1, :]], dim=-2)
    if dx == 1:
        return torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    return torch.cat([x[..., :1], x[..., :-1]], dim=-1)


def nld_step(L, g, tau: float):
    """One explicit step L ← L + τ/2 · Σ₄ (g + g_q)(L_q − L), in the JAX
    package's term order (right, left, down, up)."""
    contrib = (
        (g + _shift(g, 0, 1)) * (_shift(L, 0, 1) - L)
        + (g + _shift(g, 0, -1)) * (_shift(L, 0, -1) - L)
        + (g + _shift(g, 1, 0)) * (_shift(L, 1, 0) - L)
        + (g + _shift(g, -1, 0)) * (_shift(L, -1, 0) - L)
    )
    return L + (0.5 * float(tau)) * contrib


def fed_cycle(L, g, taus):
    """Plain twin of kernel A: a full FED cycle, one step at a time, on
    [..., H, W] (every leading index an image of its own)."""
    for tau in np.asarray(taus, np.float32):
        L = nld_step(L, g, tau)
    return L


@dataclasses.dataclass(frozen=True)
class FedPlan:
    """One launch of kernel A: output tiles of tile_h × tile_w, each
    staged with a halo of n cells (clipped to the image) and split by rows
    over a cluster of `cluster` CTAs (1: plain tiles), for each of `batch`
    images."""

    form: str               # "tiles" (cluster 1) or "cluster"
    cluster: int
    tile_h: int
    tile_w: int
    tiles: int              # output tiles of one image, one cluster each
    ctas: int               # CTAs of the launch: tiles · cluster · batch
    strip_rows: int         # staged rows per CTA of the largest tile
    cells: int              # staged cells per CTA of the largest tile
    threads: int
    cells_per_thread: int
    smem: int               # dynamic shared memory per CTA, bytes
    batch: int = 1


def _layout(h: int, w: int, n: int, tile_h: int, tile_w: int,
            cluster: int, batch: int):
    """The plan for one tiling, or None where a CTA's columns do not fit
    its threads or its buffers its shared memory, or where the largest
    tile leaves a CTA of the cluster without rows."""
    rows, cols = min(h, tile_h + 2 * n), min(w, tile_w + 2 * n)
    strip = -(-rows // cluster)
    if (cluster - 1) * strip >= rows:
        return None
    # A thread owns up to cpt cells of one column of its CTA's strip.
    cpt = next((c for c in CELLS_PER_THREAD
                if cols * -(-strip // c) <= MAX_THREADS), None)
    # L ping-pong buffers; in a cluster each has a ghost row above and
    # below the strip, written by the neighbour CTAs, and an mbarrier.
    smem = 2 * 4 * strip * cols
    if cluster > 1:
        smem += 2 * 4 * 2 * cols + 16
    if cpt is None or smem > SMEM_LIMIT:
        return None
    tiles = -(-h // tile_h) * -(-w // tile_w)
    return FedPlan(form="tiles" if cluster == 1 else "cluster",
                   cluster=cluster, tile_h=tile_h, tile_w=tile_w,
                   tiles=tiles, ctas=tiles * cluster * batch,
                   strip_rows=strip, cells=strip * cols,
                   threads=32 * -(-(cols * -(-strip // cpt)) // 32),
                   cells_per_thread=cpt, smem=smem, batch=batch)


def _tile_sizes(extent: int):
    return [extent] + [1 << k for k in range(3, 13) if 1 << k < extent]


@functools.lru_cache(maxsize=256)
def fed_plan(h: int, w: int, n_steps: int, form: str | None = None,
             cluster: int | None = None, batch: int = 1) -> FedPlan:
    """Kernel A's launch for `batch` [h, w] images and n_steps steps.

    Plain tiles (T×T outputs, T = 32 for short cycles and 64 for long
    ones, shrunk until a CTA's staged columns fit) where the batch's grid
    has at least one CTA per SM. Otherwise a cluster: of the tilings and
    cluster sizes whose CTAs (all images') fit the card in one wave, the
    one with the fewest cells per thread, then the fewest staged cells,
    then the largest cluster. `form` and `cluster` force a choice (to
    compare forms). Raises where nothing fits.
    """
    tiles = None
    t = 32 if n_steps <= 8 else 64
    while tiles is None and t >= 8:
        tiles = _layout(h, w, n_steps, min(h, t), min(w, t), 1, batch)
        t //= 2
    if form == "tiles" or (form is None and tiles is not None
                           and tiles.ctas >= NUM_SMS):
        if tiles is None:
            raise ValueError(f"FED cycle of {n_steps} steps on {h}×{w}: "
                             "no tile fits a CTA")
        return tiles
    sizes = CLUSTER_SIZES if cluster is None else (cluster,)
    plans = [p for c in sizes for th in _tile_sizes(h) for tw in _tile_sizes(w)
             if (p := _layout(h, w, n_steps, th, tw, c, batch)) is not None]
    if not plans:
        if tiles is not None and form is None:
            return tiles
        raise ValueError(f"FED cycle of {n_steps} steps on {h}×{w}: no "
                         f"tiling fits a cluster of {sizes} CTAs")
    plans = [p for p in plans if p.ctas <= NUM_SMS] or plans
    return min(plans, key=lambda p: (p.cells_per_thread, p.ctas * p.cells,
                                     -p.cluster))


@functools.lru_cache(maxsize=64)
def _half_taus(taus: bytes):
    """0.5·τ as a float32 host array and its address, made once per τ
    schedule (the main path has 15): the kernel's parameters are copied
    from it at each launch."""
    half = 0.5 * np.frombuffer(taus, np.float32)
    return half, half.ctypes.data


def fed_cycle_cuda(L, g, taus, plan: FedPlan | None = None):
    """Kernel A on CUDA tensors L, g [H, W] or [B, H, W] float32
    (contiguous): one launch for the whole batch, with `fed_plan`'s launch
    unless `plan` names another (for the same batch)."""
    if L.device.type != "cuda" or g.device != L.device:
        raise ValueError(f"fed_cycle_cuda: L on {L.device}, g on {g.device}; "
                         "both must be on one CUDA device")
    if L.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"fed_cycle_cuda: float32 required, got "
                        f"{L.dtype}, {g.dtype}")
    if L.dim() not in (2, 3) or L.shape != g.shape or L.numel() == 0:
        raise ValueError(f"fed_cycle_cuda: L {tuple(L.shape)} and g "
                         f"{tuple(g.shape)} must be one non-empty [H, W] "
                         "or [B, H, W] shape")
    if not (L.is_contiguous() and g.is_contiguous()):
        raise ValueError("fed_cycle_cuda: L and g must be contiguous")
    taus = np.asarray(taus, np.float32)
    n = taus.shape[0] if taus.ndim == 1 else 0
    if not 1 <= n <= MAX_STEPS:
        raise ValueError(f"fed_cycle_cuda: 1..{MAX_STEPS} steps, got "
                         f"{taus.shape}")
    _, half_taus = _half_taus(taus.tobytes())
    h, w = L.shape[-2:]
    b = L.shape[0] if L.dim() == 3 else 1
    p = plan or fed_plan(h, w, n, batch=b)
    if p.batch != b:
        raise ValueError(f"fed_cycle_cuda: a plan for {p.batch} images given "
                         f"{b}")
    out = torch.empty_like(L)
    lib = build.load_kernels().lib
    counter = build.launch_counter("fed_cycle", L.device)
    with build.on_device(L.device):
        err = lib.apds_fed_cycle(
            L.data_ptr(), g.data_ptr(), out.data_ptr(), b, h, w, p.tile_h,
            p.tile_w, p.cluster, p.threads, p.cells_per_thread,
            half_taus, n, p.smem, build.ptr(counter), build.stream_of(L))
    build.check_launch("apds_fed_cycle", err)
    return out


def device_launches(dev) -> int:
    """Kernel A's launches on `dev` so far, as the device counted them
    (eager or replayed from a CUDA graph); a synchronising call."""
    return build.device_launches("fed_cycle", dev)


def plan_info(plan: FedPlan) -> dict:
    """A plan's launch shape as compiled for this card: the most clusters
    it holds at once (cudaOccupancyMaxActiveClusters), and the kernel's
    registers and spill bytes per thread."""
    info = np.zeros(3, np.int32)
    build.check_launch("apds_fed_cycle_info", build.load_kernels().lib
                       .apds_fed_cycle_info(plan.cluster, plan.threads,
                                            plan.cells_per_thread, plan.smem,
                                            info.ctypes.data))
    return {"max_active_clusters": int(info[0]), "registers": int(info[1]),
            "spill_bytes": int(info[2])}


def fed_cycle_fused(L, g, taus, batched: bool = False):
    """FED cycle on L's device: the kernel for CUDA tensors, the plain
    twin for CPU tensors. `batched` is accepted and ignored: on the TPU
    it halves the VMEM budget of the strip plan under vmap, and kernel A
    plans its tiles from the shape alone."""
    if L.device.type == "cuda":
        return fed_cycle_cuda(L.contiguous(), g.contiguous(), taus)
    if L.device.type == "cpu":
        return fed_cycle(L, g, taus)
    raise ValueError(f"fed_cycle_fused: unsupported device {L.device}")
