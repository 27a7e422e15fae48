"""The port's CUDA kernel wrappers: launch plans and input checks on the
CPU, and each kernel against its plain twin on the card (`cuda`-marked,
skipped without a GPU).

This file imports torch and the port only, so it also runs on a GPU host
without jax (which tests/conftest.py imports):

    python -m pytest --noconftest tests/test_torch_kernels.py -q
"""

import itertools
import math

import numpy as np
import pytest
import torch

from cubesat_apds_tpu_torch.core.config import AkazeConfig
from cubesat_apds_tpu_torch.ops.features import scale_space as tss
from cubesat_apds_tpu_torch.ops import match as tmatch
from cubesat_apds_tpu_torch.ops.kernels import diffusion as tdiff
from cubesat_apds_tpu_torch.ops.kernels import match_kernel as tmk
from cubesat_apds_tpu_torch.ops.kernels import sample_kernel as tsk


def _main_path_levels():
    """(h, w, τ schedule) of each FED level 1–15 of the main path's 512²
    frame with the default AkazeConfig."""
    cfg = AkazeConfig()
    meta = tss.evolution_metadata(cfg)
    return [(512 >> meta[i].octave, 512 >> meta[i].octave,
             tss.fed_tau_by_process_time(meta[i].etime - meta[i - 1].etime,
                                         cfg.fed_tau_max))
            for i in range(1, len(meta))]


_LEVELS = _main_path_levels()


@pytest.mark.parametrize("h,w,n", [(512, 512, 3), (256, 256, 7),
                                   (128, 128, 14), (64, 64, 29),
                                   (1024, 1024, 9), (72, 128, 6)]
                         + [(h, w, len(t)) for h, w, t in _LEVELS]
                         + [(37, 53, 5)])
def test_fed_tile_plan_fits_and_covers(h, w, n):
    """Kernel A's launch plan at every main-path level (plus the strip
    kernel's 1024² domain and ragged cases): a CTA's ping-pong buffers fit
    an H100 block's shared memory and its cells its threads, the tiles
    cover the image and the strips each tile's staged rows, the cluster
    is at most 16 (past the portable 8 only by the kernel's attribute),
    and the small levels (64², 128², 256²) run as clusters."""
    p = tdiff.fed_plan(h, w, n)
    rows, cols = min(h, p.tile_h + 2 * n), min(w, p.tile_w + 2 * n)
    # in a cluster: two ghost rows (the neighbours' edge rows) per buffer
    # and two 8-byte mbarriers
    extra = 8 * 2 * cols + 16 if p.cluster > 1 else 0
    assert p.smem <= tdiff.SMEM_LIMIT
    assert p.smem == 8 * p.strip_rows * cols + extra
    assert p.cells == p.strip_rows * cols
    # a thread owns up to cells_per_thread cells of one column
    assert cols * math.ceil(p.strip_rows / p.cells_per_thread) <= p.threads
    assert p.threads % 32 == 0 and p.threads <= tdiff.MAX_THREADS
    assert p.cells_per_thread in tdiff.CELLS_PER_THREAD
    assert p.tiles == math.ceil(h / p.tile_h) * math.ceil(w / p.tile_w)
    assert p.ctas == p.tiles * p.cluster
    assert p.cluster * p.strip_rows >= rows
    assert (p.cluster - 1) * p.strip_rows < rows     # no CTA left empty
    assert p.cluster in (1, 2, 4, 8, 16)
    assert (p.form == "tiles") == (p.cluster == 1)
    if h <= 256 and w <= 256:
        assert p.form == "cluster"
    if h == w == 512 and n <= 4 or h == w == 1024:
        assert p.form == "tiles" and p.ctas >= tdiff.NUM_SMS
    else:
        assert p.ctas <= tdiff.NUM_SMS                # one wave


def test_fed_plan_covers_every_shape_the_halo_tiles_did():
    """Every (h, w, n) for which the earlier plain halo-tile plan found a
    tile (8×8 outputs at least, L, L and g staged: 12 B a cell in 227 KB)
    still gets a plan whose CTAs fit, up to n = 65, where that plan ended
    at large sizes."""
    sizes = (1, 3, 37, 64, 72, 128, 333, 1024, 4000)
    for h, w, n in itertools.product(sizes, sizes, (1, 3, 9, 29, 50, 65)):
        if 12 * min(h, 8 + 2 * n) * min(w, 8 + 2 * n) > tdiff.SMEM_LIMIT:
            continue
        p = tdiff.fed_plan(h, w, n)
        rows, cols = min(h, p.tile_h + 2 * n), min(w, p.tile_w + 2 * n)
        assert p.cluster * p.strip_rows >= rows
        assert cols * math.ceil(p.strip_rows / p.cells_per_thread) <= p.threads
        assert p.threads <= tdiff.MAX_THREADS and p.smem <= tdiff.SMEM_LIMIT


@pytest.mark.parametrize("batch", [1, 8, 16])
@pytest.mark.parametrize("level", range(1, 16))
def test_fed_plan_counts_the_batch(level, batch):
    """Kernel A's plan for a batch of B images at each main-path level: a
    CTA's buffers fit its shared memory and its cells its threads, the
    tiles cover an image and the strips a tile, the CTAs count every
    image, and the form follows the plan's rule over the batch's CTAs:
    plain tiles where they fill the card, else a cluster plan that fits
    it in one wave."""
    h, w, taus = _LEVELS[level - 1]
    n = len(taus)
    p = tdiff.fed_plan(h, w, n, batch=batch)
    rows, cols = min(h, p.tile_h + 2 * n), min(w, p.tile_w + 2 * n)
    extra = 8 * 2 * cols + 16 if p.cluster > 1 else 0
    assert p.batch == batch
    assert p.smem == 8 * p.strip_rows * cols + extra <= tdiff.SMEM_LIMIT
    assert cols * math.ceil(p.strip_rows / p.cells_per_thread) <= p.threads
    assert p.threads % 32 == 0 and p.threads <= tdiff.MAX_THREADS
    assert p.tiles == math.ceil(h / p.tile_h) * math.ceil(w / p.tile_w)
    assert p.cluster * p.strip_rows >= rows
    assert (p.cluster - 1) * p.strip_rows < rows
    assert p.ctas == p.tiles * p.cluster * batch
    if p.form == "tiles":
        assert p.ctas >= tdiff.NUM_SMS
    else:
        assert p.ctas <= tdiff.NUM_SMS
        tiles = tdiff.fed_plan(h, w, n, form="tiles", batch=batch)
        assert tiles.ctas < tdiff.NUM_SMS
    one = tdiff.fed_plan(h, w, n)
    if one.form == "tiles":              # more images never leave tiles
        assert p.form == "tiles" and p.tile_h == one.tile_h


def test_kernel_wrappers_refuse_cpu_tensors():
    """On a non-CUDA tensor the kernel entry points raise instead of
    running anything else."""
    x = torch.zeros(8, 8)
    with pytest.raises(ValueError):
        tdiff.fed_cycle_cuda(x, x, np.ones(2, np.float32))
    stack = torch.zeros(1, 8, 8, 4, dtype=torch.bfloat16)
    i = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        tsk.sample_patches_cuda(stack, torch.zeros(1, 2, dtype=torch.int32),
                                i, i[:, None], i[:, None])


@pytest.mark.parametrize("q,m", [(2048, 1 << 20), (2048, 1_000_003),
                                 (100, 3000), (5000, 300), (1, 0), (1, 1),
                                 (1, 1_500_000_000)])
def test_knn_split_plan_covers_the_db(q, m):
    """Kernel 4's launch plan: chunks are whole shared-memory tiles, cover
    the DB with no empty chunk, fit the grid's y limit, and give the H100's
    132 SMs several blocks each wherever the DB has the tiles for it
    (chunks stay within the kernel's 2^20-row index field); a block's
    double-buffered tiles fit its shared memory."""
    assert tmk.SMEM_BYTES == tmk.STAGES * tmk.ROWS_PER_TILE * (512 + 4) + 40
    assert tmk.SMEM_BYTES <= tmk.SMEM_LIMIT
    nqb, n_split, chunk = tmk.split_plan(q, m, 132)
    assert nqb == -(-q // tmk.QUERIES_PER_BLOCK)
    assert chunk % tmk.ROWS_PER_TILE == 0 and n_split * chunk >= m
    assert (n_split - 1) * chunk < max(m, 1) and 1 <= n_split <= 65535
    assert chunk <= tmk.MAX_CHUNK_ROWS
    n_tiles = -(-m // tmk.ROWS_PER_TILE)
    assert nqb * n_split >= min(132 * tmk.BLOCKS_PER_SM, nqb * n_tiles)


def test_knn_wrappers_refuse_other_devices():
    """Kernel 4's entry point raises on CPU tensors, and the dispatch
    raises on a device that is neither CPU nor CUDA."""
    w = torch.zeros(4, 16, dtype=torch.int32)
    with pytest.raises(ValueError):
        tmk.knn2_hamming_cuda(w, w, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        tmk.knn2_fused(w.to("meta"), w.to("meta"))


def test_sampler_twin_clamps_levels_into_the_stack():
    """The plain twin clamps out-of-range levels and samples into the stack,
    the semantics kernel B implements: a level past either end reads as
    the nearest level, a sample past the level's edge as the edge pixel."""
    rng = np.random.default_rng(3)
    stack = torch.from_numpy(
        rng.standard_normal((3, 8, 8, 4)).astype(np.float32)).to(torch.bfloat16)
    level_hw = torch.tensor([[8, 8], [4, 4], [2, 2]], dtype=torch.int32)
    lvl = torch.tensor([-2, 1, 7])
    iy = torch.tensor([[0, 9, -3], [1, 3, 5], [0, 1, 2]])
    ix = torch.tensor([[0, 2, 11], [-1, 3, 4], [2, 1, 0]])
    got = tsk.sample_patches_plain(stack, level_hw, lvl, iy, ix)
    want = torch.stack([
        stack[0, [0, 7, 0], [0, 2, 7]],
        stack[1, [1, 3, 3], [0, 3, 3]],
        stack[2, [0, 1, 1], [1, 1, 0]]]).float()
    assert torch.equal(got, want)


# --- the CUDA kernels (on the card only) ----------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,level", [(512, 512, 0.5), (64, 64, 60.0),
                                       (72, 128, 3.0), (64, 64, 15),
                                       (128, 128, 11), (256, 256, 7),
                                       (101, 77, 6.0), (1, 1, 1.0)])
def test_fed_kernel_matches_twin_on_card(cuda_device, h, w, level):
    """Kernel A vs its plain twin on the card, bit for bit (the kernel
    forbids FMA contraction and keeps the twin's term order): the main
    path's longest cycles at 64² (level 15, n=29), 128² (level 11, n=14)
    and 256² (level 7, n=7) with their real τ schedules; a 101×77 image
    whose rows no cluster size divides; a single pixel; and diffusion
    times (floats) through fed_tau_by_process_time at 512², 64² and
    72×128."""
    rng = np.random.default_rng(0)
    L = torch.from_numpy(rng.uniform(0, 1, (h, w)).astype(np.float32))
    g = torch.from_numpy(rng.uniform(0.2, 1, (h, w)).astype(np.float32))
    if isinstance(level, int):
        assert _LEVELS[level - 1][:2] == (h, w)
        taus = _LEVELS[level - 1][2]
    else:
        taus = tss.fed_tau_by_process_time(level)
    ref = tdiff.fed_cycle(L.to(cuda_device), g.to(cuda_device), taus)
    got = tdiff.fed_cycle_cuda(L.to(cuda_device), g.to(cuda_device), taus)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [3, 8])
@pytest.mark.parametrize("h,w,level", [(64, 64, 15), (128, 128, 11),
                                       (256, 256, 7), (101, 77, 6.0)])
def test_batched_fed_kernel_matches_twin_on_card(cuda_device, batch, h, w,
                                                 level):
    """Kernel A on a batch of B images in one launch vs the twin on each
    image alone, bit for bit: the main path's longest cycles at 64², 128²
    and 256² (where a batch moves the plan to other forms) and a ragged
    101×77."""
    rng = np.random.default_rng(1)
    L = torch.from_numpy(rng.uniform(0, 1, (batch, h, w)).astype(np.float32))
    g = torch.from_numpy(rng.uniform(0.2, 1, (batch, h, w)).astype(
        np.float32))
    taus = (_LEVELS[level - 1][2] if isinstance(level, int)
            else tss.fed_tau_by_process_time(level))
    L, g = L.to(cuda_device), g.to(cuda_device)
    before = tdiff.fed_cycle_cuda.launches
    got = tdiff.fed_cycle_cuda(L, g, taus)
    assert tdiff.fed_cycle_cuda.launches == before + 1
    torch.cuda.synchronize()
    for b in range(batch):
        assert torch.equal(got[b], tdiff.fed_cycle(L[b], g[b], taus)), b


@pytest.mark.cuda
def test_batched_sample_kernel_matches_twin_on_card(cuda_device):
    """Kernel B on a batch of 8 stacks folded into its stack axis (one
    launch) vs the twin on each stack alone, bit for bit."""
    rng = np.random.default_rng(2)
    B, L, H, W, K, S = 8, 4, 96, 80, 64, 441
    stacks = torch.from_numpy(rng.standard_normal((B, L, H, W, 4)).astype(
        np.float32)).to(torch.bfloat16).to(cuda_device)
    hw = torch.tensor([[96, 80], [48, 40], [96, 80], [24, 20]],
                      dtype=torch.int32, device=cuda_device)
    lvl = torch.from_numpy(rng.integers(0, L, (B, K))).to(cuda_device)
    iy = torch.from_numpy(rng.integers(-40, 100, (B * K, S))).to(cuda_device)
    ix = torch.from_numpy(rng.integers(-40, 100, (B * K, S))).to(cuda_device)
    before = tsk.sample_patches_cuda.launches
    got = tsk.patch_sampler(stacks, hw, lvl)(iy, ix)
    assert tsk.sample_patches_cuda.launches == before + 1
    torch.cuda.synchronize()
    for b in range(B):
        ref = tsk.sample_patches_plain(stacks[b], hw, lvl[b],
                                       iy[b * K:(b + 1) * K],
                                       ix[b * K:(b + 1) * K])
        assert torch.equal(got[b * K:(b + 1) * K], ref), b


@pytest.mark.cuda
def test_sample_kernel_matches_twin_on_card(cuda_device):
    """Kernel B vs its plain twin on the card: bit-exact, with samples up
    to ±40 px from the keypoint (past the ±29 px of the AKAZE patterns)
    and out-of-range levels (both clamp them into the stack)."""
    rng = np.random.default_rng(0)
    L, H, W, K, S = 4, 96, 80, 64, 441
    arr = rng.standard_normal((L, H, W, 4)).astype(np.float32)
    hw = np.array([[96, 80], [48, 40], [96, 80], [24, 20]], np.int32)
    lvl = rng.integers(0, L, K).astype(np.int32)
    cx = np.array([rng.integers(0, w) for w in hw[lvl, 1]], np.int32)
    cy = np.array([rng.integers(0, h) for h in hw[lvl, 0]], np.int32)
    lvl[:3] = [-1, L, L + 5]
    iy = (cy[:, None] + rng.integers(-40, 41, (K, S))).astype(np.int32)
    ix = (cx[:, None] + rng.integers(-40, 41, (K, S))).astype(np.int32)
    t = [torch.from_numpy(a).to(cuda_device) for a in (hw, lvl, iy, ix)]
    stack = torch.from_numpy(arr).to(torch.bfloat16).to(cuda_device)
    got = tsk.sample_patches_cuda(stack, *t)
    ref = tsk.sample_patches_plain(stack, t[0], t[1].long(), t[2], t[3])
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_knn2_kernel_matches_twin_on_card(cuda_device):
    """Kernel 4 vs its plain twin on the card, bit-exact on d0, d1 and i0:
    a ragged DB with ~5% invalid rows, rows duplicated across the
    kernel's chunk edges and the twin's block edges (ties: the lowest
    index wins, the duplicate stays second-best), query blocks that are
    only partly filled, and DBs shorter than one shared-memory tile or
    one row past it."""
    rng = np.random.default_rng(4)
    q_n, m, block = 300, 200_003, 65536
    db = rng.integers(0, 256, (m, 61), dtype=np.uint8)
    q = rng.integers(0, 256, (q_n, 61), dtype=np.uint8)
    valid = rng.random(m) > 0.05
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    _, _, chunk = tmk.split_plan(q_n, m, sms)
    for j, edge in enumerate([chunk, 2 * chunk, block, m - 1]):
        db[[edge - 1, edge]] = q[j]
        valid[[edge - 1, edge]] = True
    valid[chunk + 5] = False
    db[chunk + 5] = q[4]                 # an exact hit that is invalid
    t = {k: torch.from_numpy(a).to(cuda_device)
         for k, a in (("q", q), ("db", db), ("valid", valid))}
    layout = tmk.layout_db_blocks(tmk.pack_words(t["db"]), t["valid"])
    got = tmk.knn2_hamming_cuda(tmk.pack_words(t["q"]), *layout)
    ref = tmatch.knn2_blockwise(tmatch.unpack_bits(t["q"]), t["db"], block,
                                t["valid"])
    torch.cuda.synchronize()
    for name, g, r in zip(("d0", "d1", "i0"), got, ref):
        assert torch.equal(g, r), name
    i0 = got[2].cpu().numpy()
    assert list(i0[:4]) == [chunk - 1, 2 * chunk - 1, block - 1, m - 2]

    for q_n, m in ((300, 5), (7, tmk.ROWS_PER_TILE + 1)):
        db = torch.from_numpy(rng.integers(0, 256, (m, 61), dtype=np.uint8))
        q = torch.from_numpy(rng.integers(0, 256, (q_n, 61), dtype=np.uint8))
        q[1] = db[m - 1]                     # an exact hit on the last row
        db, q = db.to(cuda_device), q.to(cuda_device)
        got = tmk.knn2_hamming_cuda(tmk.pack_words(q),
                                    *tmk.layout_db_blocks(tmk.pack_words(db)))
        ref = tmatch.knn2_blockwise(tmatch.unpack_bits(q), db, block)
        torch.cuda.synchronize()
        for name, g, r in zip(("d0", "d1", "i0"), got, ref):
            assert torch.equal(g, r), (q_n, m, name)
        assert int(got[2][1]) == m - 1 and float(got[0][1]) == 0.0
