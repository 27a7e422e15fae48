"""The serving step's front half as one CUDA graph a key
(ops/features/akaze.py:detect_and_compute_batch through
core/step_graph.py): the port's counterpart of the JAX package's jit of
`detect_and_compute_batch`.

On the CPU: the graph key (what the capture fixes: the images' and
`kcontrast`'s shapes, dtypes and devices, the configuration, the
capacity, the stream; new images of the same shapes keep the key), no
graph made and the same bits as the eager front end plus the ladder, the
slice through the dispatch against the JAX package's
`detect_and_compute_batch`, and the back half's public names, which now
use the shared machinery. On the card (`cuda`-marked, skipped without a
GPU): the graphed front half equal to the eager `_front_end` bit for bit
at 512² B = 1 and 3, 8 × 256² and 1024², in the exact, fast and hybrid
modes; a second batch through the same graph; a held result unchanged
by the next call; kernel A's 15 device-counted launches a replay; a
warmed host-frame call under set_sync_debug_mode("error"); the graph's
pool within 1.5x the eager front end's peak plus 64 MiB.

Only the JAX comparison imports jax, so the rest also runs on a GPU host
without it:

    python -m pytest --noconftest tests/test_torch_front_graph.py -q
"""

import numpy as np
import pytest
import torch

from cubesat_apds_tpu_torch.core import step_graph as core_graph
from cubesat_apds_tpu_torch.core.config import AkazeConfig
from cubesat_apds_tpu_torch.core.types import upload
from cubesat_apds_tpu_torch.ops.features import akaze as takaze
from cubesat_apds_tpu_torch.pipelines import step_graph

torch.set_num_threads(2)

CAP = 256
CFG = AkazeConfig(capacity=CAP)
MODES = {"exact": {},
         "fast": dict(descriptor_mode="fast", orientation_mode="fast"),
         "hybrid": dict(descriptor_mode="hybrid")}
KP_FIELDS = ("xy", "size", "angle", "response", "octave", "class_id",
             "valid")


def _frame(seed, n):
    """tests/test_torch_features.py's corner-rich frame, at n×n."""
    rng = np.random.default_rng(seed)
    img = np.zeros((n, n), np.float32)
    for _ in range(120 * n * n // (512 * 512) + 30):
        cy, cx = rng.integers(4, n - 20, 2)
        s = int(rng.integers(4, 20))
        img[cy:cy + s, cx:cx + s] = rng.uniform(0.2, 1.0)
    return img


def _frames(seeds, n):
    return torch.from_numpy(np.stack([_frame(s, n) for s in seeds]))


# ---- the key ----------------------------------------------------------------

def _key(b=2, n=128, config=CFG, capacity=CAP, kcontrast=None,
         device="cpu", stream=7):
    imgs = torch.empty((b, n, n), dtype=torch.float32, device=device)
    return core_graph.step_key(takaze._front_end,
                               (imgs, config, capacity, kcontrast), stream)


@pytest.mark.parametrize("change", [
    dict(b=3), dict(n=96), dict(capacity=512),
    dict(config=AkazeConfig(capacity=CAP, descriptor_mode="fast")),
    dict(config=AkazeConfig(capacity=CAP, adaptive_buckets=1)),
    dict(kcontrast=torch.zeros(())), dict(device="meta"), dict(stream=8)])
def test_front_key_separates_what_the_capture_fixes(change):
    """New images of the same shapes keep the key, as a jitted function
    keeps its executable; the batch, the frame size, the capacity, the
    descriptor mode, the ladder, `kcontrast` given or absent, the device
    and the stream each give another key."""
    assert _key() == _key()
    imgs = _frames((7, 3), 128)
    assert core_graph.step_key(takaze._front_end,
                               (imgs, CFG, CAP, None), 7) == _key()
    assert _key(**change) != _key()


def test_front_key_holds_kcontrast_shape():
    """A contrast factor for the batch and one per image are two keys; two
    values of one shape are one."""
    assert _key(kcontrast=torch.zeros(())) == _key(kcontrast=torch.ones(()))
    assert _key(kcontrast=torch.zeros(())) != _key(kcontrast=torch.zeros(2))


# ---- no graph on the CPU ----------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def no_cached_graphs():
    """Drop the graphs that earlier test files of this process left in
    the four process-wide caches (front half, ladder, back half, mesh),
    so that this file's tests see only the graphs they make."""
    from cubesat_apds_tpu_torch.ops.features import ladder
    from cubesat_apds_tpu_torch.parallel import mesh

    takaze.clear_front_graphs()
    ladder.clear_ladder_graphs()
    step_graph.clear_step_graphs()
    mesh.clear_mesh_graphs()


@pytest.fixture(scope="module")
def imgs():
    return _frames((7, 3), 128)


@pytest.fixture(scope="module")
def feats(imgs):
    return takaze.detect_and_compute_batch(imgs, CFG, CAP)


def test_cpu_makes_no_graph_and_equals_the_eager_front_end(imgs, feats):
    """On the CPU the dispatch calls `_front_end` itself: no graph is
    made, and the features equal `_front_end` plus the ladder called
    directly, bit for bit."""
    assert takaze.front_graphs() == []
    assert takaze.clear_front_graphs() == 0
    kps, packed, level_hw, grids = takaze._front_end(imgs, CFG, CAP, None)
    angle, desc = takaze.adaptive_orient_describe(kps, packed, level_hw,
                                                  CFG, grids)
    for k in KP_FIELDS:
        want = angle if k == "angle" else getattr(kps, k)
        assert torch.equal(getattr(feats.keypoints, k), want), k
    assert torch.equal(feats.descriptors, desc)
    assert int(feats.keypoints.valid.sum(-1).min()) > 20


def test_kcontrast_number_equals_tensor(imgs):
    """A contrast factor given as a number goes up as a float32 tensor
    before the dispatch: the same bits as the tensor."""
    a = takaze.detect_and_compute_batch(imgs, CFG, CAP, kcontrast=0.05)
    b = takaze.detect_and_compute_batch(imgs, CFG, CAP,
                                        kcontrast=torch.tensor(0.05))
    for x, y in zip(step_graph.leaves(a), step_graph.leaves(b)):
        assert torch.equal(x, y)


def test_front_dispatch_matches_jax(imgs, feats):
    """The slice through the dispatch against the JAX package's
    detect_and_compute_batch (exact top-K) on the same batch of 2 at
    128²: keypoint counts and descriptors bit-exact, keypoints at the
    same slots within 1e-3 px on the same level (tests/test_torch_
    features.py's tolerance). JAX stays on the CPU: on a card host it
    would otherwise take three quarters of the card's memory for the rest
    of the process."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")     # as tests/conftest.py
    from cubesat_apds_tpu.core.config import AkazeConfig as JAkazeConfig
    from cubesat_apds_tpu.ops.features import akaze as jakaze

    ref = jakaze.detect_and_compute_batch(
        jax.numpy.asarray(imgs.numpy()),
        JAkazeConfig(capacity=CAP, detect_topk="exact"))
    jv = np.asarray(ref.keypoints.valid)
    tv = feats.keypoints.valid.numpy()
    np.testing.assert_array_equal(tv.sum(-1), jv.sum(-1))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(feats.keypoints.xy.numpy()[tv],
                               np.asarray(ref.keypoints.xy)[jv], atol=1e-3)
    np.testing.assert_array_equal(feats.keypoints.class_id.numpy()[tv],
                                  np.asarray(ref.keypoints.class_id)[jv])
    np.testing.assert_array_equal(feats.descriptors.numpy(),
                                  np.asarray(ref.descriptors))


def test_back_half_names_use_the_shared_machinery():
    """pipelines/step_graph.py keeps its public names, now thin users of
    core/step_graph.py; the back half's cache and the front half's are
    two caches of the same bound."""
    for name in ("leaves", "spec", "step_key", "warmup_launches",
                 "StepGraph", "COUNTED"):
        assert getattr(step_graph, name) is getattr(core_graph, name)
    assert callable(step_graph.run) and callable(step_graph.step_graphs)
    assert step_graph.STEP_GRAPHS == takaze.FRONT_GRAPHS == 8
    assert step_graph._GRAPHS is not takaze._FRONT
    assert "fed_cycle" in core_graph.COUNTED
    assert set(step_graph.warmup_launches()) == set(core_graph.COUNTED)
    assert step_graph.clear_step_graphs() == 0


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels and graphs have "
                    "no CPU mode")
    return torch.device("cuda")


def _leaves_equal(a, b):
    la, lb = step_graph.leaves(a), step_graph.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


# (batch, frame size, capacity): the lone frame and the stream's batch at
# the bench's size, the build's tile batch, a tiled run's 1024² tile
# (kernel A in its halo-tile form).
CARD_CASES = {"512 B1": (1, 512, 2048), "512 B3": (3, 512, 2048),
              "256 B8": (8, 256, 1024), "1024 B1": (1, 1024, 4096)}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_graphed_front_half_equals_eager_on_card(cuda_device, case, mode):
    """The front half through its graph equals the eager `_front_end`
    bit for bit on every output; a second batch of the same shapes runs
    through the same graph and equals the eager front end on it; a held
    result is unchanged by the next call; kernel A counts 15 launches a
    replay on the device; the pool stays within 1.5x the eager front
    end's peak allocation plus 64 MiB."""
    from cubesat_apds_tpu_torch.ops.kernels import diffusion

    b, n, cap = CARD_CASES[case]
    cfg = AkazeConfig(capacity=cap, **MODES[mode])
    x = _frames(range(b), n).to(cuda_device)
    x2 = _frames(range(10, 10 + b), n).to(cuda_device)
    takaze.clear_front_graphs()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    eager = takaze._front_end(x, cfg, cap, None)
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated(cuda_device) - base

    got = takaze.front_half(x, cfg, cap, None)
    assert _leaves_equal(got, eager)
    (entry,) = takaze.front_graphs()
    assert entry.pool_bytes <= 1.5 * eager_peak + 64 * 2 ** 20, (
        entry.pool_bytes, eager_peak)
    held = [t.clone() for t in step_graph.leaves(got)]
    a0 = diffusion.device_launches(cuda_device)
    other = takaze.front_half(x2, cfg, cap, None)
    assert diffusion.device_launches(cuda_device) - a0 == 15
    assert len(takaze.front_graphs()) == 1
    assert _leaves_equal(other, takaze._front_end(x2, cfg, cap, None))
    assert all(torch.equal(t, h)
               for t, h in zip(step_graph.leaves(got), held))
    # The entry point replays the same graph.
    feats = takaze.detect_and_compute_batch(x, cfg, cap)
    assert len(takaze.front_graphs()) == 1
    assert torch.equal(feats.keypoints.xy, eager[0].xy)
    assert takaze.clear_front_graphs() == 1


@pytest.mark.cuda
def test_warmed_front_half_is_sync_free_on_card(cuda_device):
    """A host frame uploaded through pinned memory and a warmed
    detect_and_compute (front graph, ladder graph) run under
    set_sync_debug_mode("error"); the graph is kept across calls and
    `clear_front_graphs` frees it."""
    frame = _frame(5, 512)
    cfg = AkazeConfig(capacity=2048)
    takaze.clear_front_graphs()
    want = takaze.detect_and_compute(upload(frame, cuda_device), cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = takaze.detect_and_compute(upload(frame, cuda_device), cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _leaves_equal(got, want)
    assert int(got.keypoints.valid.sum()) > 100
    assert takaze.clear_front_graphs() == 1
    assert takaze.front_graphs() == []

