"""The port's batch and stream slice: detect_and_compute_batch, the batched
kernel twins, and StreamingLocalizer, against the port's own single-image
path (bit for bit) and against the JAX package (to the tolerances of
tests/test_torch_features.py and tests/test_torch_localize.py).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubesat_apds_tpu.core.config import AkazeConfig as JAkazeConfig
from cubesat_apds_tpu.core.config import MatchConfig as JMatchConfig
from cubesat_apds_tpu.core.config import PipelineConfig as JPipelineConfig
from cubesat_apds_tpu.core.config import RansacConfig as JRansacConfig
from cubesat_apds_tpu.core.types import CameraModel as JCameraModel
from cubesat_apds_tpu.ops.features import akaze as jakaze
from cubesat_apds_tpu.pipelines.localize import load_device_db as jload
from cubesat_apds_tpu.pipelines.localize import localize_frame_jit
from cubesat_apds_tpu.store.feature_store import FeatureStore as JFeatureStore
from cubesat_apds_tpu_torch.core.config import (
    AkazeConfig, MatchConfig, PipelineConfig, PnPConfig, RansacConfig)
from cubesat_apds_tpu_torch.core.types import CameraModel
from cubesat_apds_tpu_torch.ops.features import scale_space as tss
from cubesat_apds_tpu_torch.ops.features.akaze import (
    detect_and_compute, detect_and_compute_batch)
from cubesat_apds_tpu_torch.ops.kernels import diffusion as tdiff
from cubesat_apds_tpu_torch.ops.kernels import sample_kernel as tsk
from cubesat_apds_tpu_torch.pipelines import localize as tloc
from cubesat_apds_tpu_torch.pipelines.stream import (
    StreamingLocalizer, stream_localize)
from cubesat_apds_tpu_torch.store import open_store
from cubesat_apds_tpu_torch.utils.profiling import StageTimes

torch.set_num_threads(2)

KP_FIELDS = ("xy", "size", "angle", "response", "octave", "class_id",
             "valid")


def _frame(seed, n, boxes=None):
    """tests/test_torch_features.py's corner-rich frame, at n×n."""
    rng = np.random.default_rng(seed)
    img = np.zeros((n, n), np.float32)
    for _ in range(boxes or 120 * n * n // (512 * 512) + 30):
        cy, cx = rng.integers(4, n - 20, 2)
        s = int(rng.integers(4, 20))
        img[cy:cy + s, cx:cx + s] = rng.uniform(0.2, 1.0)
    return img


# --- detect_and_compute_batch ---------------------------------------------

@pytest.fixture(scope="module")
def batch3():
    imgs = np.stack([_frame(s, 128) for s in (3, 4, 7)])
    return imgs, detect_and_compute_batch(torch.from_numpy(imgs),
                                          AkazeConfig(capacity=256))


def test_batch_is_bit_identical_to_single_images(batch3):
    """B = 3 at 128²: every keypoint field and descriptor of each image
    equals detect_and_compute on that image alone, bit for bit."""
    imgs, fb = batch3
    for b in range(3):
        f = detect_and_compute(torch.from_numpy(imgs[b]),
                               AkazeConfig(capacity=256))
        for k in KP_FIELDS:
            assert torch.equal(getattr(f.keypoints, k),
                               getattr(fb.keypoints, k)[b]), (b, k)
        assert torch.equal(f.descriptors, fb.descriptors[b]), b
        assert int(f.keypoints.valid.sum()) > 20


def test_batch_matches_jax_batch(batch3):
    """Against the JAX package's detect_and_compute_batch (exact top-K),
    per image: counts within 1%, ≥ 99% of JAX's keypoints found within
    1e-3 px on the same level, and ≥ 99.9% of the descriptor bits of
    those keypoints equal."""
    imgs, fb = batch3
    ref = jakaze.detect_and_compute_batch(
        jnp.asarray(imgs), JAkazeConfig(capacity=256, detect_topk="exact"))
    for b in range(3):
        jv = np.asarray(ref.keypoints.valid[b])
        tv = fb.keypoints.valid[b].numpy()
        assert abs(int(jv.sum()) - int(tv.sum())) <= max(1, 0.01 * jv.sum())
        jxy = np.asarray(ref.keypoints.xy[b])[jv]
        txy = fb.keypoints.xy[b].numpy()[tv]
        jl = np.asarray(ref.keypoints.class_id[b])[jv]
        tl = fb.keypoints.class_id[b].numpy()[tv]
        same = (np.abs(jxy[:, None] - txy[None]).max(-1) <= 1e-3) \
            & (jl[:, None] == tl[None])
        assert same.any(1).mean() >= 0.99
        ji, ti = np.nonzero(same)
        jd = np.unpackbits(np.asarray(ref.descriptors[b])[jv][ji], axis=1)
        td = np.unpackbits(fb.descriptors[b].numpy()[tv][ti], axis=1)
        assert (jd == td).mean() >= 0.999


def test_batched_kernel_twins_equal_per_image():
    """Kernel A's twin on [B, H, W] and kernel B's sampler on a batch of
    stacks equal their per-image calls (torch.equal)."""
    rng = np.random.default_rng(2)
    L = torch.from_numpy(rng.uniform(0, 1, (3, 40, 56)).astype(np.float32))
    g = torch.from_numpy(rng.uniform(0.2, 1, (3, 40, 56)).astype(np.float32))
    taus = tss.fed_tau_by_process_time(3.0)
    got = tdiff.fed_cycle(L, g, taus)
    for b in range(3):
        assert torch.equal(got[b], tdiff.fed_cycle(L[b], g[b], taus))

    B, Lv, H, W, K, S = 3, 4, 24, 20, 7, 9
    stacks = torch.from_numpy(rng.standard_normal((B, Lv, H, W, 4)).astype(
        np.float32)).to(torch.bfloat16)
    level_hw = torch.tensor([[24, 20], [12, 10], [24, 20], [6, 5]],
                            dtype=torch.int32)
    lvl = torch.from_numpy(rng.integers(0, Lv, (B, K)))
    iy = torch.from_numpy(rng.integers(-3, 27, (B * K, S)))
    ix = torch.from_numpy(rng.integers(-3, 23, (B * K, S)))
    got = tsk.patch_sampler(stacks, level_hw, lvl)(iy, ix)
    for b in range(B):
        want = tsk.patch_sampler(stacks[b], level_hw, lvl[b])(
            iy[b * K:(b + 1) * K], ix[b * K:(b + 1) * K])
        assert torch.equal(got[b * K:(b + 1) * K], want)


def test_batched_fed_twin_matches_vmapped_pallas():
    """Kernel A's batched twin against the Pallas FED kernel vmapped over
    the batch, in interpret mode: atol 1e-5 (the Pallas stencil sums in
    another fused order)."""
    from jax.experimental.pallas import tpu as pltpu

    from cubesat_apds_tpu.ops.pallas import diffusion as D

    rng = np.random.default_rng(8)
    L = rng.uniform(0, 1, (2, 32, 128)).astype(np.float32)
    g = rng.uniform(0.2, 1.0, (2, 32, 128)).astype(np.float32)
    taus = tss.fed_tau_by_process_time(1.0)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.vmap(lambda a, b: D._fed_cycle_pallas(
            a, b, jnp.asarray(taus), len(taus)))(jnp.asarray(L),
                                                 jnp.asarray(g))
    got = tdiff.fed_cycle(torch.from_numpy(L), torch.from_numpy(g), taus)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


# --- StreamingLocalizer ----------------------------------------------------

CFG = PipelineConfig(akaze=AkazeConfig(capacity=256),
                     match=MatchConfig(ratio=0.75),
                     ransac=RansacConfig(num_hypotheses=64),
                     pnp=PnPConfig(num_hypotheses=32))
CAM = CameraModel.ideal(100.0, 100.0, 64.0, 64.0)


def _frames(n=4, size=128):
    """uint8 frames: one scene rolled by 0..n-1 px along x."""
    base = _frame(9, size, boxes=25)
    return [(np.roll(base, i, axis=1) * 255).astype(np.uint8)
            for i in range(n)]


@pytest.fixture(scope="module")
def db():
    """The scene's own features as the DB (obj = (xy, 0))."""
    f = detect_and_compute(torch.from_numpy(_frames(1)[0]).float() / 255.0,
                           CFG.akaze)
    m = int(f.keypoints.valid.sum())
    xy = f.keypoints.xy[:m]
    return tloc.DeviceDb(descriptors=f.descriptors[:m], xy=xy,
                         valid=f.keypoints.valid[:m],
                         obj_points=torch.cat([xy, torch.zeros(m, 1)], 1),
                         has_world=True)


def _stream(db, **kw):
    return StreamingLocalizer(db, CAM, CFG, device="cpu", **kw)


def test_streaming_localizer_yields_all_frames(db):
    s = _stream(db, solve_pose=False)
    results = list(s.run(_frames(5)))
    assert [r.frame_id for r in results] == [0, 1, 2, 3, 4]
    for r in results:
        assert r.num_keypoints > 0 and r.latency_s > 0
        assert r.rvec is None and r.pose_ok is None
    summary = s.times.summary()
    assert "device_wait" in summary and "host_preprocess" in summary


def test_streaming_preprocess_hook(db):
    s = _stream(db, solve_pose=False)
    calls = []

    def pre(f):
        calls.append(1)
        return f.astype(np.float32) / 255.0 * 0.5

    results = list(s.run(_frames(3), preprocess=pre))
    assert len(results) == 3 and len(calls) == 3


def test_streaming_slow_producer_ordering(db):
    """Ordering and latency under a producer slower than the step: every
    frame once, in order, each latency from its own enqueue."""
    s = _stream(db, solve_pose=False, prefetch=2)

    def slow_frames():
        for f in _frames(4):
            time.sleep(0.15)
            yield f

    t0 = time.perf_counter()
    results = list(s.run(slow_frames()))
    wall = time.perf_counter() - t0
    assert [r.frame_id for r in results] == list(range(4))
    for r in results:
        assert 0 < r.latency_s < wall
    assert wall >= 4 * 0.15


def test_stream_yields_a_landed_batch_before_the_next_frame(db):
    """Batch 1, prefetch 1, a producer slower than the step: every frame
    once, in order, each yielded before the next frame is handed over
    (its batch landed, and nothing waits for a later frame), and every
    batch counts as read back early. The producer sleeps 0.15 s a frame
    and then gives the previous frame up to 5 s to come out, so that it
    stays slower than the step on a loaded machine."""
    s = _stream(db, solve_pose=False, prefetch=1)
    list(s.run(_frames(1)))                  # first calls outside the timing
    s.times = StageTimes()
    handed, yielded = [], []
    out = threading.Event()

    def slow_frames():
        for i, f in enumerate(_frames(4)):
            time.sleep(0.15)
            if i:
                out.wait(timeout=5.0)
                out.clear()
            handed.append(time.perf_counter())
            yield f

    results = []
    for r in s.run(slow_frames()):
        yielded.append(time.perf_counter())
        out.set()
        results.append(r)
    assert [r.frame_id for r in results] == list(range(4))
    for i in range(3):
        assert yielded[i] < handed[i + 1]
    assert (s.times.counts()["readback_early"]
            == len(s.times.values("dispatch")) == 4)
    assert "read back early: 4 of 4 batches (100.00%)" in s.times.report()


def test_streaming_producer_exception_propagates(db):
    """A failing producer does not deadlock run(): its exception re-raises
    on the consumer side."""
    s = _stream(db, solve_pose=False)

    def bad_frames():
        yield _frames(1)[0]
        raise RuntimeError("camera unplugged")

    with pytest.raises(RuntimeError, match="camera unplugged"):
        list(s.run(bad_frames()))


def test_stage_times_report():
    t = StageTimes()
    with t.measure("a"):
        pass
    t.add("b", 0.01)
    rep = t.report()
    assert "a" in rep and "b" in rep
    assert t.summary()["b"]["mean_ms"] == 10.0
    assert t.values("b") == [0.01] and t.values("c") == []


class _Event:
    """A stand-in for a timing CUDA event: `ms` on the device's clock."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_stage_times_spans_counts_and_starved_split():
    """Spans, counts, the union of the `step` spans and the split of its
    gaps by the consumer's spans, on hand-made intervals (binary
    fractions, so every number is exact); report() prints the split."""
    t = StageTimes()
    assert t.starved() is None
    for s, e in [(1.0, 3.0), (0.0, 2.0), (4.0, 5.0), (7.0, 8.0)]:
        t.span("step", s, e, id=int(s))
    t.span("frames", 2.5, 3.5)            # 0.5 of the gap (3, 4)
    t.stage("dispatch", 3.5, 3.75)        # 0.25 of it
    t.stage("device_wait", 5.0, 5.5)      # 0.5 of the gap (5, 7)
    t.span("yielded", 6.0, 6.5)
    t.span("yielded", 6.5, 9.0)           # 1.0 in all, past the window
    t.span("wait", 0.0, 1.0, id=3, parent=0)
    t.count("query_slots", 8)
    t.count("live_keypoints")
    t.count("live_keypoints", 2)
    assert t.spans("wait") == [(0.0, 1.0, 3, 0)]
    assert t.spans("step")[1] == (0.0, 2.0, 0, None) and t.spans("x") == []
    assert t.values("dispatch") == [0.25]
    assert t.counts() == {"query_slots": 8, "live_keypoints": 3}
    st = t.starved()
    assert (st["window_s"], st["busy_s"], st["share"]) == (8.0, 5.0, 0.375)
    assert st["split"] == {"frames": 0.5, "dispatch": 0.25,
                           "device_wait": 0.5, "yielded": 1.0,
                           "other": 0.75}
    rep = t.report()
    assert ("device starved 37.50% of 8.000 s: frames 6.25%, dispatch "
            "3.12%, device_wait 6.25%, yielded 12.50%, other 9.38%") in rep
    assert "counts: live_keypoints 3, query_slots 8" in rep
    assert "read back early: 0 of 1 batches (0.00%)" in rep
    assert "wait (span)" in rep and "step (span)" in rep


def test_stage_times_device_span_on_the_host_clock():
    """A device span starts at the anchor's host time plus the anchor
    event's time to the start event, and lasts the events' own time."""
    t = StageTimes()
    end = t.device_span("step", (_Event(100.0), 10.0), _Event(600.0),
                        _Event(850.0), id=4)
    assert end == 10.75 and t.spans("step") == [(10.5, 10.75, 4, None)]


def test_stream_records_each_frames_spans_and_counts(db):
    """5 frames at batch 2 on the CPU: each yielded frame has one `wait`
    and one `hold` under its frame_id, its batch as parent, in the order
    arrival <= enqueue <= dispatch start <= step end <= yield; one
    `dispatch` a batch; the counts cover every batch's slots and the
    yielded frames' keypoints, and the two full batches, landed when
    their steps returned, as read back early (the tail batch is the
    drain's); no device span off the card."""
    s = _stream(db, solve_pose=False, batch=2)
    arrival, yielded = [], []

    def frames():
        for f in _frames(5):
            arrival.append(time.perf_counter())
            yield f

    results = []
    for r in s.run(frames()):
        yielded.append(time.perf_counter())
        results.append(r)
    t = s.times
    wait = {sp[2]: sp for sp in t.spans("wait")}
    hold = {sp[2]: sp for sp in t.spans("hold")}
    dispatch = t.spans("dispatch")
    assert len(t.spans("wait")) == len(t.spans("hold")) == 5
    assert len(dispatch) == len(t.values("dispatch")) == 3
    for i, r in enumerate(results):
        enq, disp, _, parent = wait[r.frame_id]
        step_end, y, _, hold_parent = hold[r.frame_id]
        assert parent == hold_parent == i // 2
        assert disp == dispatch[parent][0]
        assert arrival[i] <= enq <= disp <= step_end <= y <= yielded[i]
        assert step_end == hold[results[2 * parent].frame_id][0]
    assert t.spans("step") == [] and t.starved() is None
    assert t.counts() == {"query_slots": 3 * 2 * CFG.akaze.capacity,
                          "live_keypoints": sum(r.num_keypoints
                                                for r in results),
                          "readback_early": 2,
                          "front_pixels": 3 * 2 * 128 * 128}
    assert len(t.spans("yielded")) == 5 and len(t.spans("frames")) == 6


def test_stream_counts_front_pixels_and_records_no_front_span_off_the_card(
        db):
    """7 frames of 128² at batch 3: `front_pixels` counts B·H·W for each
    of the three batches, the tail batch's two padded rows included; the
    `front` span, timed by CUDA events, is never recorded on the CPU, and
    report() then prints no front share."""
    s = _stream(db, solve_pose=False, batch=3)
    assert len(list(s.run(_frames(7)))) == 7
    t = s.times
    assert len(t.values("dispatch")) == 3
    assert t.counts()["front_pixels"] == 3 * 3 * 128 * 128
    assert t.spans("front") == [] and s._front_end is None
    assert "front half" not in t.report()


def test_stage_times_report_gives_the_front_share():
    """report() prints the `front` spans' mean and their share of the
    `step` spans' time (binary fractions, so the numbers are exact)."""
    t = StageTimes()
    for i, (s, f, e) in enumerate([(0.0, 0.5, 1.0), (1.0, 1.25, 2.0)]):
        t.span("step", s, e, id=i)
        t.span("front", s, f, id=i)
    assert "front half 375.00 ms a step, 37.50% of the step time" \
        in t.report()


def _packed_of(res):
    """A LocalizationResult's outputs in the stream's packed order."""
    h, p = res.homography, res.pose
    return np.concatenate([h.H.numpy().reshape(-1),
                           [float(h.ok), float(h.num_inliers),
                            float(res.num_matches), float(res.num_keypoints)],
                           p.rvec.numpy(), p.tvec.numpy(),
                           [float(p.ok), float(p.num_inliers)]])


def _stream_packed(r):
    return np.concatenate([r.homography.reshape(-1),
                           [r.homography_ok, r.num_inliers, r.num_matches,
                            r.num_keypoints], r.rvec, r.tvec,
                           [r.pose_ok, r.pose_num_inliers]]).astype(
                               np.float64)


@pytest.mark.parametrize("batch", [1, 3])
def test_stream_equals_localizer(db, batch):
    """Batch 1 and batch 3 (the last batch padded): each frame's packed
    outputs equal Localizer.localize on the same frame (u8 / 255), field
    for field; padded rows are not yielded."""
    frames = _frames(5)
    s = _stream(db, batch=batch)
    results = list(s.run(frames))
    assert [r.frame_id for r in results] == list(range(5))
    loc = tloc.Localizer(db, CAM, CFG, device="cpu")
    for r, f in zip(results, frames):
        want = _packed_of(loc.localize(torch.from_numpy(f).float() / 255.0))
        np.testing.assert_array_equal(_stream_packed(r),
                                      want.astype(np.float32))
    assert results[2].homography_ok
    np.testing.assert_allclose(results[2].homography[0, 2], -2.0, atol=0.5)


def test_stream_tail_batch_is_padded(db):
    """5 frames at batch 2: three steps, the last padded by repeating its
    frame, five results in order."""
    s = _stream(db, solve_pose=False, batch=2)
    results = list(s.run(_frames(5)))
    assert [r.frame_id for r in results] == list(range(5))
    assert len(s.times.values("dispatch")) == 3


def test_pruned_stream_falls_back(db):
    """Pruned serving with a coarse DB that cannot fix a frame: the frame
    reruns through the full-DB fallback (fallback_frames == 1), and its
    answer equals localize_frame_pruned_fallback_jit's."""
    bad = tloc.DeviceDb(descriptors=torch.zeros((64, 61), dtype=torch.uint8),
                        xy=torch.zeros((64, 2)),
                        valid=torch.zeros(64, dtype=torch.bool),
                        obj_points=torch.zeros((64, 3)), has_world=True)
    pdb = tloc.make_pruned_db(db, bad, window_capacity=512)
    frame = _frames(3)[2]
    s = _stream(pdb)
    (r,) = list(s.run([frame]))
    assert s.fallback_frames == 1 and len(s.times.values("fallback")) == 1
    want = tloc.localize_frame_pruned_fallback_jit(
        torch.from_numpy(frame).float() / 255.0, pdb, CAM, CFG,
        solve_pose=True)
    np.testing.assert_array_equal(_stream_packed(r),
                                  _packed_of(want).astype(np.float32))


def test_pruned_stream_equals_pruned_step(db):
    """Pruned serving at batch 2 with a good coarse DB: no fallback, and
    each frame's homography equals localize_frame_pruned_jit's."""
    pdb = tloc.make_pruned_db(db, db, window_capacity=512)
    frames = _frames(3)
    s = _stream(pdb, solve_pose=False, batch=2)
    results = list(s.run(frames))
    assert s.fallback_frames == 0
    for r, f in zip(results, frames):
        want = tloc.localize_frame_pruned_jit(
            torch.from_numpy(f).float() / 255.0, pdb, CAM, CFG)
        np.testing.assert_array_equal(r.homography,
                                      want.result.homography.H.numpy())


def test_stream_refuses_a_mesh(db):
    """A mesh with a pruned DB is refused, as the JAX package refuses it:
    the spatial window is a single-device structure."""
    from cubesat_apds_tpu_torch.parallel.mesh import make_mesh

    pdb = tloc.make_pruned_db(db, db, window_capacity=512)
    with pytest.raises(ValueError, match="not with a mesh"):
        StreamingLocalizer(pdb, CAM, CFG, batch=4,
                           mesh=make_mesh(dp=2, tp=2, devices=["cpu"] * 4))


def test_mesh_stream_equals_batch_stream(db):
    """A stream over a dp=2 × tp=2 mesh of CPU slots (batch 3 rounded up
    to 4; five frames, the last batch padded): every frame's packed
    outputs equal the batch-4 stream's without a mesh, bit for bit."""
    from cubesat_apds_tpu_torch.parallel.mesh import make_mesh

    frames = _frames(5)
    mesh = make_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    s = StreamingLocalizer(db, CAM, CFG, batch=3, mesh=mesh)
    assert s.batch == 4 and s.device == torch.device("cpu")
    got = list(s.run(frames))
    want = list(_stream(db, batch=4).run(frames))
    assert [r.frame_id for r in got] == list(range(5))
    for r, w in zip(got, want):
        np.testing.assert_array_equal(_stream_packed(r), _stream_packed(w))
    assert got[2].homography_ok


# --- the slice against JAX -------------------------------------------------

N, CAP = 256, 512
JCFG = JPipelineConfig(akaze=JAkazeConfig(capacity=CAP, detect_topk="exact"),
                       match=JMatchConfig(ratio=0.75),
                       ransac=JRansacConfig(num_hypotheses=128))
TCFG = PipelineConfig(akaze=AkazeConfig(capacity=CAP),
                      match=MatchConfig(ratio=0.75),
                      ransac=RansacConfig(num_hypotheses=128))
CAM256 = (300.0, 300.0, 128.0, 128.0)


def test_stream_from_jax_saved_store_matches_localize_frame_jit(tmp_path):
    """A JAX-saved npz store (the JAX package's features of the 256² frame
    rolled by (7, 13)), three frames shifted by 0–2 px more, capacity 512:
    the port's stream (from open_store → load_device_db) against
    localize_frame_jit on the JAX package's load of the same store —
    homography-inlier Jaccard ≥ 0.95 (by query point and DB row), and the
    port's H recovering each shift within 0.5 px."""
    rng = np.random.default_rng(42)
    frame = np.zeros((N, N), np.float32)
    for _ in range(60):
        cy, cx = rng.integers(10, N - 50, 2)
        s = int(rng.integers(8, 40))
        frame[cy:cy + s, cx:cx + s] = rng.uniform(0.2, 1.0)
    feats = jakaze.detect_and_compute(
        jnp.asarray(np.roll(frame, (7, 13), (0, 1))), JCFG.akaze)
    v = np.asarray(feats.keypoints.valid)
    js = JFeatureStore()
    iid = js.create_image(0, 0, N, N, 0)
    k = int(v.sum())
    js.add_keypoints(iid, np.asarray(feats.keypoints.xy)[v, 0],
                     np.asarray(feats.keypoints.xy)[v, 1],
                     np.asarray(feats.keypoints.size)[v],
                     np.asarray(feats.keypoints.angle)[v],
                     np.asarray(feats.keypoints.response)[v],
                     np.asarray(feats.keypoints.octave)[v],
                     np.asarray(feats.keypoints.class_id)[v],
                     np.asarray(feats.descriptors)[v])
    js.descriptor_mode = "exact"
    js.save(str(tmp_path))
    assert k > 50

    jdb = jload(JFeatureStore.load(str(tmp_path)), 0, pad_multiple=512)
    tdb = tloc.load_device_db(open_store(str(tmp_path)), 0, pad_multiple=512,
                              device="cpu")
    frames = [(np.roll(frame, (0, -d), (0, 1)) * 255).astype(np.uint8)
              for d in range(3)]
    results, times = stream_localize(
        frames, tdb, CameraModel.ideal(*CAM256), TCFG, solve_pose=False,
        device="cpu")
    assert len(results) == 3 and "total_latency" in times.summary()
    for d, (f, r) in enumerate(zip(frames, results)):
        f8 = f.astype(np.float32) / np.float32(255.0)
        ref = localize_frame_jit(jnp.asarray(f8), jdb,
                                 JCameraModel.ideal(*CAM256), JCFG, False)
        got = tloc.localize_frame_jit(torch.from_numpy(f8), tdb,
                                      CameraModel.ideal(*CAM256), TCFG)
        np.testing.assert_array_equal(r.homography, got.homography.H.numpy())

        def rows(res):
            m = np.asarray(res.matches.valid) & np.asarray(
                res.homography.inliers)
            q = np.asarray(res.keypoints.xy)[np.asarray(
                res.matches.query_idx)[m]]
            return np.concatenate([q, np.asarray(
                res.matches.train_idx)[m][:, None]], 1)

        a, b = rows(got), rows(ref)
        same = (np.abs(a[:, None, :2] - b[None, :, :2]).max(-1) <= 1e-2) \
            & (a[:, None, 2] == b[None, :, 2])
        hits = int(same.any(1).sum())
        assert len(a) > 30 and hits / (len(a) + len(b) - hits) >= 0.95
        np.testing.assert_allclose(r.homography[:2, 2], [13.0 + d, 7.0],
                                   atol=0.5)
