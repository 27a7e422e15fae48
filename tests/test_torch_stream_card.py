"""The stream on the card: its step and front spans by CUDA events,
placed on the host clock through one anchor a run, with no device-wide
wait a batch; each batch's read-back landing in a pinned slot when its
own step ends; full-resolution 2048² frames at batch 8.
The file imports no JAX: it runs on the card, where the port runs
alone."""

import time

import numpy as np
import pytest
import torch

from cubesat_apds_tpu_torch.core.config import (
    AkazeConfig, MatchConfig, PipelineConfig, RansacConfig)
from cubesat_apds_tpu_torch.core.types import CameraModel
from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute
from cubesat_apds_tpu_torch.pipelines import localize as tloc
from cubesat_apds_tpu_torch.pipelines.stream import StreamingLocalizer

CFG = PipelineConfig(akaze=AkazeConfig(capacity=256),
                     match=MatchConfig(ratio=0.75),
                     ransac=RansacConfig(num_hypotheses=64))
CAM = CameraModel.ideal(100.0, 100.0, 64.0, 64.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA events time the step only "
                    "on the card")
    return torch.device("cuda")


def _frames(n, size=128):
    """uint8 frames: one scene of boxes rolled by 0..n-1 px along x."""
    rng = np.random.default_rng(9)
    img = np.zeros((size, size), np.float32)
    for _ in range(25):
        cy, cx = rng.integers(4, size - 20, 2)
        s = int(rng.integers(4, 20))
        img[cy:cy + s, cx:cx + s] = rng.uniform(0.2, 1.0)
    return [(np.roll(img, i, axis=1) * 255).astype(np.uint8)
            for i in range(n)]


def _db(size=128):
    f = detect_and_compute(torch.from_numpy(_frames(1, size)[0]).float()
                           / 255.0, CFG.akaze)
    m = int(f.keypoints.valid.sum())
    xy = f.keypoints.xy[:m]
    return tloc.DeviceDb(descriptors=f.descriptors[:m], xy=xy,
                         valid=f.keypoints.valid[:m],
                         obj_points=torch.cat([xy, torch.zeros(m, 1)], 1),
                         has_world=True)


@pytest.mark.cuda
def test_stream_clock_on_card(cuda_device, monkeypatch):
    """A warmed run of 4 batches of 2: one `step` span a batch, each
    frame's hold starting at its step's end, the step inside its
    dispatch start and the frame's yield; the device waited on twice a
    run (the anchor and its closing) whatever the batches, each batch
    waited on only through its own landing event, once, and no blocking
    copy; the closing anchor's drift under 0.5 ms."""
    s = StreamingLocalizer(_db(), CAM, CFG, solve_pose=False, batch=2,
                           prefetch=4, device=cuda_device)
    list(s.run(_frames(8)))                      # captures the graphs
    s.times = type(s.times)()
    waits, landed = [], []
    sync, ev_sync = torch.cuda.synchronize, torch.cuda.Event.synchronize
    cpu, finish = torch.Tensor.cpu, StreamingLocalizer._finish_batch
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: (waits.append("device"), sync(*a))[1])
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        lambda self: (waits.append(self),
                                      ev_sync(self))[1])
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: (waits.append("cpu"),
                                               cpu(self, *a, **k))[1])
    monkeypatch.setattr(StreamingLocalizer, "_finish_batch",
                        lambda self, b, anchor: (landed.append(b.landed),
                                                 finish(self, b, anchor))[1])
    yielded = {}
    for r in s.run(_frames(8)):
        yielded[r.frame_id] = time.perf_counter()
    monkeypatch.undo()
    t = s.times
    assert len(landed) == 4 and None not in landed
    assert [w for w in waits if not any(w is ev for ev in landed)][:2] \
        == ["device", "device"]
    rest = [w for w in waits if not any(w is ev for ev in landed)][2:]
    assert len(rest) == 1 and isinstance(rest[0], torch.cuda.Event)
    on_landed = [w for w in waits if any(w is ev for ev in landed)]
    assert len(on_landed) == len({id(w) for w in on_landed}) == 4
    assert abs(t.counts()["clock_drift_us"]) < 500
    steps = {sp[2]: sp for sp in t.spans("step")}
    dispatch = t.spans("dispatch")
    assert sorted(steps) == [0, 1, 2, 3] and len(dispatch) == 4
    tol = 5e-4
    for frame_id, y in yielded.items():
        step_end, hold_end, _, parent = t.spans("hold")[frame_id]
        start, end = steps[parent][:2]
        assert step_end == end
        assert dispatch[parent][0] - tol <= start < end <= hold_end + tol
        assert hold_end <= y
    assert t.starved()["window_s"] > 0


def _slow(frames, period_s, handed=None):
    for f in frames:
        time.sleep(period_s)
        if handed is not None:
            handed.append(time.perf_counter())
        yield f


@pytest.mark.cuda
def test_stream_holds_a_landed_frame_briefly_on_card(cuda_device):
    """Batch 1, prefetch 1, a producer slower than a step: each frame's
    `hold` (its step's end to its yield) under 2 ms, and each frame
    yielded before the next one is handed over."""
    s = StreamingLocalizer(_db(), CAM, CFG, solve_pose=False, batch=1,
                           prefetch=1, device=cuda_device)
    list(s.run(_frames(3)))                      # captures the graphs
    s.times = type(s.times)()
    handed, yielded = [], []
    for r in s.run(_slow(_frames(6), 0.05, handed)):
        yielded.append(time.perf_counter())
    holds = [e - b for b, e, _, _ in s.times.spans("hold")]
    assert len(holds) == 6 and max(holds) < 2e-3, holds
    assert all(y < h for y, h in zip(yielded, handed[1:]))
    assert s.times.counts()["readback_early"] >= 5


@pytest.mark.cuda
def test_stream_landing_slots_are_not_overwritten_on_card(cuda_device):
    """Batch 2, prefetch 4 (2 batches in flight, a ring of 3 slots) over
    8 batches, the results kept to the end: each equals the packed rows
    of the same frames through `_step` and `.cpu()`, bit for bit."""
    s = StreamingLocalizer(_db(), CAM, CFG, solve_pose=False, batch=2,
                           prefetch=4, device=cuda_device)
    frames = _frames(16)
    results = list(s.run(frames))
    assert len(s._landing) == 3
    assert [r.frame_id for r in results] == list(range(16))
    for k in range(8):
        want = s._step(torch.from_numpy(np.stack(frames[2 * k:2 * k + 2]))
                       .to(cuda_device)).cpu().numpy()
        for r, row in zip(results[2 * k:2 * k + 2], want):
            got = np.concatenate([r.homography.reshape(-1),
                                  [r.homography_ok, r.num_inliers,
                                   r.num_matches, r.num_keypoints]])
            np.testing.assert_array_equal(got.astype(np.float32),
                                          row[:13])


def _rows(results):
    return [np.concatenate([r.homography.reshape(-1),
                            [r.homography_ok, r.num_inliers, r.num_matches,
                             r.num_keypoints]]).astype(np.float32)
            for r in results]


@pytest.mark.cuda
def test_front_spans_inside_their_steps_on_card(cuda_device):
    """A warmed run of 4 batches of 2: one `front` span a `step` span,
    under the same batch id, starting with its step and ending before
    it; `front_pixels` counts every batch's B·H·W."""
    s = StreamingLocalizer(_db(), CAM, CFG, solve_pose=False, batch=2,
                           prefetch=4, device=cuda_device)
    list(s.run(_frames(8)))                      # captures the graphs
    s.times = type(s.times)()
    assert len(list(s.run(_frames(8)))) == 8
    t = s.times
    steps = {sp[2]: sp for sp in t.spans("step")}
    fronts = {sp[2]: sp for sp in t.spans("front")}
    assert sorted(steps) == sorted(fronts) == [0, 1, 2, 3]
    for i, (start, end, _, _) in steps.items():
        f_start, f_end = fronts[i][:2]
        assert f_start == start < f_end < end
    assert t.counts()["front_pixels"] == 4 * 2 * 128 * 128
    assert "front half" in t.report()


def _drop_cached_graphs():
    """Drop the graphs that earlier tests of this process left in the four
    process-wide caches (front half, ladder, back half, mesh) and hand
    the allocator's free blocks back to the device."""
    from cubesat_apds_tpu_torch.ops.features import akaze, ladder
    from cubesat_apds_tpu_torch.parallel import mesh
    from cubesat_apds_tpu_torch.pipelines import step_graph

    akaze.clear_front_graphs()
    ladder.clear_ladder_graphs()
    step_graph.clear_step_graphs()
    mesh.clear_mesh_graphs()
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_fullres_batch_of_8_through_the_stream_on_card(cuda_device):
    """Sixteen 2048² frames at batch 8, prefetch 16: each yielded frame
    equals the packed row of the same frames through `_step`, bit for
    bit; one `front` span a batch, over 8·2048² pixels each. The front
    graph of this key holds ~7 GiB, so the test starts from empty graph
    caches and empties them again after itself."""
    _drop_cached_graphs()
    try:
        s = StreamingLocalizer(_db(2048), CAM, CFG, solve_pose=False,
                               batch=8, prefetch=16, device=cuda_device)
        frames = _frames(16, size=2048)
        results = list(s.run(frames))
        assert [r.frame_id for r in results] == list(range(16))
        for k in range(2):
            want = s._step(torch.from_numpy(np.stack(
                frames[8 * k:8 * k + 8])).to(cuda_device)).cpu().numpy()
            for got, row in zip(_rows(results[8 * k:8 * k + 8]), want):
                np.testing.assert_array_equal(got, row[:13])
        assert len(s.times.spans("front")) == \
            len(s.times.spans("step")) == 2
        assert s.times.counts()["front_pixels"] == 2 * 8 * 2048 * 2048
    finally:
        _drop_cached_graphs()
