"""The stream on the card: its step spans by CUDA events, placed on the
host clock through one anchor a run, with no device-wide wait a batch;
each batch's read-back landing in a pinned slot when its own step ends.
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


def _db():
    f = detect_and_compute(torch.from_numpy(_frames(1)[0]).float() / 255.0,
                           CFG.akaze)
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
