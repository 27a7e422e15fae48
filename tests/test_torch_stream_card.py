"""The stream's clock on the card: its step spans by CUDA events, placed
on the host clock through one anchor a run, with no wait a batch. The
file imports no JAX: it runs on the card, where the port runs alone."""

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
    run (the anchor and its closing) whatever the batches, and the
    closing anchor's drift under 0.5 ms."""
    s = StreamingLocalizer(_db(), CAM, CFG, solve_pose=False, batch=2,
                           prefetch=4, device=cuda_device)
    list(s.run(_frames(8)))                      # captures the graphs
    s.times = type(s.times)()
    waits = []
    sync, ev_sync = torch.cuda.synchronize, torch.cuda.Event.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: (waits.append("device"), sync(*a))[1])
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        lambda self: (waits.append("event"),
                                      ev_sync(self))[1])
    yielded = {}
    for r in s.run(_frames(8)):
        yielded[r.frame_id] = time.perf_counter()
    monkeypatch.undo()
    t = s.times
    assert waits == ["device", "device", "event"]
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
