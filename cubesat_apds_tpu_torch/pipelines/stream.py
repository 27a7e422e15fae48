"""Streaming attitude determination: continuous frame → pose (port of
pipelines/stream.py).

  * a producer thread decodes and preprocesses frame t+1 and uploads it
    (uint8, from pinned host memory, non-blocking on a side stream, an
    event marking its arrival) while the step runs on frame t;
  * the step takes a micro-batch of `batch` frames: the AKAZE front end
    runs on the whole batch (kernels A and B launched once per batch),
    then the match and geometry back half runs frame by frame, each frame
    drawing its RANSAC hypotheses exactly as when served alone;
  * every scalar output of a frame is packed into ONE float32 vector
    (`_pack_outputs`), so a batch costs one device-to-host copy;
  * a PrunedDeviceDb serves each frame through the spatial window; a
    frame whose coarse fix fails or whose window overflows reruns through
    the full-DB fallback, synchronously;
  * per-stage wall-clock stats (`StageTimes`) feed the cadence report.

The step reads each batch's live keypoint count on the host (AKAZE's
per-keypoint stages run on the live prefix), so unlike the JAX stream it
cannot queue steps ahead of the device: the producer's overlap covers the
decode, the upload and the previous result's fetch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from cubesat_apds_tpu_torch.core.config import PipelineConfig
from cubesat_apds_tpu_torch.core.types import CameraModel, select, to_device
from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute_batch
from cubesat_apds_tpu_torch.pipelines.localize import (
    PrunedDeviceDb, _pruned_back_half, localize_frame_pruned_fallback,
    localize_from_features, resident_db)
from cubesat_apds_tpu_torch.utils.profiling import StageTimes

_MARGIN = 0.25


def _pack_outputs(h, num_matches, num_keypoints, pose):
    """Every scalar output of a frame as ONE [21] float32 vector: H
    (0–8), h_ok/h_inliers/matches/keypoints (9–12), rvec (13–15), tvec
    (16–18), pose_ok (19), pose_inliers (20) — the single definition of
    the packed layout; `_unpack` is its only reader."""
    def f(x):
        return torch.as_tensor(x).to(torch.float32).reshape(-1)

    dev = h.H.device
    tail = [f(h.ok), f(h.num_inliers), f(num_matches), f(num_keypoints)]
    if pose is not None:
        tail += [f(pose.rvec), f(pose.tvec), f(pose.ok), f(pose.num_inliers)]
    else:
        tail += [torch.zeros(8, dtype=torch.float32, device=dev)]
    return torch.cat([f(h.H)] + tail)


def _as_float(frames):
    """uint8 frames → float32 in [0, 1] (on the frames' device)."""
    if frames.dtype == torch.uint8:
        return frames.to(torch.float32) / 255.0
    return frames.to(torch.float32)


@dataclasses.dataclass
class StreamResult:
    frame_id: int
    homography: np.ndarray
    homography_ok: bool
    num_inliers: int
    num_matches: int
    num_keypoints: int
    rvec: Optional[np.ndarray]
    tvec: Optional[np.ndarray]
    pose_ok: Optional[bool]
    pose_num_inliers: Optional[int]
    latency_s: float


class StreamingLocalizer:
    """Continuous localization against a DB resident on one device (the
    card unless the caller names another: `device="cpu"` runs the plain
    PyTorch path).

    `batch` > 1 serves B frames per step ([B, H, W] → [B, 21] packed): one
    front-end pass and one fetch per B frames. A PrunedDeviceDb
    (load_pruned_device_db) switches every frame to pruned serving; frames
    whose coarse fix fails or whose window overflows rerun synchronously
    through the full-DB fallback (`fallback_frames` counts them).
    `mesh` (multi-device serving) is not ported: it raises.
    """

    def __init__(self, db, camera: CameraModel,
                 config: PipelineConfig = PipelineConfig(),
                 solve_pose: bool = True, prefetch: int = 2,
                 transfer_uint8: bool = True, batch: int = 1,
                 mesh=None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "StreamingLocalizer(mesh=...): multi-device serving is "
                "slice 7 of the port (ROADMAP Queue 1), not ported yet")
        self.device = torch.device("cuda" if device is None else device)
        self._pruned = isinstance(db, PrunedDeviceDb)
        self.db = (to_device(db, self.device) if self._pruned
                   else resident_db(db, config, self.device))
        self.camera = to_device(camera, self.device)
        self.config = config
        self.solve_pose = solve_pose
        self.prefetch = max(prefetch, 1)
        # Camera frames are uint8; shipping them as such quarters the
        # host→device traffic (float conversion happens on the device).
        self.transfer_uint8 = transfer_uint8
        self.batch = max(int(batch), 1)
        self.fallback_frames = 0
        self.times = StageTimes()
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    # ---- the device step ------------------------------------------------

    def _step(self, frames):
        """frames [B, H, W] on the device → [B, 21] packed outputs; pruned,
        [B, 23]: coarse_ok (21) and overflow (22) appended."""
        frames = _as_float(frames)
        feats = detect_and_compute_batch(frames, self.config.akaze)
        rows = []
        for b in range(frames.shape[0]):
            f = select(feats, b)
            if self._pruned:
                pr = _pruned_back_half(f, tuple(frames.shape[1:]), self.db,
                                       self.camera, self.config,
                                       self.solve_pose, _MARGIN)
                r = pr.result
                flags = torch.stack([pr.coarse_ok, pr.overflow]).float()
                rows.append(torch.cat([_pack_outputs(
                    r.homography, r.num_matches, r.num_keypoints, r.pose),
                    flags]))
            else:
                r = localize_from_features(f, self.db, self.camera,
                                           self.config, self.solve_pose)
                rows.append(_pack_outputs(r.homography, r.num_matches,
                                          r.num_keypoints, r.pose))
        return torch.stack(rows)

    def _maybe_fallback(self, packed: np.ndarray, frame) -> np.ndarray:
        """Pruned mode: rerun a coarse-miss / overflowed frame through
        the full-DB fallback (synchronous — rare by design)."""
        if not self._pruned or (packed[21] > 0 and packed[22] <= 0):
            return packed
        self.fallback_frames += 1
        t0 = time.perf_counter()
        r = localize_frame_pruned_fallback(_as_float(frame), self.db,
                                           self.camera, self.config,
                                           self.solve_pose)
        out = torch.cat([_pack_outputs(r.homography, r.num_matches,
                                       r.num_keypoints, r.pose),
                         torch.tensor([1.0, 0.0], device=self.device)])
        packed = out.cpu().numpy()
        self.times.add("fallback", time.perf_counter() - t0)
        return packed

    # ---- upload ---------------------------------------------------------

    def _upload(self, f: np.ndarray):
        """Host frame → (device tensor, event that marks its arrival or
        None). On the card: a pinned copy, sent non-blocking on the side
        stream."""
        host = torch.tensor(f)
        if self._copy_stream is None:
            return host.to(self.device), None
        host = host.pin_memory()
        with torch.cuda.stream(self._copy_stream):
            dev = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return dev, ready

    def _on_step_stream(self, dev, ready):
        """Order the step after the frame's upload, and tell the caching
        allocator that the step's stream uses the frame."""
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            dev.record_stream(stream)
        return dev

    # ---- the stream -----------------------------------------------------

    def run(self, frames: Iterable[np.ndarray],
            preprocess: Optional[Callable[[np.ndarray], np.ndarray]] = None
            ) -> Iterator[StreamResult]:
        """Yield a StreamResult per input frame, in order, pipelined.

        `preprocess` runs on the producer thread (e.g. decode +
        grayscale); frames must share one shape. A final partial batch is
        padded by repeating its last frame; padded rows are never
        yielded.
        """
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        producer_error: list = []

        def producer():
            # The sentinel is ALWAYS enqueued (even on producer failure),
            # so the consumer can't block forever; the exception is
            # stashed and re-raised on the consumer side.
            try:
                with (torch.cuda.device(self.device)
                      if self._copy_stream is not None
                      else contextlib.nullcontext()):
                    for i, f in enumerate(frames):
                        t0 = time.perf_counter()
                        if preprocess is not None:
                            f = preprocess(f)
                        f = np.asarray(f)
                        if self.transfer_uint8 and f.dtype != np.uint8:
                            f = np.clip(f * 255.0, 0, 255).astype(np.uint8)
                        dev, ready = self._upload(f)
                        self.times.add("host_preprocess",
                                       time.perf_counter() - t0)
                        q.put((i, dev, ready, time.perf_counter()))
            except BaseException as e:  # noqa: BLE001 — re-raised below
                producer_error.append(e)
            finally:
                q.put(sentinel)

        threading.Thread(target=producer, daemon=True).start()

        in_flight = []  # [(ids, t_enq, out, n_real, frames)]
        pend: list = []
        done = False
        while not done:
            item = q.get()
            if item is sentinel:
                if producer_error:
                    raise producer_error[0]
                done = True
                if not pend:
                    break
            else:
                pend.append(item)
                if len(pend) < self.batch:
                    continue
            n_real = len(pend)
            while len(pend) < self.batch:          # pad the tail batch
                pend.append(pend[-1])
            ids = [p[0] for p in pend]
            # Latency runs from each frame's OWN enqueue, not the batch
            # head's (a slow producer would otherwise inflate frames 2..B
            # by the batch-fill time).
            t_enq = [p[3] for p in pend]
            t0 = time.perf_counter()
            batch = torch.stack([self._on_step_stream(p[1], p[2])
                                 for p in pend])
            out = self._step(batch)
            self.times.add("dispatch", time.perf_counter() - t0)
            in_flight.append((ids, t_enq, out, n_real,
                              batch if self._pruned else None))
            pend = []
            while len(in_flight) > max(self.prefetch // self.batch, 1):
                yield from self._finish_batch(*in_flight.pop(0))
        while in_flight:
            yield from self._finish_batch(*in_flight.pop(0))

    def _finish_batch(self, ids, t_enq, out, n_real, frames=None):
        t0 = time.perf_counter()
        packed = out.cpu().numpy()                 # ONE D2H copy per batch
        self.times.add("device_wait", time.perf_counter() - t0)
        for b in range(n_real):
            row = packed[b]
            if frames is not None:
                row = self._maybe_fallback(row, frames[b])
            res = self._unpack(ids[b], row, time.perf_counter() - t_enq[b])
            self.times.add("total_latency", res.latency_s)
            yield res

    def _unpack(self, frame_id: int, packed: np.ndarray,
                latency_s: float) -> StreamResult:
        pose = self.solve_pose
        return StreamResult(
            frame_id=frame_id,
            homography=packed[:9].reshape(3, 3),
            homography_ok=bool(packed[9] > 0),
            num_inliers=int(packed[10]),
            num_matches=int(packed[11]),
            num_keypoints=int(packed[12]),
            rvec=packed[13:16] if pose else None,
            tvec=packed[16:19] if pose else None,
            pose_ok=bool(packed[19] > 0) if pose else None,
            pose_num_inliers=int(packed[20]) if pose else None,
            latency_s=latency_s,
        )


def stream_localize(frames, db, camera: CameraModel,
                    config: PipelineConfig = PipelineConfig(),
                    solve_pose: bool = True, device=None):
    """Convenience: run the streaming localizer over an iterable and
    return (results, stage_times)."""
    s = StreamingLocalizer(db, camera, config, solve_pose, device=device)
    results = list(s.run(frames))
    return results, s.times
