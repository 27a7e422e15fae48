"""Streaming attitude determination: continuous frame → pose (port of
pipelines/stream.py).

  * a producer thread decodes and preprocesses frame t+1 and uploads it
    (uint8, from pinned host memory, non-blocking on a side stream, an
    event marking its arrival) while the step runs on frame t;
  * the step takes a micro-batch of `batch` frames: the AKAZE front end
    runs on the whole batch (kernels A and B launched once per batch),
    then the match and geometry back half runs on the whole batch as one
    pass (the JAX package's vmap: one match of all the batch's queries —
    one kNN-2 kernel launch on a big DB — one RANSAC and one PnP-RANSAC),
    each frame drawing its RANSAC hypotheses as when served alone;
  * every scalar output of a frame is packed into ONE float32 vector
    (`_pack_outputs`, a [B, 21] block for a batch), so a batch costs one
    device-to-host copy;
  * a PrunedDeviceDb serves each frame through the spatial window; a
    frame whose coarse fix fails or whose window overflows reruns through
    the full-DB fallback, synchronously;
  * with a mesh, each batch runs the mesh-parallel serve step (frames
    over dp, the DB over tp; parallel.serve);
  * each batch's packed outputs land on the host when its own step ends:
    a non-blocking copy into a pinned slot of a small ring that the
    localizer owns, queued on the step's stream right after the step, and
    an event that marks its landing;
  * per-stage wall-clock stats, spans and counts (`StageTimes`) feed the
    cadence report: each frame's `wait` (enqueue to its batch's dispatch)
    and `hold` (its step's end to its yield), each batch's device `step`
    by CUDA events placed on the host clock once it has landed, what the
    consumer thread was doing (`frames`, `dispatch`, `device_wait`,
    `yielded`), the back half's `query_slots` and `live_keypoints`, and
    `readback_early`, the batches fetched because they had landed before
    anything forced them.

Up to `prefetch` frames' steps (`prefetch // batch` batches, at least one)
stay in flight, and a batch is fetched when its step has landed, or when
the in-flight limit forces it: before the consumer waits for a frame it
fetches every batch that has landed, and while it waits it takes
whichever comes first, the next frame or the oldest batch's landing. The
AKAZE front end reads nothing back to the host, so its launches run ahead
of the device, and the back half's constants and draws are uploaded once.
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
from cubesat_apds_tpu_torch.core.types import CameraModel, to_device, upload
from cubesat_apds_tpu_torch.ops.features.akaze import detect_and_compute_batch
from cubesat_apds_tpu_torch.pipelines.localize import (
    PrunedDeviceDb, back_half, localize_frame_pruned_fallback_jit,
    pruned_back_half, resident_db)
from cubesat_apds_tpu_torch.utils.profiling import (
    StageTimes, clock_drift_us, host_anchor)

_MARGIN = 0.25
# While batches are in flight, the consumer waits for a frame this long at
# a time between looks at the oldest batch's landing (s): the most a
# landed batch waits to be seen.
_POLL_S = 2e-4


def _pack_outputs(h, num_matches, num_keypoints, pose):
    """Every scalar output of a frame as ONE [21] float32 vector ([..., 21]
    for a batch): H (0–8), h_ok/h_inliers/matches/keypoints (9–12), rvec
    (13–15), tvec (16–18), pose_ok (19), pose_inliers (20) — the single
    definition of the packed layout; `_unpack` is its only reader."""
    lead = h.ok.shape

    def f(x):
        return torch.as_tensor(x).to(torch.float32).reshape(lead + (-1,))

    tail = [f(h.ok), f(h.num_inliers), f(num_matches), f(num_keypoints)]
    if pose is not None:
        tail += [f(pose.rvec), f(pose.tvec), f(pose.ok), f(pose.num_inliers)]
    else:
        tail += [torch.zeros(lead + (8,), dtype=torch.float32,
                             device=h.H.device)]
    return torch.cat([f(h.H)] + tail, dim=-1)


def _as_float(frames):
    """uint8 frames → float32 in [0, 1] (on the frames' device)."""
    if frames.dtype == torch.uint8:
        return frames.to(torch.float32) / 255.0
    return frames.to(torch.float32)


def _next(q, landing):
    """The next item of `q`; with `landing` (the oldest in-flight batch's
    event), None if that event completes first. The wait holds the
    interpreter lock only to look at the event, every _POLL_S."""
    if landing is None:
        return q.get()
    while True:
        try:
            return q.get(timeout=_POLL_S)
        except queue.Empty:
            if landing.query():
                return None


def _mark(stream):
    """A timing event recorded on `stream` now (None off the card)."""
    if stream is None:
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


@dataclasses.dataclass
class _Batch:
    """A batch in flight: what `_finish_batch` needs once its packed
    outputs have landed."""
    id: int
    ids: list              # its frames' ids, padded rows included
    t_enq: list            # each frame's enqueue (host clock)
    n_real: int
    host: torch.Tensor     # [B, 21] packed ([B, 23] pruned), on the host
    landed: Optional[torch.cuda.Event]   # on the card: `host` has landed
    frames: Optional[torch.Tensor]   # pruned: the batch, for a fallback
    slots: int             # the features' slots a frame (query slots)
    t_dispatch: float      # dispatch start (host clock)
    t_returned: float      # `_step` returned: the step's end on the CPU
    step: Optional[tuple]  # on the card: the step's (start, end) events
    front: Optional[torch.cuda.Event]   # on the card, off the mesh: the
                                        # front half's end in the step


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
    through the full-DB fallback (`fallback_frames` counts them). Up to
    `prefetch` frames' steps stay in flight; a batch is fetched when its
    step has landed, or when the in-flight limit forces it.

    `mesh` (parallel.mesh.make_mesh) serves every batch through the
    mesh-parallel step (parallel.serve.make_batch_localizer): frames over
    dp, the DB over tp — a DeviceDb is placed with shard_device_db, or
    pass a MeshDb placed already. The batch rounds up to a dp multiple,
    frames upload to this process's first slot, and every process gets
    the whole batch's results. Pruned serving does not compose with a
    mesh.
    """

    def __init__(self, db, camera: CameraModel,
                 config: PipelineConfig = PipelineConfig(),
                 solve_pose: bool = True, prefetch: int = 2,
                 transfer_uint8: bool = True, batch: int = 1,
                 mesh=None, device=None):
        self._pruned = isinstance(db, PrunedDeviceDb)
        self.mesh = mesh
        if mesh is not None:
            from cubesat_apds_tpu_torch.parallel.serve import (
                MeshDb, make_batch_localizer, shard_device_db)

            if self._pruned:
                raise ValueError(
                    "pruned streaming composes with micro-batching, not "
                    "with a mesh (the spatial window is a single-device "
                    "structure; shard the full DB over the mesh instead)")
            dp = mesh.shape["dp"]
            batch = dp * max(-(-int(batch) // dp), 1)
            self.device = mesh.home
            self.db = db if isinstance(db, MeshDb) else shard_device_db(
                mesh, db, match_config=config.match)
            self._serve = make_batch_localizer(mesh, camera, config,
                                               solve_pose=solve_pose)
        else:
            self.device = torch.device("cuda" if device is None else device)
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
        # Query slots a frame: the features' slots, which `_step` reads off
        # their shape (the mesh step's features, at the config's capacity,
        # stay inside it).
        self._slots = config.akaze.capacity
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        # On the card: the pinned slots the batches land in, one more than
        # the batches in flight; made at the first step, kept for every run.
        self._landing: list = []
        # On the card, off the mesh: the event `_step` recorded when its
        # front half returned.
        self._front_end = None

    # ---- the device step ------------------------------------------------

    def _step(self, frames):
        """frames [B, H, W] on the device → [B, 21] packed outputs; pruned,
        [B, 23]: coarse_ok (21) and overflow (22) appended. The front half
        and the back half each run once for the whole batch."""
        frames = _as_float(frames)
        if self.mesh is not None:
            homog, pose, n_match, n_kp = self._serve(frames, self.db)
            return _pack_outputs(homog, n_match, n_kp, pose)
        feats = detect_and_compute_batch(frames, self.config.akaze)
        if self._copy_stream is not None:
            self._front_end = _mark(torch.cuda.current_stream(self.device))
        self._slots = feats.descriptors.shape[-2]
        if self._pruned:
            pr = pruned_back_half(feats, tuple(frames.shape[1:]), self.db,
                                  self.camera, self.config, self.solve_pose,
                                  _MARGIN)
            r = pr.result
            flags = torch.stack([pr.coarse_ok, pr.overflow], dim=-1).float()
            return torch.cat([_pack_outputs(r.homography, r.num_matches,
                                            r.num_keypoints, r.pose),
                              flags], dim=-1)
        r = back_half(feats, self.db, self.camera, self.config,
                      self.solve_pose)
        return _pack_outputs(r.homography, r.num_matches, r.num_keypoints,
                             r.pose)

    def _maybe_fallback(self, packed: np.ndarray, frame) -> np.ndarray:
        """Pruned mode: rerun a coarse-miss / overflowed frame through
        the full-DB fallback (synchronous — rare by design)."""
        if not self._pruned or (packed[21] > 0 and packed[22] <= 0):
            return packed
        self.fallback_frames += 1
        t0 = time.perf_counter()
        r = localize_frame_pruned_fallback_jit(_as_float(frame), self.db,
                                               self.camera, self.config,
                                               self.solve_pose)
        out = torch.cat([_pack_outputs(r.homography, r.num_matches,
                                       r.num_keypoints, r.pose),
                         torch.tensor([1.0, 0.0], device=self.device)])
        packed = out.cpu().numpy()
        self.times.add("fallback", time.perf_counter() - t0)
        return packed

    def _land(self, out, stream, n: int):
        """Send batch `n`'s packed outputs to the host: on the card, a
        non-blocking copy into a pinned slot of the localizer's ring,
        queued on `stream` after the step (so no later step can overwrite
        `out` first), and an event recorded after it; off the card, `out`
        itself, landed already. Returns (the host tensor, the event or
        None)."""
        if stream is None:
            return out, None
        if not self._landing:
            self._landing = [torch.empty(out.shape, dtype=out.dtype,
                                         pin_memory=True) for _ in
                             range(max(self.prefetch // self.batch, 1) + 1)]
        host = self._landing[n % len(self._landing)]
        with torch.cuda.stream(stream):
            host.copy_(out, non_blocking=True)
        landed = torch.cuda.Event()
        landed.record(stream)
        return host, landed

    # ---- upload ---------------------------------------------------------

    def _upload(self, f: np.ndarray):
        """Host frame → (device tensor, event that marks its arrival or
        None). On the card: a pinned copy, sent non-blocking on the side
        stream."""
        host = torch.tensor(f)
        if self._copy_stream is None:
            return host.to(self.device), None
        with torch.cuda.stream(self._copy_stream):
            dev = upload(host, self.device)
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

        Every record goes to `self.times` as it stands at that moment, so
        a caller may swap in a fresh StageTimes between runs. On the card
        the run waits for the device twice: once at its start, to anchor
        the step's CUDA events to the host clock (and to know that no
        earlier run still writes the landing slots), and once when
        drained, to count the anchor's drift (`clock_drift_us`). Besides,
        a batch that the in-flight limit or the drain forces waits on its
        own landing event.
        """
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        producer_error: list = []
        if self._copy_stream is not None:
            anchor = host_anchor(self.device)
            step_stream = torch.cuda.current_stream(self.device)
        else:
            anchor = step_stream = None

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

        in_flight: list = []  # [_Batch]
        pend: list = []
        done = False
        n_batch = 0
        while not done:
            while in_flight and (in_flight[0].landed is None
                                 or in_flight[0].landed.query()):
                self.times.count("readback_early")
                yield from self._finish_batch(in_flight.pop(0), anchor)
            t = time.perf_counter()
            item = _next(q, in_flight[0].landed if in_flight else None)
            self.times.span("frames", t, time.perf_counter())
            if item is None:                  # the oldest batch landed
                continue
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
            uploaded = [self._on_step_stream(p[1], p[2]) for p in pend]
            start = _mark(step_stream)   # after the waits on the uploads
            batch = torch.stack(uploaded)
            out = self._step(batch)
            t_returned = time.perf_counter()
            self.times.stage("dispatch", t0, t_returned)
            self.times.count("front_pixels", batch.numel())
            step = None if start is None else (start, _mark(step_stream))
            host, landed = self._land(out, step_stream, n_batch)
            in_flight.append(_Batch(
                id=n_batch, ids=ids, t_enq=t_enq, n_real=n_real, host=host,
                landed=landed,
                frames=batch if self._pruned else None, slots=self._slots,
                t_dispatch=t0, t_returned=t_returned, step=step,
                front=self._front_end))
            n_batch += 1
            pend = []
            while len(in_flight) > max(self.prefetch // self.batch, 1):
                yield from self._finish_batch(in_flight.pop(0), anchor)
        while in_flight:
            yield from self._finish_batch(in_flight.pop(0), anchor)
        if anchor is not None:
            self.times.count("clock_drift_us",
                             round(clock_drift_us(anchor, self.device)))

    def _finish_batch(self, b: _Batch, anchor):
        t0 = time.perf_counter()
        if b.landed is not None:
            b.landed.synchronize()
        packed = b.host.numpy().copy()       # frees the slot for a later batch
        self.times.stage("device_wait", t0, time.perf_counter())
        step_end = (b.t_returned if b.step is None else
                    self.times.device_span("step", anchor, *b.step, id=b.id))
        if b.front is not None:
            self.times.device_span("front", anchor, b.step[0], b.front,
                                   id=b.id)
        self.times.count("query_slots", len(b.ids) * b.slots)
        for i in range(b.n_real):
            row = packed[i]
            if b.frames is not None:
                row = self._maybe_fallback(row, b.frames[i])
            t = time.perf_counter()
            res = self._unpack(b.ids[i], row, t - b.t_enq[i])
            self.times.add("total_latency", res.latency_s)
            self.times.count("live_keypoints", res.num_keypoints)
            self.times.span("wait", b.t_enq[i], b.t_dispatch, b.ids[i], b.id)
            self.times.span("hold", step_end, t, b.ids[i], b.id)
            yield res
            self.times.span("yielded", t, time.perf_counter())

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
