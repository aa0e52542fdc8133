"""Application API: the run path over the port's engines.

Counterpart of ``dips_tpu/app.py``:

* :class:`DiPsJob`, the job builder (pipeline properties, endpoints and
  run options, and the run artifacts it receives);
* :func:`stream_dips`, the streaming loop: decode runs on worker threads
  that stage each frame in a bounded ``native.FrameRing`` (backpressure),
  its timestamp in a deque beside it, so decode overlaps the device step;
  ``decode_workers`` > 1 splits a seekable file into contiguous chunks
  decoded in parallel and consumed in order, and ``pipeline_depth`` 2
  keeps one batch in flight on the device while the previous one is
  collected;
* :func:`perform_dips` (video in, diff-map video out, per-frame
  statistics back) with event-triggered recording
  (``io/eventrecorder.py``), adaptive baseline refresh
  (``ops/refresh.py``) and VFR retiming onto the writer's constant rate;
* :func:`run_dips_on_file`, :func:`custom_dips_on_files` (a directory of
  raw ``Dat_N.d`` dumps), :func:`run_dips_app` (the live preview of
  ``live.py``) and the fleet run :func:`run_dips_on_files` (many videos in
  lockstep through one :class:`MultiStreamEngine`).

The engine options ``packed_wire``, ``downscale`` (video written at the
analysis geometry) and ``input_layout`` ("hwc": the device lays out the
decoded bytes; "planar": the decode workers planarize with
``native.planarize``) pass through, and ``profile`` collects per-stage
:class:`~dips_tpu_torch.utils.profiling.StageTimers`.
The post-analysis of ``ops/analysis.py`` runs on the engine's device:
``DiPsJob.denoise_radius`` low-passes the engine's device maps before
their one download (``DiPsEngine(denoise_radius=)``), so the frame
callback sees them denoised, and ``run_dips_on_files(flicker=)`` returns
per-stream flicker maps.  Media go through ``io/gstreamer.open_video`` /
``open_writer``: OpenCV, or GStreamer (``video_backend="gstreamer"``, or
"auto" where ``io.gstreamer.available()``), whose readers decode to RGB
and whose writer carries each frame's timestamp.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import os
import sys
import threading
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .errors import (DecodeError, FrameCallbackError, OutputPathError,
                     VideoPathError)
from .models import DiPsEngine
from . import native
from .models.pipeline import analysis_geometry
from .ops.reference import NUM_STATS
from .properties import DiPsMethod, DiPsProperties, Encoding
from .utils.profiling import StageTimers

log = logging.getLogger("dips_tpu_torch")

#: called once per processed frame with (frame_index, input_rgb, output_map,
#: stats_row); return None to keep the map or a uint8 array to replace it
FrameCallback = Callable[[int, np.ndarray, np.ndarray, np.ndarray],
                         Optional[np.ndarray]]

#: how long a patient run (``decode_stall_s=None``) waits per poll (ms)
_PATIENT_POLL_MS = 30000


@dataclasses.dataclass
class DiPsJob:
    """Job configuration: pipeline properties plus endpoints and run
    options; :func:`perform_dips` fills in the run artifacts."""

    properties: DiPsProperties = dataclasses.field(
        default_factory=DiPsProperties)
    video_path: Optional[str] = None
    output_path: Optional[str] = None
    encoding: Encoding = Encoding.MJPG
    frame_callback: Optional[FrameCallback] = None
    batch: int = 8
    #: "cuda", "cuda:N" or "cpu"; without a card "cuda" raises
    #: DeviceError
    device: Optional[str] = "cuda"
    #: media backend for decode and encode: "opencv", "gstreamer" or
    #: "auto" (GStreamer where ``io.gstreamer.available()``, else OpenCV)
    video_backend: str = "auto"
    #: decoded frames staged ahead of the engine, in batches (at least 2)
    queue_depth: int = 4
    #: parallel decode workers over contiguous chunks of the file, consumed
    #: in order; needs a seekable reader with a frame count (AVI/MJPG),
    #: else one worker decodes
    decode_workers: int = 1
    #: collect per-stage timings (decode, h2d, dispatch, d2h, device,
    #: encode); populated on the job as ``job.timers`` after a run
    profile: bool = False
    timers: Optional[StageTimers] = None
    #: FFT low-pass post-analysis of the diff maps before they are yielded
    #: (ops/analysis.denoise_planes radius): the engine runs it on its
    #: device maps before their one download
    denoise_radius: Optional[int] = None
    #: duplicate / drop frames onto the writer's constant frame rate so a
    #: variable-frame-rate input keeps its timing; each frame's timestamp
    #: lands in ``frame_pts`` (a run artifact)
    retime_vfr: bool = False
    frame_pts: Optional[list] = None
    #: run artifact: (height, width) of the processed (analysis) video
    frame_geometry: Optional[tuple] = None
    #: run artifact: the engine that processed the stream (its heatmap and
    #: checkpoint state outlive the run)
    engine: Optional[DiPsEngine] = None
    #: event-triggered recording (io/eventrecorder.py): dict with ``dir``
    #: and optional ``pre_roll`` / ``post_roll`` frame counts and
    #: ``detector`` (MotionDetector kwargs); one clip per motion burst
    record_events: Optional[dict] = None
    #: run artifact: the recorded segments (span, frames, events, path)
    event_segments: Optional[list] = None
    #: adaptive baseline refresh (ops/refresh.BaselineRefreshPolicy
    #: kwargs; OVERALL only): ``threshold``, ``persist``, ``cooldown``
    #: (default persist + 2 * batch), ``metric``
    auto_refresh: Optional[dict] = None
    #: run artifact: frame indices where the auto-refresh policy fired
    baseline_refreshes: Optional[list] = None
    #: batches in flight on the device: 2 dispatches batch k+1 before batch
    #: k is collected, so the host's decode and encode overlap the device;
    #: 1 collects each batch as soon as it is dispatched
    pipeline_depth: int = 1
    #: THRESHOLD only: bit-pack masks on the device before the download
    #: (1/8 of the bytes; ops/wire.py).  Output is unchanged.  Not with
    #: ``denoise_radius``: the denoised maps come down unpacked
    packed_wire: bool = False
    #: "hwc" (default): the decoded bytes go up as they are and the device
    #: lays them out (and swaps BGR); "planar": the decode workers
    #: planarize each frame on the host (``native.planarize``)
    input_layout: str = "hwc"
    #: yield the decoded RGB input frame from :func:`stream_dips`; None =
    #: only when ``frame_callback`` is set (it costs a host pass a frame)
    yield_inputs: Optional[bool] = None
    #: fail when the decoder delivers nothing for this long (seconds);
    #: None waits forever (sparse live sources)
    decode_stall_s: Optional[float] = 30.0
    #: analyze (and write) at 1/k scale: the k x k box mean runs on the
    #: device; k must divide the input dimensions
    downscale: int = 1
    #: a pre-opened reader to use instead of opening ``video_path``
    #: (stream_dips takes ownership and closes it)
    reader: Optional[object] = None

    def with_video_path(self, p: str) -> "DiPsJob":
        return dataclasses.replace(self, video_path=p)

    def with_output_path(self, p: str) -> "DiPsJob":
        return dataclasses.replace(self, output_path=p)

    def with_encoding(self, e: "Encoding | str") -> "DiPsJob":
        e = Encoding[e.upper()] if isinstance(e, str) else e
        return dataclasses.replace(self, encoding=e)

    def with_frame_callback(self, cb: FrameCallback) -> "DiPsJob":
        return dataclasses.replace(self, frame_callback=cb)

    def with_properties(self, props: DiPsProperties) -> "DiPsJob":
        return dataclasses.replace(self, properties=props)

    def with_video_backend(self, b: str) -> "DiPsJob":
        return dataclasses.replace(self, video_backend=b)


def _decode_worker(reader, hp: int, wp: int, ring: native.FrameRing,
                   stop: threading.Event, errbox: list, pts_q,
                   timers: Optional[StageTimers] = None,
                   stage: str = "decode", limit: Optional[int] = None,
                   own_reader: bool = False, raw_hwc: bool = False) -> None:
    """Decode thread: each frame into the bounded ring, planarized on the
    host (``native.planarize``, which swaps BGR to RGB in the same pass)
    or, with ``raw_hwc``, as the decoder's bytes for the device to lay
    out.  Its timestamp goes into ``pts_q`` before the push, so no frame
    is popped without it.  ``limit`` bounds the frames decoded (a chunk
    of the parallel decode); ``stage`` names this worker's timers (a
    StageTimers stage is safe only when one thread writes it)."""
    # readers that decode to RGB (GStreamer) skip the BGR round trip
    rgb_native = getattr(reader, "native_rgb", False)
    it = reader.iter_rgb_timed() if rgb_native else reader.iter_bgr_timed()
    stage_pl = stage.replace("decode", "planarize")
    done = 0
    try:
        while limit is None or done < limit:
            with timers.stage(stage) if timers else contextlib.nullcontext():
                item = next(it, None)
            if item is None or stop.is_set():
                return
            frame, pts = item
            if raw_hwc:
                payload = np.ascontiguousarray(frame)
            else:
                with (timers.stage(stage_pl) if timers
                      else contextlib.nullcontext()):
                    payload = native.planarize(frame, hp, wp,
                                               swap_rb=not rgb_native)
            pts_q.append(pts)
            if not ring.push(payload):
                return
            done += 1
    except Exception as e:  # reported by the consumer
        errbox.append(e)
    finally:
        ring.close()
        if own_reader:
            reader.close()


class _RingChain:
    """Ordered consumption across the chunk rings: ``pop`` drains ring k
    (closed and empty) before it moves on to ring k + 1, so frames come
    out in order while later chunks decode in parallel."""

    def __init__(self, rings, pts_qs):
        self.rings = rings
        self.pts_qs = pts_qs
        self._k = 0
        self.last_pts = None

    @property
    def pops(self) -> int:
        """Frames popped from the rings so far."""
        return sum(r.pops for r in self.rings)

    @property
    def pooled_pops(self) -> int:
        """Of those, the frames the copy pool popped."""
        return sum(r.pooled_pops for r in self.rings)

    def pop(self, out: np.ndarray, timeout_ms: int) -> int:
        """0 with the frame in ``out`` (its timestamp in ``last_pts``), -1
        when every chunk is done, -2 on a timeout."""
        while self._k < len(self.rings):
            rc = self.rings[self._k].pop(out, timeout_ms=timeout_ms)
            if rc == 0:
                q = self.pts_qs[self._k]
                self.last_pts = q.popleft() if q else None
                return 0
            if rc == -1:  # this chunk is done: on to the next
                self._k += 1
                continue
            return rc
        return -1

    def close(self) -> None:
        for r in self.rings:
            r.close()


def _start_decode(job: DiPsJob, reader, hp: int, wp: int, slot_bytes: int,
                  raw_hwc: bool, stop: threading.Event, errbox: list,
                  timers: Optional[StageTimers]):
    """Start the decode workers: (the ring chain to pop from, the worker
    threads, the readers to close after the join).  ``decode_workers`` > 1
    over a seekable reader with a frame count closes ``reader`` and opens
    one reader per contiguous chunk, each owned by its worker."""
    from .io.gstreamer import open_video
    slots = max(2, job.queue_depth) * job.batch
    nw = max(1, int(job.decode_workers))
    total = getattr(reader, "frame_count", -1)
    if nw == 1 or not total or total <= 0 or not hasattr(reader,
                                                         "seek_frame"):
        ring = native.FrameRing(slots=slots, slot_bytes=slot_bytes)
        pts_q: collections.deque = collections.deque()
        worker = threading.Thread(
            target=_decode_worker, daemon=True,
            args=(reader, hp, wp, ring, stop, errbox, pts_q, timers,
                  "decode", None, False, raw_hwc))
        worker.start()
        return _RingChain([ring], [pts_q]), [worker], [reader]
    nw = min(nw, total)
    reader.close()
    per = total // nw
    bounds = [(k * per, per if k < nw - 1 else total - (nw - 1) * per)
              for k in range(nw)]
    rings = [native.FrameRing(slots=max(2, slots // nw),
                              slot_bytes=slot_bytes) for _ in range(nw)]
    pts_qs = [collections.deque() for _ in range(nw)]
    workers, opened = [], []
    try:
        for k, (start, count) in enumerate(bounds):
            rd = open_video(job.video_path, job.video_backend)
            opened.append(rd)
            rd.seek_frame(start)
            workers.append(threading.Thread(
                target=_decode_worker, daemon=True,
                args=(rd, hp, wp, rings[k], stop, errbox, pts_qs[k], timers,
                      f"decode{k or ''}", count, True, raw_hwc)))
    except BaseException:
        # a later chunk's open or seek failing must not leak the readers
        # already opened: no worker owns them yet
        for rd in opened:
            with contextlib.suppress(Exception):
                rd.close()
        raise
    for wk in workers:
        wk.start()
    return _RingChain(rings, pts_qs), workers, []


def stream_dips(job: DiPsJob) -> Iterator[Tuple[int, Optional[np.ndarray],
                                                np.ndarray, np.ndarray]]:
    """Streaming loop: yields (frame_index, input_rgb, output, stats) while
    the decode workers keep the engine fed; each frame's timestamp is
    appended to ``job.frame_pts`` before it is yielded.  ``input_rgb`` is
    the decoded frame when ``job.yield_inputs`` resolves true (explicitly,
    or because a ``frame_callback`` is set), else None.  Frames are popped
    straight into the engine's batch buffer, a batch's pops timed as stage
    ``ring_pop`` while the engine's timers are set (and counted in its
    ``staging``: ``pops``, ``pooled_pops``); with ``pipeline_depth`` 2 a
    batch is collected only after the next one was dispatched."""
    if not job.video_path:
        raise VideoPathError("no video path set (DiPsJob.with_video_path)")
    if job.input_layout not in ("planar", "hwc"):
        raise ValueError(f"unknown input_layout {job.input_layout!r}")
    from .io.gstreamer import open_video
    reader = (job.reader if job.reader is not None
              else open_video(job.video_path, job.video_backend))
    # readers that decode to RGB take the "hwc" layout, cv2's BGR "hwc_bgr"
    rgb_native = getattr(reader, "native_rgb", False)
    try:
        host_planar = analysis_geometry(reader.height, reader.width,
                                        job.downscale,
                                        job.input_layout)[3] == "planar"
        engine = DiPsEngine(job.properties, reader.height, reader.width,
                            batch=job.batch, device=job.device,
                            input_layout=("planar" if host_planar
                                          else "hwc" if rgb_native
                                          else "hwc_bgr"),
                            packed_wire=(job.packed_wire
                                         and not job.denoise_radius),
                            downscale=job.downscale,
                            denoise_radius=job.denoise_radius or None)
    except Exception:
        reader.close()
        raise
    job.engine = engine  # run artifact: heatmap / state outlive the stream
    timers = StageTimers() if job.profile else None
    job.timers = engine.timers = timers
    job.frame_pts = []
    want_inputs = (job.yield_inputs if job.yield_inputs is not None
                   else job.frame_callback is not None)
    hp, wp = engine.hp, engine.wp
    slot_bytes = (3 * hp * wp if host_planar
                  else reader.height * reader.width * 3)
    stop = threading.Event()
    errbox: list = []
    source, workers, readers = _start_decode(
        job, reader, hp, wp, slot_bytes, not host_planar, stop, errbox,
        timers)
    patient = job.decode_stall_s is None
    wait_ms = (_PATIENT_POLL_MS if patient
               else max(1, int(job.decode_stall_s * 1e3)))
    tr = engine.tail_rows
    h, w = engine.height, engine.width
    idx = 0

    def device():
        return timers.stage("device") if timers else contextlib.nullcontext()

    def inputs_of(buf, n):
        """The batch's RGB inputs, copied out of ``buf`` (None each when
        nobody reads them)."""
        if not want_inputs:
            return [None] * n
        if host_planar:
            return [native.interleave(buf[tr + i], h, w) for i in range(n)]
        if rgb_native:
            return [buf[i].copy() for i in range(n)]
        return [np.ascontiguousarray(buf[i][..., ::-1]) for i in range(n)]

    def emit(pending):
        """Collect a dispatched batch and yield its frames."""
        nonlocal idx
        handle, inputs, pts_batch = pending
        with device():
            outs, stats = engine.collect(handle)
        if timers:
            timers.add_frames(len(inputs))
        for i, inp in enumerate(inputs):
            out = outs[i]
            job.frame_pts.append(pts_batch[i])
            if job.frame_callback is not None:
                try:
                    repl = job.frame_callback(idx, inp, out, stats[i])
                except Exception as e:
                    raise FrameCallbackError(str(e)) from e
                if repl is not None:
                    out = repl
            yield idx, inp, out, stats[i]
            idx += 1

    try:
        overlap = int(job.pipeline_depth or 1) > 1
        pending = None
        eos = False
        while not eos:
            buf = engine.new_batch_buffer()
            pts_batch = []
            n = 0
            # the engine's timers as they are now: a caller may swap them
            pop_timers = engine.timers
            pops, pooled = source.pops, source.pooled_pops
            with (pop_timers.stage("ring_pop") if pop_timers
                  else contextlib.nullcontext()):
                while n < job.batch:
                    rc = source.pop(buf[tr + n], timeout_ms=wait_ms)
                    if rc == -1:
                        eos = True
                        break
                    if rc == -2:
                        if n:
                            break  # a slow decoder: run what we have
                        # a sparse live source: silence is normal
                        if patient:
                            if errbox:
                                break
                            continue
                        raise DecodeError(
                            f"decode stalled (no frame for "
                            f"{wait_ms / 1e3:g} s; decode_stall_s=None "
                            "waits forever)")
                    pts_batch.append(source.last_pts)
                    n += 1
            if pop_timers:
                engine.staging.pops += source.pops - pops
                engine.staging.pooled_pops += source.pooled_pops - pooled
            if errbox:
                raise DecodeError(str(errbox[0])) from errbox[0]
            if not n:
                continue
            with device():
                handle = engine.dispatch_async(buf, n)
            # nothing reads buf after this: the engine may hand it out
            # again as soon as its upload is done
            prev, pending = pending, (handle, inputs_of(buf, n), pts_batch)
            if prev is not None:
                yield from emit(prev)
            if not overlap:
                yield from emit(pending)
                pending = None
        if pending is not None:
            yield from emit(pending)
    finally:
        stop.set()
        source.close()
        # join the decode threads before releasing their readers: cv2's
        # release() racing a read() on another thread is undefined
        for wk in workers:
            wk.join(timeout=10.0)
        for r in readers:
            r.close()


def _event_recorder(job: DiPsJob, fps: float, h: int, w: int):
    """The EventRecorder of ``job.record_events`` (None when unset),
    writing one clip per motion burst into its ``dir``."""
    if not job.record_events:
        return None
    from .io.eventrecorder import EventRecorder
    from .io.gstreamer import open_writer
    from .ops.events import MotionDetector
    cfg = dict(job.record_events)
    rdir = cfg.pop("dir")
    os.makedirs(rdir, exist_ok=True)
    det_cfg = dict(cfg.pop("detector", {}) or {})
    if det_cfg.get("metric") == "changed_frac":
        det_cfg.setdefault("pixels", job.properties.analysis_pixels(h, w))
    det_cfg.setdefault("on_threshold", "auto")
    stem = os.path.splitext(os.path.basename(job.output_path))[0]

    def open_segment(i, start):
        p = os.path.join(rdir, f"{stem}.event{i:03d}_f{start}.avi")
        return open_writer(p, fps, w, h, job.encoding, job.video_backend)

    recorder = EventRecorder(MotionDetector(**det_cfg), open_segment,
                             pre_roll=cfg.pop("pre_roll", 30),
                             post_roll=cfg.pop("post_roll", 30))
    if cfg:
        raise ValueError(f"unknown record_events keys: {sorted(cfg)}")
    return recorder


def _refresh_policy(job: DiPsJob, h: int, w: int):
    """The BaselineRefreshPolicy of ``job.auto_refresh`` (None when
    unset)."""
    if job.auto_refresh is None:
        return None
    from .ops.refresh import BaselineRefreshPolicy
    if job.properties.method is not DiPsMethod.OVERALL:
        raise ValueError("auto_refresh re-pins the OVERALL baseline; "
                         "method=per_frame has none")
    cfg = dict(job.auto_refresh)
    if cfg.get("metric", "changed_frac") == "changed_frac":
        cfg.setdefault("pixels", job.properties.analysis_pixels(h, w))
    # the re-capture lands on the next dispatched batch: the frames of the
    # batch in hand still diff against the old baseline
    cfg.setdefault("cooldown", cfg.get("persist", 3) + 2 * job.batch)
    return BaselineRefreshPolicy(**cfg)


def perform_dips(job: DiPsJob) -> np.ndarray:
    """Run the job: input video -> diff-map video; returns the per-frame
    statistics (N, 4).

    With ``record_events`` the run also writes one clip per motion burst;
    with ``auto_refresh`` a wholesale scene change re-pins the baseline;
    with ``retime_vfr`` frames are duplicated or dropped onto the writer's
    constant rate.  The run artifacts (``timers``, ``frame_pts``,
    ``frame_geometry``, ``engine``, ``event_segments``,
    ``baseline_refreshes``) land on the caller's job, also when the run
    dies mid-stream, and an open event clip is closed then too.

    A map-suppressed pipeline (STATS_ONLY or ``emit_maps=False``) writes
    no video, needs no output path and takes neither ``record_events`` nor
    ``denoise_radius``.  A caller-provided ``job.reader`` (e.g. the CLI's
    ``--flicker-hz`` fps probe) is used instead of opening ``video_path``
    again."""
    stats_only = job.properties.out_channels == 0
    if stats_only:
        if job.output_path:
            raise OutputPathError(
                "output_path set with a map-suppressed pipeline "
                "(STATS_ONLY / emit_maps=False) — it writes no video "
                "(drop the output, or re-enable maps)")
        if job.record_events:
            raise ValueError(
                "record_events writes diff-map clips; a map-suppressed "
                "pipeline (STATS_ONLY / emit_maps=False) has no maps to "
                "record (use events/stats artifacts instead)")
        if job.denoise_radius:
            raise ValueError("denoise filters diff maps; a map-suppressed "
                             "pipeline (STATS_ONLY / emit_maps=False) has "
                             "none")
    elif not job.output_path:
        raise OutputPathError("no output path set (DiPsJob.with_output_path)")
    if not job.video_path:
        raise VideoPathError("no video path set")
    from .io.gstreamer import GstVideoWriter, open_video, open_writer
    from .io.video import CfrRetimer
    reader = (job.reader if job.reader is not None
              else open_video(job.video_path, job.video_backend))
    fps, w, h = reader.fps, reader.width, reader.height
    if job.downscale > 1:
        # the written video, event clips and pixel counts live at the
        # analysis geometry (the engine checks the same divisibility)
        k = int(job.downscale)
        if h % k or w % k:
            reader.close()
            raise ValueError(
                f"downscale {k} must divide the input geometry {h}x{w}")
        h, w = h // k, w // k
    caller_job = job
    job = dataclasses.replace(job, reader=reader)
    writer = retimer = None
    if not stats_only:
        try:
            writer = open_writer(job.output_path, fps, w, h, job.encoding,
                                 job.video_backend)
        except Exception:
            reader.close()
            raise
        # the GStreamer writer carries each frame's timestamp (VFR kept as
        # it is); OpenCV's writes a constant rate, retimed onto on request
        if job.retime_vfr and not isinstance(writer, GstVideoWriter):
            retimer = CfrRetimer(fps)
    try:  # a bad config must not leak the opened reader and writer
        recorder = _event_recorder(job, fps, h, w)
        refresher = _refresh_policy(job, h, w)
    except Exception:
        reader.close()
        if writer is not None:
            writer.close()
        raise

    def encode(out, pts):
        if isinstance(writer, GstVideoWriter):
            writer.write(out, pts=pts)
            return
        for f in ([out] if retimer is None else retimer.feed(out, pts)):
            writer.write(f)

    rows: List[np.ndarray] = []
    try:
        with writer if writer is not None else contextlib.nullcontext():
            for idx, _inp, out, stats in stream_dips(job):
                if writer is not None:
                    pts = job.frame_pts[-1]
                    if job.timers:
                        with job.timers.stage("encode"):
                            encode(out, pts)
                    else:
                        encode(out, pts)
                if recorder is not None:
                    recorder.feed(out, stats, idx)
                if refresher is not None and refresher.feed(idx, stats):
                    job.engine.snapshot()
                    log.info("auto-refresh: baseline re-capture requested "
                             "at frame %d", idx)
                rows.append(stats)
    finally:
        if recorder is not None:
            # any exit (a decode error, Ctrl-C on a camera) closes the open
            # segment, or the clip in progress would be unplayable
            job.event_segments = recorder.finish()
        caller_job.timers = job.timers
        caller_job.frame_pts = job.frame_pts
        caller_job.frame_geometry = (h, w)
        caller_job.engine = job.engine
        caller_job.event_segments = job.event_segments
        if refresher is not None:
            caller_job.baseline_refreshes = job.baseline_refreshes = list(
                refresher.refreshes)
    if job.timers:
        log.info("%s", job.timers)
    return (np.stack(rows) if rows
            else np.zeros((0, NUM_STATS), np.float32))


def run_dips_on_file(input_path: str, output_path: Optional[str],
                     encoding: "Encoding | str" = Encoding.MJPG,
                     properties: Optional[DiPsProperties] = None,
                     refresh_markers: Sequence[int] = (),
                     batch: int = 8, device: Optional[str] = "cuda",
                     video_backend: str = "auto",
                     packed_wire: bool = False, input_layout: str = "hwc",
                     downscale: int = 1, profile: bool = False
                     ) -> np.ndarray:
    """File in, diff-map video out; bare refresh markers re-capture the
    baseline mid-stream.  Returns the per-frame statistics.  The engine
    options are :class:`DiPsJob`'s."""
    props = properties or DiPsProperties()
    if refresh_markers:
        props = props.with_refresh_markers(
            tuple(props.refresh_markers) + tuple(refresh_markers))
    job = DiPsJob(properties=props, video_path=input_path,
                  output_path=output_path, batch=batch, device=device,
                  video_backend=video_backend, packed_wire=packed_wire,
                  input_layout=input_layout, downscale=downscale,
                  profile=profile)
    return perform_dips(job.with_encoding(encoding))


def init_frame_extractor() -> None:
    """Media-stack initialisation hook, kept for API parity: the OpenCV
    backend needs none."""


def init_thumbnail_extractor() -> None:
    """Parity hook; see :func:`init_frame_extractor`."""


def run_dips_app(properties: Optional[DiPsProperties] = None,
                 camera: int = 0, device: Optional[str] = "cuda") -> int:
    """Live webcam app: the preview loop of ``live.py``."""
    from .live import run_live
    return run_live(properties or DiPsProperties(), camera=camera,
                    device=device)


def custom_dips_on_files(data_dir: str, output_path: str,
                         width: int = 273, height: int = 640,
                         fps: float = 5.0,
                         properties: Optional[DiPsProperties] = None,
                         encoding: Encoding = Encoding.MJPG,
                         batch: int = 8, device: Optional[str] = "cuda",
                         show: bool = False) -> np.ndarray:
    """Raw ``Dat_N.d`` instrument-dump batch mode (``io/datfiles.py``;
    the geometry defaults are the dumps' 273 x 640, fps 5): every dump
    through one engine, one diff video out; returns the per-frame
    statistics.  The dumps are RGB, so the engine takes the "hwc" layout.

    ``show`` previews each diff map in a window while processing; skipped
    with a warning on a host without a display."""
    from .io.datfiles import read_dat_dir
    from .io.video import VideoWriter
    props = properties or DiPsProperties()
    frames = list(read_dat_dir(data_dir, width, height))
    if not frames:
        raise VideoPathError(f"no Dat_*.d files in {data_dir}")
    engine = DiPsEngine(props, height, width, batch=batch, device=device)
    preview = None
    if show:
        from .live import _to_bgr
        if not sys.platform.startswith("linux") or (
                os.environ.get("DISPLAY")
                or os.environ.get("WAYLAND_DISPLAY")):
            import cv2
            preview = (cv2, _to_bgr)
        else:
            log.warning("dat preview requested but no display; skipping")
    stats_rows = []
    with VideoWriter(output_path, fps, width, height, encoding) as writer:
        for i in range(0, len(frames), batch):
            outs, stats = engine.process_batch(frames[i:i + batch])
            for o in outs:
                writer.write(o)
                if preview is not None:
                    cv2, to_bgr = preview
                    cv2.imshow("DiPs dat", to_bgr(o))
                    cv2.waitKey(1)
            stats_rows.append(stats)
    if preview is not None:
        preview[0].destroyAllWindows()
    return np.concatenate(stats_rows)


def run_dips_on_files(input_paths: Sequence[str], output_dir: str,
                      encoding: "Encoding | str" = Encoding.MJPG,
                      properties: Optional[DiPsProperties] = None,
                      batch: int = 8, device: Optional[str] = "cuda",
                      input_layout: str = "hwc",
                      video_backend: str = "auto",
                      events: Optional[dict] = None,
                      collect_stats: bool = False,
                      downscale: int = 1,
                      auto_refresh: Optional[dict] = None,
                      flicker: Optional[dict] = None,
                      slab_impl: str = "bands", mesh=None):
    """Batched multi-stream differencing over many videos: decode the S
    files in lockstep, run them through one :class:`MultiStreamEngine`
    (one stacked launch per batch, or one per cell of ``mesh``), write one
    diff video per input.

    All inputs must share geometry and fps.  Streams shorter than the
    longest are fed empty lists once exhausted and their outputs truncated.
    Returns the per-stream frame counts (-1 for a stream that failed and
    was isolated), then, in this order and only when asked for:

    * ``events`` (MotionDetector kwargs, ops/events.py): one list of closed
      motion events per input;
    * ``collect_stats``: one (n_i, 4) stats array per input;
    * ``auto_refresh`` (BaselineRefreshPolicy kwargs, ops/refresh.py,
      OVERALL only): each stream's own adaptive baseline refresh, and one
      list of fired frame indices per input;
    * ``flicker`` (dict(freq_hz=..., tau_frames=None)): per-stream flicker
      maps from one :class:`~dips_tpu_torch.ops.analysis.
      FleetFlickerAnalyzer` on the engine's device, fps from the shared
      reader clock, fed the decoded RGB frames before any downscale: one
      (S, H_in, W_in) float32 array of amplitude maps at the input
      geometry (zero maps when no frame was decoded).

    The readers (OpenCV or GStreamer, ``video_backend``) are read in BGR
    order: with ``input_layout`` "hwc" the engine swaps the frames on the
    device, with "planar" the host planarizes them in RGB order.
    ``downscale`` = k decimates every stream on the device and writes the
    videos at the analysis geometry.  ``mesh`` (``parallel.stream_mesh`` /
    ``parallel.grid_mesh``) splits the fleet over devices, ``slab_impl``
    ("bands" / "extended") picks a 2-D grid's slab construction; the files
    written do not depend on either.
    """
    from .io.gstreamer import open_video, open_writer
    from .parallel import MultiStreamEngine
    props = properties or DiPsProperties()
    enc = Encoding[encoding.upper()] if isinstance(encoding, str) else encoding
    if input_layout not in ("planar", "hwc"):
        raise ValueError(f"unknown input_layout {input_layout!r}")
    if auto_refresh is not None and props.method is not DiPsMethod.OVERALL:
        raise ValueError("auto_refresh re-pins the OVERALL baseline; "
                         "method=per_frame has none")

    readers: list = []
    writers: list = []
    try:
        for p in input_paths:
            readers.append(open_video(p, video_backend))
        h, w, fps = readers[0].height, readers[0].width, readers[0].fps
        for r in readers[1:]:
            if (r.height, r.width) != (h, w):
                raise VideoPathError(
                    f"{r.path}: geometry {r.width}x{r.height} != {w}x{h} "
                    f"(multi-stream batches require uniform geometry)")
            if abs(r.fps - fps) > 0.51:
                raise VideoPathError(
                    f"{r.path}: fps {r.fps:g} != {fps:g} (multi-stream "
                    f"outputs share one clock; retime or process "
                    f"separately)")
        s = len(readers)
        planar = analysis_geometry(h, w, downscale,
                                   input_layout)[3] == "planar"
        eng = MultiStreamEngine(props, h, w, n_streams=s, batch=batch,
                                device=device,
                                input_layout="planar" if planar
                                else "hwc_bgr",
                                downscale=downscale, slab_impl=slab_impl,
                                mesh=mesh)
        # outputs, stats and events live at the analysis geometry; the
        # flicker maps at the input geometry
        h_in, w_in = h, w
        h, w = eng.height, eng.width
        stats_only = props.out_channels == 0
        if not stats_only:  # no diff videos, no writers at all
            os.makedirs(output_dir, exist_ok=True)
            # inputs sharing a basename must not overwrite each other's
            # output: disambiguate by stream index
            stems = [os.path.splitext(os.path.basename(p))[0]
                     for p in input_paths]
            dup = {t for t in stems if stems.count(t) > 1}
            for si, stem in enumerate(stems):
                name = (f"{stem}.{si}" if stem in dup else stem) + ".dips.avi"
                writers.append(open_writer(os.path.join(output_dir, name),
                                           fps, w, h, enc, video_backend))
        counts = np.zeros(s, np.int64)
        detectors = None
        if events is not None:
            from .ops.events import MotionDetector
            cfg = dict(events)
            if cfg.get("metric") == "changed_frac":
                cfg.setdefault("pixels", props.analysis_pixels(h, w))
            detectors = [MotionDetector(**cfg) for _ in range(s)]
            stream_events: list = [[] for _ in range(s)]
        refreshers = None
        if auto_refresh is not None:
            from .ops.refresh import BaselineRefreshPolicy
            rcfg = dict(auto_refresh)
            if rcfg.get("metric", "changed_frac") == "changed_frac":
                rcfg.setdefault("pixels", props.analysis_pixels(h, w))
            # the re-capture lands on the next batch
            rcfg.setdefault("cooldown", rcfg.get("persist", 3) + 2 * batch)
            refreshers = [BaselineRefreshPolicy(**rcfg) for _ in range(s)]
        stream_stats: Optional[list] = ([[] for _ in range(s)]
                                        if collect_stats else None)
        fleet_flicker = None
        if flicker is not None:
            from .ops.analysis import FleetFlickerAnalyzer
            fcfg = dict(flicker)
            fleet_flicker = FleetFlickerAnalyzer(s, chroma=props.chroma,
                                                 device=eng.device)
            fleet_flicker.configure_all(
                float(fcfg.pop("freq_hz")), fps,
                tau_frames=fcfg.pop("tau_frames", None))
            if fcfg:
                raise ValueError(f"unknown flicker options {sorted(fcfg)}")
        frames_in = [r.iter_bgr() for r in readers]
        done = [False] * s
        while not all(done):
            feeds = []
            for si in range(s):
                frames = []
                while not done[si] and len(frames) < batch:
                    f = next(frames_in[si], None)
                    if f is None:
                        done[si] = True
                    else:  # the planar host layout takes RGB
                        frames.append(f[..., ::-1] if planar else f)
                feeds.append(frames)
            if not any(feeds):
                break
            out, stats, _ = eng.process_batch(feeds)
            if fleet_flicker is not None:
                # the analyzer takes RGB; failed streams stop feeding
                # below, so they are gated off here too
                fleet_flicker.update(
                    [[] if si in eng.failed
                     else fd if planar else [f[..., ::-1] for f in fd]
                     for si, fd in enumerate(feeds)])
            for si in range(s):
                if si in eng.failed:
                    # isolated stream: stop decoding and writing it
                    if not done[si]:
                        log.warning("stream %d (%s) failed and was "
                                    "isolated: %s", si, input_paths[si],
                                    eng.failed[si])
                        done[si] = True
                    continue
                n = len(feeds[si])
                if not stats_only:
                    for k in range(n):
                        writers[si].write(out[si, k])
                counts[si] += n
                if detectors is not None and n:
                    stream_events[si] += detectors[si].update(
                        stats[si, :n],
                        start_index=eng.frame_cursors[si] - n)
                if refreshers is not None and n:
                    start = eng.frame_cursors[si] - n
                    if any([refreshers[si].feed(start + k, stats[si, k])
                            for k in range(n)]):
                        eng.snapshot(stream=si)
                        log.info("auto-refresh: stream %d baseline "
                                 "re-capture at frame %d", si,
                                 refreshers[si].refreshes[-1])
                if stream_stats is not None and n:
                    stream_stats[si].append(stats[si, :n])
    finally:
        for r in readers:
            r.close()
        for wr in writers:
            wr.close()
    for si in eng.failed:
        counts[si] = -1  # failed stream, output truncated
    result = [counts]
    if detectors is not None:
        for si in range(s):
            stream_events[si] += detectors[si].flush()  # EOS closes opens
        result.append(stream_events)
    if stream_stats is not None:
        result.append([np.concatenate(rows) if rows
                       else np.zeros((0, NUM_STATS), np.float32)
                       for rows in stream_stats])
    if refreshers is not None:
        result.append([list(r.refreshes) for r in refreshers])
    if fleet_flicker is not None:
        result.append(fleet_flicker.amplitudes()
                      if any(fleet_flicker.frames_seen)
                      else np.zeros((s, h_in, w_in), np.float32))
    return result[0] if len(result) == 1 else tuple(result)
