"""Application API: the run path over the port's engines.

Counterpart of ``dips_tpu/app.py``:

* :class:`DiPsJob`, the job builder (pipeline properties, endpoints and
  run options, and the run artifacts it receives);
* :func:`stream_dips`, the streaming loop: decode runs on one worker
  thread feeding a bounded ``queue.Queue`` (backpressure) with each frame
  beside its timestamp, so decode overlaps the device step;
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
decoded BGR bytes; "planar": the host does) pass through, and ``profile``
collects per-stage :class:`~dips_tpu_torch.utils.profiling.StageTimers`.
The post-analysis of ``ops/analysis.py`` runs on the engine's device:
``DiPsJob.denoise_radius`` low-passes the maps before the frame callback
sees them, and ``run_dips_on_files(flicker=)`` returns per-stream flicker
maps.  Media go through ``io/gstreamer.open_video`` / ``open_writer``
(OpenCV; the "gstreamer" backend is not ported and raises
``NotImplementedError``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import queue
import sys
import threading
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .errors import (DecodeError, FrameCallbackError, OutputPathError,
                     VideoPathError)
from .models import DiPsEngine
from .models.pipeline import analysis_geometry
from .ops.reference import NUM_STATS, planarize_host
from .properties import DiPsMethod, DiPsProperties, Encoding
from .utils.profiling import StageTimers

log = logging.getLogger("dips_tpu_torch")

#: called once per processed frame with (frame_index, input_rgb, output_map,
#: stats_row); return None to keep the map or a uint8 array to replace it
FrameCallback = Callable[[int, np.ndarray, np.ndarray, np.ndarray],
                         Optional[np.ndarray]]

_EOS = object()
#: how long a patient run (``decode_stall_s=None``) waits per poll
_PATIENT_POLL_S = 30.0


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
    #: media backend for decode and encode: "auto" or "opencv" ("gstreamer"
    #: is not ported and raises NotImplementedError)
    video_backend: str = "auto"
    #: decoded frames queued ahead of the engine, in batches (at least 2)
    queue_depth: int = 4
    #: collect per-stage timings (decode, h2d, dispatch, d2h, device,
    #: encode); populated on the job as ``job.timers`` after a run
    profile: bool = False
    timers: Optional[StageTimers] = None
    #: FFT low-pass post-analysis of the diff maps before they are yielded
    #: (ops/analysis.denoise_frames radius), on the engine's device
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
    #: THRESHOLD only: bit-pack masks on the device before the download
    #: (1/8 of the bytes; ops/wire.py).  Output is unchanged.
    packed_wire: bool = False
    #: "hwc" (default): the decoded BGR bytes go up as they are and the
    #: device lays them out; "planar": the host planarizes each frame
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


def _decode_worker(reader, q: queue.Queue, stop: threading.Event,
                   errbox: list, timers: Optional[StageTimers] = None
                   ) -> None:
    """Decode thread: (BGR frame, pts) pairs into the bounded queue, then
    _EOS, so no frame is ever dequeued without its timestamp.  With
    ``timers``, each decode counts in the "decode" stage (only this thread
    uses that stage)."""
    try:
        frames = reader.iter_bgr_timed()
        while True:
            if timers:
                with timers.stage("decode"):
                    item = next(frames, _EOS)
            else:
                item = next(frames, _EOS)
            if item is _EOS:
                break
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if stop.is_set():
                return
    except Exception as e:  # reported by the consumer
        errbox.append(e)
    finally:
        while not stop.is_set():
            try:
                q.put(_EOS, timeout=0.1)
                return
            except queue.Full:
                continue


def stream_dips(job: DiPsJob) -> Iterator[Tuple[int, Optional[np.ndarray],
                                                np.ndarray, np.ndarray]]:
    """Streaming loop: yields (frame_index, input_rgb, output, stats) while
    a decode thread keeps the engine fed; each frame's timestamp is
    appended to ``job.frame_pts`` before it is yielded.  ``input_rgb`` is
    the decoded frame when ``job.yield_inputs`` resolves true (explicitly,
    or because a ``frame_callback`` is set), else None."""
    if not job.video_path:
        raise VideoPathError("no video path set (DiPsJob.with_video_path)")
    if job.input_layout not in ("planar", "hwc"):
        raise ValueError(f"unknown input_layout {job.input_layout!r}")
    from .io.gstreamer import open_video
    reader = (job.reader if job.reader is not None
              else open_video(job.video_path, job.video_backend))
    try:
        # the device lays out the decoder's BGR bytes unless the host does
        host_planar = analysis_geometry(reader.height, reader.width,
                                        job.downscale,
                                        job.input_layout)[3] == "planar"
        engine = DiPsEngine(job.properties, reader.height, reader.width,
                            batch=job.batch, device=job.device,
                            input_layout=("planar" if host_planar
                                          else "hwc_bgr"),
                            packed_wire=job.packed_wire,
                            downscale=job.downscale)
    except Exception:
        reader.close()
        raise
    job.engine = engine  # run artifact: heatmap / state outlive the stream
    timers = StageTimers() if job.profile else None
    job.timers = engine.timers = timers
    job.frame_pts = []
    want_inputs = (job.yield_inputs if job.yield_inputs is not None
                   else job.frame_callback is not None)
    q: queue.Queue = queue.Queue(maxsize=max(2, job.queue_depth) * job.batch)
    stop = threading.Event()
    errbox: list = []
    worker = threading.Thread(target=_decode_worker,
                              args=(reader, q, stop, errbox, timers),
                              daemon=True)
    worker.start()
    patient = job.decode_stall_s is None
    wait_s = _PATIENT_POLL_S if patient else max(1e-3, job.decode_stall_s)
    tr = engine.tail_rows
    idx = 0
    try:
        eos = False
        while not eos:
            buf = engine.new_batch_buffer()
            inputs: Optional[list] = [] if want_inputs else None
            pts_batch = []
            n = 0
            while n < job.batch:
                try:
                    item = q.get(timeout=wait_s)
                except queue.Empty:
                    if n:
                        break  # a slow decoder: run what we have
                    if patient:  # a sparse live source: silence is normal
                        if errbox:
                            break
                        continue
                    raise DecodeError(
                        f"decode stalled (no frame for {wait_s:g} s; "
                        "decode_stall_s=None waits forever)")
                if item is _EOS:
                    eos = True
                    break
                frame, pts = item
                if host_planar:
                    buf[tr + n] = planarize_host(frame, engine.hp, engine.wp,
                                                 swap_rb=True)
                else:
                    buf[n] = frame
                if inputs is not None:
                    inputs.append(np.ascontiguousarray(frame[..., ::-1]))
                pts_batch.append(pts)
                n += 1
            if errbox:
                raise DecodeError(str(errbox[0])) from errbox[0]
            if not n:
                continue
            if timers:
                with timers.stage("device"):
                    outs, stats = engine.collect(engine.dispatch_async(buf,
                                                                       n))
                timers.add_frames(n)
            else:
                outs, stats = engine.collect(engine.dispatch_async(buf, n))
            if job.denoise_radius:
                from .ops.analysis import denoise_frames
                outs = denoise_frames(
                    torch.from_numpy(outs).to(engine.device),
                    int(job.denoise_radius)).cpu().numpy()
            for i in range(n):
                inp = inputs[i] if inputs is not None else None
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
    finally:
        stop.set()
        # join the decode thread before releasing its reader: cv2's
        # release() racing a read() on another thread is undefined
        worker.join(timeout=10.0)
        reader.close()


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
    from .io.gstreamer import open_video, open_writer
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
        if job.retime_vfr:
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

    The decoders yield cv2's BGR frames: with ``input_layout`` "hwc" the
    engine swaps them on the device, with "planar" the host planarizes
    them in RGB order.  ``downscale`` = k decimates every stream on the
    device and writes the videos at the analysis geometry.  The
    "gstreamer" video backend is not ported and raises
    ``NotImplementedError``.  ``mesh`` (``parallel.stream_mesh`` /
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
