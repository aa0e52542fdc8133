"""Application API: the run path over the port's engine.

Counterpart of the run path of ``dips_tpu/app.py``: a :class:`DiPsJob`
subset, the streaming loop :func:`stream_dips`, :func:`perform_dips` (video
in, diff-map video out, per-frame statistics back) and
:func:`run_dips_on_file`.  Decode runs on one worker thread feeding a
bounded ``queue.Queue`` (backpressure), so decode overlaps the device step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .errors import (DecodeError, FrameCallbackError, OutputPathError,
                     VideoPathError)
from .models import DiPsEngine
from .ops.reference import NUM_STATS
from .properties import DiPsProperties, Encoding

#: called once per processed frame with (frame_index, input_rgb, output_map,
#: stats_row); return None to keep the map or a uint8 array to replace it
FrameCallback = Callable[[int, np.ndarray, np.ndarray, np.ndarray],
                         Optional[np.ndarray]]

_EOS = object()
#: decoded frames queued ahead of the engine, in batches
_QUEUE_BATCHES = 4
#: a decoder silent this long (seconds) fails the run
_DECODE_STALL_S = 30.0


@dataclasses.dataclass
class DiPsJob:
    """Job configuration: pipeline properties plus endpoints."""

    properties: DiPsProperties = dataclasses.field(
        default_factory=DiPsProperties)
    video_path: Optional[str] = None
    output_path: Optional[str] = None
    encoding: Encoding = Encoding.MJPG
    frame_callback: Optional[FrameCallback] = None
    batch: int = 8
    #: "cuda", "cpu" or None (the card when present)
    device: Optional[str] = None
    #: a pre-opened reader to use instead of opening ``video_path``
    #: (stream_dips takes ownership and closes it)
    reader: Optional[object] = None
    #: run artifacts
    frame_geometry: Optional[tuple] = None
    engine: Optional[DiPsEngine] = None

    def with_encoding(self, e: "Encoding | str") -> "DiPsJob":
        e = Encoding[e.upper()] if isinstance(e, str) else e
        return dataclasses.replace(self, encoding=e)


def _decode_worker(reader, q: queue.Queue, stop: threading.Event,
                   errbox: list) -> None:
    """Decode thread: BGR frames into the bounded queue, then _EOS."""
    try:
        for frame in reader.iter_bgr():
            while not stop.is_set():
                try:
                    q.put(frame, timeout=0.1)
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
    a decode thread keeps the engine fed.  ``input_rgb`` is built only for
    a ``frame_callback`` (it costs a host pass per frame); else None."""
    if not job.video_path and job.reader is None:
        raise VideoPathError("no video path set (DiPsJob.video_path)")
    from .io.video import VideoReader
    reader = job.reader if job.reader is not None \
        else VideoReader(job.video_path)
    try:
        engine = DiPsEngine(job.properties, reader.height, reader.width,
                            batch=job.batch, device=job.device,
                            input_layout="hwc_bgr")
    except Exception:
        reader.close()
        raise
    job.engine = engine
    want_inputs = job.frame_callback is not None
    q: queue.Queue = queue.Queue(maxsize=_QUEUE_BATCHES * job.batch)
    stop = threading.Event()
    errbox: list = []
    worker = threading.Thread(target=_decode_worker,
                              args=(reader, q, stop, errbox), daemon=True)
    worker.start()
    idx = 0
    try:
        eos = False
        while not eos:
            buf = engine.new_batch_buffer()
            n = 0
            while n < job.batch:
                try:
                    item = q.get(timeout=_DECODE_STALL_S)
                except queue.Empty:
                    raise DecodeError("decode stalled (no frame for "
                                      f"{_DECODE_STALL_S} s)")
                if item is _EOS:
                    eos = True
                    break
                buf[n] = item
                n += 1
            if errbox:
                raise DecodeError(str(errbox[0])) from errbox[0]
            if not n:
                break
            inputs = ([np.ascontiguousarray(buf[i, :, :, ::-1])
                       for i in range(n)] if want_inputs else None)
            outs, stats = engine.collect(engine.dispatch_async(buf, n))
            for i in range(n):
                inp = inputs[i] if inputs is not None else None
                out = outs[i]
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
        worker.join(timeout=10.0)
        reader.close()


def perform_dips(job: DiPsJob) -> np.ndarray:
    """Run the job: input video -> diff-map video; returns the per-frame
    statistics (N, 4).  A map-suppressed pipeline (STATS_ONLY or
    ``emit_maps=False``) writes no video and needs no output path."""
    stats_only = job.properties.out_channels == 0
    if stats_only and job.output_path:
        raise OutputPathError("output_path set with a map-suppressed "
                              "pipeline (STATS_ONLY / emit_maps=False)")
    if not stats_only and not job.output_path:
        raise OutputPathError("no output path set (DiPsJob.output_path)")
    if not job.video_path:
        raise VideoPathError("no video path set")
    from .io.video import VideoReader, VideoWriter
    reader = VideoReader(job.video_path)
    fps, w, h = reader.fps, reader.width, reader.height
    caller_job = job
    job = dataclasses.replace(job, reader=reader)
    if stats_only:
        writer = contextlib.nullcontext()
        write = None
    else:
        try:
            writer = VideoWriter(job.output_path, fps, w, h, job.encoding)
        except Exception:
            reader.close()
            raise
        write = writer.write
    rows: List[np.ndarray] = []
    try:
        with writer:
            for _idx, _inp, out, stats in stream_dips(job):
                if write is not None:
                    write(out)
                rows.append(stats)
    finally:
        caller_job.frame_geometry = (h, w)
        caller_job.engine = job.engine
    return (np.stack(rows) if rows
            else np.zeros((0, NUM_STATS), np.float32))


def run_dips_on_file(input_path: str, output_path: Optional[str],
                     encoding: "Encoding | str" = Encoding.MJPG,
                     properties: Optional[DiPsProperties] = None,
                     refresh_markers: Sequence[int] = (),
                     batch: int = 8, device: Optional[str] = None
                     ) -> np.ndarray:
    """File in, diff-map video out; bare refresh markers re-capture the
    baseline mid-stream.  Returns the per-frame statistics."""
    props = properties or DiPsProperties()
    if refresh_markers:
        props = props.with_refresh_markers(
            tuple(props.refresh_markers) + tuple(refresh_markers))
    job = DiPsJob(properties=props, video_path=input_path,
                  output_path=output_path, batch=batch, device=device)
    return perform_dips(job.with_encoding(encoding))
