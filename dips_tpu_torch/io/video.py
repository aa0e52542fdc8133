"""Host video ingest and egress over OpenCV.

Counterpart of ``dips_tpu/io/video.py``.  cv2 is imported inside the
functions, so the package imports on a machine without it.  Frames cross
this boundary as uint8 (H, W, 3): ``read()`` / ``read_timed()`` /
iteration give RGB, ``iter_bgr()`` / ``iter_bgr_timed()`` give cv2's BGR
order (the engine swaps on the device, ``input_layout="hwc_bgr"``), and
the writer takes RGB (``write_bgr`` takes BGR).  Stream URIs
(``rtsp://``, ``srt://``, ...) open through OpenCV's FFmpeg support.
:class:`CfrRetimer` maps variable-frame-rate timestamps onto the writer's
constant rate.
"""

from __future__ import annotations

import logging
import os
from typing import Iterator, Optional

import numpy as np

from ..errors import DecodeError, EncodeError, VideoPathError
from ..properties import Encoding


def _cv2():
    import cv2
    return cv2


class VideoReader:
    """Decodes a video file or stream URI."""

    def __init__(self, path: str):
        from .gstreamer import is_stream_uri
        cv2 = _cv2()
        if not is_stream_uri(path) and not os.path.exists(path):
            raise VideoPathError(f"input video not found: {path}")
        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise DecodeError(f"could not open video: {path}")
        self.path = path
        self.fps = float(self._cap.get(cv2.CAP_PROP_FPS)) or 30.0
        self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.frame_count = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.last_pts: Optional[float] = None

    def __iter__(self) -> Iterator[np.ndarray]:
        """RGB frames."""
        while True:
            f = self.read()
            if f is None:
                return
            yield f

    def read(self) -> Optional[np.ndarray]:
        """The next frame in RGB, or None at the end; sets ``last_pts``."""
        ok, frame = self._cap.read()
        if not ok:
            return None
        self.last_pts = self._pts_of_last_read()
        return _cv2().cvtColor(frame, _cv2().COLOR_BGR2RGB)

    def _pts_of_last_read(self) -> Optional[float]:
        """Container timestamp (seconds) of the frame just decoded: cv2's
        FFmpeg backend sets POS_MSEC to it after each read."""
        ms = self._cap.get(_cv2().CAP_PROP_POS_MSEC)
        return ms / 1000.0 if ms >= 0 else None

    def seek_frame(self, index: int) -> None:
        """Position the decoder at frame ``index`` (exact for index-backed
        containers such as AVI/MJPG)."""
        self._cap.set(_cv2().CAP_PROP_POS_FRAMES, int(index))

    def read_timed(self):
        """(RGB frame, pts_seconds), or None at the end."""
        f = self.read()
        if f is None:
            return None
        return f, self.last_pts

    def iter_bgr(self) -> Iterator[np.ndarray]:
        """Decoder-layout (BGR) frames."""
        while True:
            ok, frame = self._cap.read()
            if not ok:
                return
            yield frame

    def iter_bgr_timed(self) -> Iterator[tuple]:
        """(BGR frame, pts_seconds) pairs."""
        while True:
            ok, frame = self._cap.read()
            if not ok:
                return
            yield frame, self._pts_of_last_read()

    def close(self) -> None:
        self._cap.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_camera(index: int = 0) -> VideoReader:
    """A reader over camera ``index``."""
    cv2 = _cv2()
    r = VideoReader.__new__(VideoReader)
    r._cap = cv2.VideoCapture(index)
    if not r._cap.isOpened():
        raise DecodeError(f"could not open camera {index}")
    r.path = f"camera:{index}"
    r.fps = float(r._cap.get(cv2.CAP_PROP_FPS)) or 30.0
    r.width = int(r._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    r.height = int(r._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    r.frame_count = -1
    r.last_pts = None
    return r


class CfrRetimer:
    """Map VFR source timestamps onto a constant-frame-rate write schedule.

    cv2's VideoWriter is CFR-only, so a VFR input written 1:1 would retime
    (drift) — the reference instead carries PTS through its GStreamer graph
    (frame_extractor.rs:242-262).  For CFR containers the equivalent is
    dup/drop scheduling: ``feed(frame, pts)`` returns how many copies to
    write so every frame's display time stays within half an output frame
    of its source PTS.  Frames without a PTS pass through 1:1.
    """

    def __init__(self, fps: float):
        self.fps = float(fps)
        self.written = 0
        self._t0: Optional[float] = None
        self._prev = None

    def feed(self, frame, pts: Optional[float]) -> list:
        """Frames to write now: gap slots hold the PREVIOUS frame (it was
        the one on screen), then the current frame lands on its own slot.
        A burst (two source frames mapping to one output slot) keeps the
        OLDER frame in the slot it already occupies; the newer frame is
        not written this call but becomes the gap-filler for subsequent
        slots (it is what's on screen from now on)."""
        if pts is None:
            self._prev = frame
            self.written += 1
            return [frame]
        if self._t0 is None:
            self._t0 = pts
        target = int(round((pts - self._t0) * self.fps))
        out = []
        while self.written < target:
            out.append(self._prev if self._prev is not None else frame)
            self.written += 1
        if target >= self.written:  # on schedule (burst -> dropped)
            out.append(frame)
            self.written += 1
        self._prev = frame
        return out


def retime_cfr(timed_frames, fps: float):
    """Generator over (frame, pts) pairs emitting a CFR stream at ``fps``
    (see :class:`CfrRetimer`)."""
    r = CfrRetimer(fps)
    for frame, pts in timed_frames:
        yield from r.feed(frame, pts)


# Encoders OpenCV builds often lack, with a substitute.
_FOURCC_FALLBACK = {"H264": "MJPG", "RGBA": "HFYU"}


class VideoWriter:
    """RGB uint8 frames -> video file; falls back (with a warning, and the
    substitute on ``fallback_used``) when a codec is unavailable."""

    def __init__(self, path: str, fps: float, width: int, height: int,
                 encoding: Encoding = Encoding.MJPG):
        cv2 = _cv2()
        self.path = path
        self.fallback_used: Optional[str] = None
        d = os.path.dirname(os.path.abspath(path))
        if not os.path.isdir(d):
            raise EncodeError(f"output directory missing: {d}")
        fourcc = encoding.fourcc
        self._w = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*fourcc), fps, (width, height))
        if not self._w.isOpened() and fourcc in _FOURCC_FALLBACK:
            alt = _FOURCC_FALLBACK[fourcc]
            self._w = cv2.VideoWriter(
                path, cv2.VideoWriter_fourcc(*alt), fps, (width, height))
            self.fallback_used = alt
            logging.getLogger("dips_tpu_torch").warning(
                "encoder %s unavailable in this OpenCV build; writing %s "
                "to %s", encoding.name, alt, path)
        if not self._w.isOpened():
            raise EncodeError(
                f"could not open encoder {encoding.name} for {path}")
        self.frames_written = 0

    def write(self, frame_rgb: np.ndarray) -> None:
        cv2 = _cv2()
        if frame_rgb.ndim == 2 or frame_rgb.shape[-1] == 1:
            frame_rgb = cv2.cvtColor(
                frame_rgb.reshape(frame_rgb.shape[0], frame_rgb.shape[1]),
                cv2.COLOR_GRAY2RGB)
        self._w.write(cv2.cvtColor(frame_rgb, cv2.COLOR_RGB2BGR))
        self.frames_written += 1

    def write_bgr(self, frame_bgr: np.ndarray) -> None:
        """Write a frame already in cv2's BGR order."""
        self._w.write(frame_bgr)
        self.frames_written += 1

    def close(self) -> None:
        self._w.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
