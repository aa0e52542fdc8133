"""Host video ingest and egress over OpenCV.

Counterpart of ``dips_tpu/io/video.py`` (the reader and writer the run path
uses).  cv2 is imported inside the functions, so the package imports on a
machine without it.  Frames cross this boundary as uint8 (H, W, 3): the
reader yields cv2's BGR order (the engine swaps on the device,
``input_layout="hwc_bgr"``) and the writer takes RGB.
"""

from __future__ import annotations

import logging
import os
from typing import Iterator

import numpy as np

from ..errors import DecodeError, EncodeError, VideoPathError
from ..properties import Encoding


def _cv2():
    import cv2
    return cv2


class VideoReader:
    """Decodes a video file."""

    def __init__(self, path: str):
        cv2 = _cv2()
        if not os.path.exists(path):
            raise VideoPathError(f"input video not found: {path}")
        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise DecodeError(f"could not open video: {path}")
        self.path = path
        self.fps = float(self._cap.get(cv2.CAP_PROP_FPS)) or 30.0
        self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))

    def iter_bgr(self) -> Iterator[np.ndarray]:
        """Decoder-layout (BGR) frames."""
        while True:
            ok, frame = self._cap.read()
            if not ok:
                return
            yield frame

    def close(self) -> None:
        self._cap.release()


# Encoders OpenCV builds often lack, with a substitute.
_FOURCC_FALLBACK = {"H264": "MJPG", "RGBA": "HFYU"}


class VideoWriter:
    """RGB uint8 frames -> video file; falls back (with a warning) when a
    codec is unavailable."""

    def __init__(self, path: str, fps: float, width: int, height: int,
                 encoding: Encoding = Encoding.MJPG):
        cv2 = _cv2()
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
            logging.getLogger("dips_tpu_torch").warning(
                "encoder %s unavailable in this OpenCV build; writing %s "
                "to %s", encoding.name, alt, path)
        if not self._w.isOpened():
            raise EncodeError(
                f"could not open encoder {encoding.name} for {path}")

    def write(self, frame_rgb: np.ndarray) -> None:
        cv2 = _cv2()
        if frame_rgb.ndim == 2 or frame_rgb.shape[-1] == 1:
            frame_rgb = cv2.cvtColor(
                frame_rgb.reshape(frame_rgb.shape[0], frame_rgb.shape[1]),
                cv2.COLOR_GRAY2RGB)
        self._w.write(cv2.cvtColor(frame_rgb, cv2.COLOR_RGB2BGR))

    def close(self) -> None:
        self._w.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
