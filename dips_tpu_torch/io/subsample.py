"""Temporal subsampling utility (productized test_scripts/video_subsampler/
vid_sub_sampler.py:5-45: keep every Nth frame, retime to <= target seconds).
"""

from __future__ import annotations

from ..properties import Encoding
from .video import VideoReader, VideoWriter


def subsample_video(input_path: str, output_path: str, keep_every: int = 10,
                    target_seconds: float = 20.0,
                    encoding: Encoding = Encoding.MJPG) -> int:
    """Keep every ``keep_every``-th frame and retime so the result lasts at
    most ``target_seconds``.  Returns frames written."""
    if keep_every < 1:
        raise ValueError("keep_every must be >= 1")
    if target_seconds <= 0:
        raise ValueError("target_seconds must be > 0")
    # the writer needs fps (= kept count / target) up front, so count kept
    # frames from the container index; fall back to a counting pass when
    # the container has no reliable frame count — but never buffer the
    # whole video in memory (hours of 4K would OOM)
    with VideoReader(input_path) as probe:
        total = probe.frame_count
        h, w = probe.height, probe.width
        if total <= 0:
            total = sum(1 for _ in probe.iter_bgr())
    n_kept = (total + keep_every - 1) // keep_every
    if n_kept == 0:
        return 0
    fps = max(n_kept / target_seconds, 1.0)
    with VideoReader(input_path) as r, \
            VideoWriter(output_path, fps, w, h, encoding) as wr:
        # straight BGR-to-BGR transcode: skip the per-frame BGR->RGB->BGR
        # round trip (two full-frame conversions that cancel out)
        for i, f in enumerate(r.iter_bgr()):
            if i % keep_every == 0:
                wr.write_bgr(f)
        return wr.frames_written
