"""Synthetic clip generation for tests and benchmarks (the reference was
verified by eyeballing real videos — SURVEY.md §4; we generate deterministic
fixtures instead)."""

from __future__ import annotations

import numpy as np

from ..properties import Encoding
from .video import VideoWriter


def moving_square_clip(n: int = 16, height: int = 96, width: int = 128,
                       seed: int = 0, square: int = 8,
                       noise_high: int = 200) -> np.ndarray:
    """uint8 (n, H, W, 3): static noise background + a bright moving square
    (signal for both overall and per-frame modes)."""
    r = np.random.default_rng(seed)
    base = r.integers(0, noise_high, (height, width, 3), np.uint8)
    frames = np.empty((n, height, width, 3), np.uint8)
    for i in range(n):
        f = base.copy()
        y = (2 + 3 * i) % max(height - square, 1)
        x = (3 + 5 * i) % max(width - square, 1)
        f[y:y + square, x:x + square] = [255, 255, 255]
        frames[i] = f
    return frames


def write_clip(frames: np.ndarray, path: str, fps: float = 30.0,
               encoding: Encoding = Encoding.MJPG) -> str:
    """Write (n, H, W, 3) uint8 RGB frames to a video file; returns path."""
    n, h, w = frames.shape[:3]
    with VideoWriter(path, fps, w, h, encoding) as wr:
        for f in frames:
            wr.write(f)
    return path
