"""The k x k box mean of the on-card decimation (``--downscale K``) in
plain NumPy.

A frozen copy of the port's host twin of its device decimation
(``reference.pool_frame_host`` of ``dips_tpu_torch/ops/reference.py``):
each channel's exact integer sum over the k x k block, times
float32(1/k^2), rounded half to even.  A downscaled cell's reference is
this pool followed by the pipeline of :mod:`.dips` at the analysis size.
It imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np


def pool_frame(frame: np.ndarray, k: int) -> np.ndarray:
    """uint8 (H*k, W*k, C) -> uint8 (H, W, C)."""
    h, w, c = frame.shape
    s = frame.astype(np.int32).reshape(h // k, k, w // k, k, c)
    s = s.sum(axis=(1, 3), dtype=np.int32)
    v = np.rint(s.astype(np.float32) * np.float32(1.0 / (k * k)))
    return v.astype(np.int32).astype(np.uint8)


def pool_frames(frames: np.ndarray, k: int, mapper=map) -> np.ndarray:
    """uint8 (n, H*k, W*k, C) -> uint8 (n, H, W, C), frame by frame;
    ``mapper`` may run the frames in parallel."""
    return np.stack(list(mapper(lambda f: pool_frame(f, k), list(frames))))
