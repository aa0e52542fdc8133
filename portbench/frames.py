"""Seeded video frames: the traffic's content.

A pool of distinct frames made from the run's seed: a static noise
background, sensor noise of its own in every frame, and solid objects that
move a few pixels a frame along closed paths, so that consecutive frames
differ as in real video and the pool can be cycled without a jump.  The
pool lives in host memory, as a decoder's output would.  Every seed makes
frames of the same sizes and the same number of objects: only where they
lie and what colour they are changes.

Stream ``k`` of a cell reads frame ``i`` at ``pool[(i + k * offset) %
len(pool)]``, so the streams of one cell are offset from one another.
"""

from __future__ import annotations

import math

import numpy as np


def rng_of(seed: int, stream: int = 0) -> np.random.Generator:
    """A generator for any whole ``seed`` (negative and 64-bit ones too);
    ``stream`` separates independent draws from one seed."""
    return np.random.default_rng([seed % 2 ** 64, stream])


def make_pool(seed: int, height: int, width: int, traffic: dict
              ) -> np.ndarray:
    """(pool_size, H, W, 3) uint8 frames from ``seed`` and the cell's
    traffic parameters ``pool_size``, ``objects``, ``object_px`` (the
    smallest and largest side), ``speed_px`` (the most an object moves a
    frame) and ``sensor_noise`` (each channel moves by up to this much a
    frame)."""
    n = int(traffic["pool_size"])
    noise = int(traffic["sensor_noise"])
    rng = rng_of(seed)
    pool = np.empty((n, height, width, 3), np.uint8)
    pool[:] = rng.integers(noise, 256 - noise, (height, width, 3),
                           dtype=np.uint8)
    lo, hi = (int(v) for v in traffic["object_px"])
    for _ in range(int(traffic["objects"])):
        oh = int(rng.integers(lo, min(hi, height // 2) + 1))
        ow = int(rng.integers(lo, min(hi, width // 2) + 1))
        color = rng.integers(noise, 256 - noise, 3, dtype=np.uint8)
        # a closed path: the largest step of amplitude a is a * 2 pi / n
        amp = float(traffic["speed_px"]) * n / (2 * math.pi)
        ay, ax = min(amp, (height - oh) / 2), min(amp, (width - ow) / 2)
        cy = rng.uniform(ay, height - oh - ay)
        cx = rng.uniform(ax, width - ow - ax)
        phase = rng.uniform(0, 2 * math.pi)
        for i in range(n):
            t = 2 * math.pi * i / n + phase
            y = int(round(cy + ay * math.sin(t)))
            x = int(round(cx + ax * math.cos(t)))
            pool[i, y:y + oh, x:x + ow] = color
    if noise:
        for i in range(n):  # values stay in [0, 255]: no wrap
            pool[i] += rng.integers(0, 2 * noise + 1, (height, width, 3),
                                    dtype=np.uint8)
            pool[i] -= np.uint8(noise)
    return pool


def stream_offsets(n_streams: int, traffic: dict) -> list:
    """Each stream's offset into the pool."""
    return [k * int(traffic.get("stream_offset", 0)) for k in range(n_streams)]
