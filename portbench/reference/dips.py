"""DiPs pixel arithmetic in plain NumPy, and a stream's replay.

A frozen copy of the oracle arithmetic for the two pipelines the benchmark
runs, OVERALL method only (the baseline is captured at frame 0):

* ABSDIFF: per-channel ``|frame - baseline|`` on the raw uint8 frames,
  byte-equal to ``cv2.absdiff``.  Stats are the channel-mean signed and
  absolute sums over ``3 * H * W * 255``, the largest byte over 255 and the
  count of pixels whose largest channel difference reaches the change
  threshold; the heatmap adds ``sum_c |d| / 765`` a frame.
* COLORIZE: intensity ``max + min`` of the channels on the integer scale
  [0, 510]; an exact ``w x w`` spatial median with zero padding; the
  upper temporal median of the last ``T`` filtered planes (the ring starts
  as ``T`` copies of frame 0); ``raw = (baseline - cur) / 510``; the
  sigmoid emphasis ``(1 / (1 + exp(-k raw / 2)) - 1/2) * sensitivity``;
  red for negative, green for positive; round half to even.  Frame 0
  renders the baseline grey with zero stats.  Stats are the mean, the
  mean and largest ``|raw|`` and the count of ``|raw| >= thr / 255``;
  the heatmap adds ``|raw|`` a frame.

The heatmap is accumulated frame by frame in float32, in the stream's
order, as the pipeline defines it.

``precision`` selects the arithmetic: "full" is the pipeline as stated
(uint8 data, float32 arithmetic); the controls compute the same in the
next precision below it: "int4" keeps 4 bits of each uint8 channel,
"bf16" rounds every float32 result to bfloat16.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

NUM_STATS = 4
#: the integer intensity scale [0, 510] -> [0, 1]
INTENSITY_SCALE = np.float32(1.0 / 510.0)
#: rows of the heatmap accumulated at a time (the block stays in cache)
_HEAT_ROWS = 64


@dataclass(frozen=True)
class Params:
    """The pipeline of one configuration."""
    output: str                 # "ABSDIFF" or "COLORIZE"
    window: int = 3             # spatial median window (COLORIZE)
    temporal: int = 4           # temporal median length (COLORIZE)
    sigmoid: float = 5.0        # sigmoid horizontal scalar k
    sensitivity: float = 5.0
    change_threshold: int = 10
    precision: str = "full"     # "full", "int4" or "bf16"


def params_from_config(cfg: dict, precision: str = "full") -> Params:
    """Params of a configuration file's ``pipeline`` block."""
    p = cfg["pipeline"]
    if p["method"] != "OVERALL":
        raise ValueError(f"the reference holds the OVERALL method only, "
                         f"not {p['method']!r}")
    if p["output"] not in ("ABSDIFF", "COLORIZE"):
        raise ValueError(f"no reference for output {p['output']!r}")
    if p["output"] == "COLORIZE" and (p["filter"] != "SIGMOID"
                                      or p["chroma"] != "ALL"):
        raise ValueError("the COLORIZE reference holds the sigmoid filter "
                         "on all channels only")
    return Params(output=p["output"], window=int(p["window_size"]),
                  temporal=int(p["temporal_size"]),
                  sigmoid=float(p["sigmoid_horizontal_scalar"]),
                  sensitivity=float(p["sensitivity"]),
                  change_threshold=int(p["change_threshold"]),
                  precision=precision)


# -- precision of the controls ----------------------------------------------

def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bfloat16 value (ties to even), as float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    r = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return r.view(np.float32)


def _round(x, precision: str):
    x = np.asarray(x, np.float32)
    return _bf16(x) if precision == "bf16" else x


def _frame_data(frame: np.ndarray, precision: str) -> np.ndarray:
    """The uint8 frame as the arithmetic sees it."""
    if precision == "int4":
        return (frame >> 4) << 4
    return frame


# -- ABSDIFF ----------------------------------------------------------------

def absdiff_frame(frame: np.ndarray, baseline: np.ndarray,
                  change_threshold: int, precision: str = "full"
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """uint8 (H, W, 3) frame and baseline -> (map uint8 (H, W, 3), stats
    float32 (4,), heatmap term float32 (H, W))."""
    f = _frame_data(frame, precision)
    b = _frame_data(baseline, precision)
    d = np.maximum(f, b) - np.minimum(f, b)  # |f - b|, exact in uint8
    h, w = frame.shape[:2]
    sum_signed = int(b.sum(dtype=np.int64)) - int(f.sum(dtype=np.int64))
    sum_abs = int(d.sum(dtype=np.int64))
    dmax = np.maximum(np.maximum(d[..., 0], d[..., 1]), d[..., 2])
    inv = np.float32(1.0) / np.float32(3 * h * w * 255)
    stats = np.array([np.float32(sum_signed) * inv,
                      np.float32(sum_abs) * inv,
                      np.float32(int(dmax.max())) * np.float32(1 / 255.0),
                      np.count_nonzero(dmax >= np.uint8(change_threshold))],
                     np.float32)
    return d, stats, _absdiff_term(d)


def absdiff_term(frame: np.ndarray, baseline: np.ndarray,
                 precision: str = "full") -> np.ndarray:
    """The heatmap term of :func:`absdiff_frame` alone."""
    f = _frame_data(frame, precision)
    b = _frame_data(baseline, precision)
    return _absdiff_term(np.maximum(f, b) - np.minimum(f, b))


def _absdiff_term(d: np.ndarray) -> np.ndarray:
    # the channel sum is exact in float32 (integers up to 765)
    s = d[..., 0].astype(np.float32) + d[..., 1] + d[..., 2]
    return s * np.float32(1.0 / (3 * 255.0))


# -- COLORIZE ---------------------------------------------------------------

def filtered_plane(frame: np.ndarray, window: int, precision: str = "full"
                   ) -> np.ndarray:
    """uint8 (H, W, 3) -> float32 (H, W): the intensity ``max + min`` of
    the channels (integers in [0, 510]) through the exact ``window`` x
    ``window`` median, taps outside the image zero."""
    c = [frame[..., k] for k in range(3)]
    mx = np.maximum(np.maximum(c[0], c[1]), c[2])
    mn = np.minimum(np.minimum(c[0], c[1]), c[2])
    plane = _round(mx.astype(np.float32) + mn, precision)
    if window <= 1:
        return plane
    h, w = plane.shape
    p = window // 2
    padded = np.zeros((h + 2 * p, w + 2 * p), np.float32)
    padded[p:p + h, p:p + w] = plane
    if window == 3:
        return _median3x3(padded)
    taps = np.stack([padded[dy:dy + h, dx:dx + w] for dy in range(window)
                     for dx in range(window)], axis=-1)
    k = (window * window) // 2
    return np.partition(taps, k, axis=-1)[..., k]


def _med3(a, b, c):
    """The median of three arrays, element by element."""
    return np.maximum(np.minimum(a, b), np.minimum(np.maximum(a, b), c))


def _median3x3(padded: np.ndarray) -> np.ndarray:
    """The exact median of each 3 x 3 window of a zero-padded plane: with
    each window's three columns sorted, it is the median of the largest
    column minimum, the median column median and the smallest column
    maximum (exact for 3 x 3; tested against a full sort)."""
    a, b, c = padded[:-2], padded[1:-1], padded[2:]
    lo = np.minimum(np.minimum(a, b), c)
    hi = np.maximum(np.maximum(a, b), c)
    mid = _med3(a, b, c)
    left, centre, right = slice(0, -2), slice(1, -1), slice(2, None)
    return _med3(
        np.maximum(np.maximum(lo[:, left], lo[:, centre]), lo[:, right]),
        _med3(mid[:, left], mid[:, centre], mid[:, right]),
        np.minimum(np.minimum(hi[:, left], hi[:, centre]), hi[:, right]))


def temporal_median(planes) -> np.ndarray:
    """T planes (H, W) -> (H, W): index T // 2 of the sorted values (the
    upper median for even T)."""
    t = len(planes)
    if t == 1:
        return planes[0]
    if t == 4:  # the third smallest of four: from two sorted pairs
        a, b, c, d = planes
        return np.maximum(np.maximum(np.minimum(a, b), np.minimum(c, d)),
                          np.minimum(np.maximum(a, b), np.maximum(c, d)))
    return np.partition(np.stack(planes), t // 2, axis=0)[t // 2]


def colorize_frame(cur: np.ndarray, baseline: np.ndarray, prm: Params
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Filtered, temporally median plane ``cur`` and the ``baseline``
    plane (both on the integer scale) -> (map uint8 (H, W, 3), stats
    float32 (4,), heatmap term float32 (H, W))."""
    pr = prm.precision
    raw = _raw_diff(cur, baseline, pr)
    a = np.abs(raw)
    thr = np.float32(prm.change_threshold) / np.float32(255.0)
    stats = np.array([np.float32(raw.mean(dtype=np.float64)),
                      np.float32(a.mean(dtype=np.float64)),
                      a.max(), np.count_nonzero(a >= thr)], np.float32)
    d = _round(raw * np.float32(0.5), pr)
    k = np.float32(prm.sigmoid)
    e = _round(np.exp(_round(-k * d, pr)), pr)
    d = _round(np.float32(1.0) / _round(np.float32(1.0) + e, pr), pr)
    d = _round(_round(d - np.float32(0.5), pr) * np.float32(prm.sensitivity),
               pr)
    s = np.abs(d)
    half = _round(s * np.float32(0.5), pr)
    hi = _round(np.float32(0.5) + half, pr)
    lo = _round(np.float32(0.5) - half, pr)
    neg = d < 0
    rgb = np.stack([np.where(neg, hi, lo), np.where(neg, lo, hi), lo],
                   axis=-1)
    return _quantize(rgb, pr), stats, a


def _raw_diff(cur: np.ndarray, baseline: np.ndarray, precision: str
              ) -> np.ndarray:
    """(baseline - cur) / 510: one rounding of an exact integer
    difference."""
    return _round((baseline - cur).astype(np.float32) * INTENSITY_SCALE,
                  precision)


def capture_frame(cur: np.ndarray, prm: Params
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A capture frame's (grey baseline map, zero stats, zero term)."""
    disp = _round(cur * INTENSITY_SCALE, prm.precision)
    grey = _quantize(np.repeat(disp[..., None], 3, axis=-1), prm.precision)
    return (grey, np.zeros((NUM_STATS,), np.float32),
            np.zeros(cur.shape, np.float32))


def _quantize(x: np.ndarray, precision: str) -> np.ndarray:
    """float32 [0, 1] -> uint8, round half to even."""
    return np.rint(_round(np.clip(x, 0.0, 1.0) * np.float32(255.0),
                          precision)).astype(np.uint8)


# -- a stream's replay ------------------------------------------------------

def pool_planes(pool: np.ndarray, prm: Params, mapper=map) -> dict:
    """The filtered plane of every pool frame (COLORIZE), in the form a
    :class:`StreamReplay` caches them; ``mapper`` may run them in
    parallel."""
    if prm.output != "COLORIZE":
        return {}
    planes = mapper(lambda f: filtered_plane(f, prm.window, prm.precision),
                    list(pool))
    return {(j, prm.precision): p for j, p in enumerate(planes)}


class StreamReplay:
    """One stream of the benchmark's traffic worked out again from its
    frames: frame ``i`` of the stream is ``pool[(i + offset) % len(pool)]``,
    and frame 0 is the baseline capture.

    ``planes`` may be shared between replays of one pool: it caches the
    filtered plane of each pool frame (COLORIZE)."""

    def __init__(self, pool: np.ndarray, offset: int, prm: Params,
                 planes: Optional[Dict[int, np.ndarray]] = None):
        self.pool, self.offset, self.prm = pool, int(offset), prm
        self.planes = {} if planes is None else planes
        self._terms: Dict[object, np.ndarray] = {}

    def _pool_index(self, i: int) -> int:
        return (i + self.offset) % len(self.pool)

    def frame(self, i: int) -> np.ndarray:
        return self.pool[self._pool_index(i)]

    def _plane(self, i: int) -> np.ndarray:
        j = self._pool_index(max(i, 0))  # the ring starts as T x frame 0
        key = (j, self.prm.precision)
        if key not in self.planes:
            self.planes[key] = filtered_plane(self.pool[j], self.prm.window,
                                              self.prm.precision)
        return self.planes[key]

    def _cur(self, i: int) -> np.ndarray:
        t = self.prm.temporal
        return temporal_median([self._plane(i - k)
                                for k in range(t - 1, -1, -1)])

    def baseline(self) -> np.ndarray:
        """The carried baseline: frame 0 (ABSDIFF, uint8 (H, W, 3)) or its
        filtered plane (COLORIZE, float32 (H, W))."""
        if self.prm.output == "ABSDIFF":
            return self.frame(0)
        if "base" not in self._terms:
            self._terms["base"] = self._cur(0)
        return self._terms["base"]

    def output(self, i: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(map, stats, heatmap term) of frame ``i``."""
        prm = self.prm
        if prm.output == "ABSDIFF":
            return absdiff_frame(self.frame(i), self.frame(0),
                                 prm.change_threshold, prm.precision)
        if i == 0:
            return capture_frame(self.baseline(), prm)
        return colorize_frame(self._cur(i), self.baseline(), prm)

    def _term_key(self, i: int):
        """Frames whose heatmap terms are equal share a key: past the
        ring's first fill a term depends on the pool position alone."""
        warm = 0 if self.prm.output == "ABSDIFF" else self.prm.temporal - 1
        return i if i < warm else ("pool", self._pool_index(i))

    def _term(self, i: int) -> np.ndarray:
        """Frame ``i``'s heatmap term, as :meth:`output` computes it."""
        key = self._term_key(i)
        if key not in self._terms:
            prm = self.prm
            if prm.output == "ABSDIFF":
                term = absdiff_term(self.frame(i), self.frame(0),
                                    prm.precision)
            elif i == 0:
                term = np.zeros(self.pool.shape[1:3], np.float32)
            else:
                term = np.abs(_raw_diff(self._cur(i), self.baseline(),
                                        prm.precision))
            self._terms[key] = term
        return self._terms[key]

    def heatmap(self, n: int) -> np.ndarray:
        """The heatmap after frames 0 .. n-1, each frame's term added in
        float32 in order (frame by frame, a block of rows at a time)."""
        terms = [self._term(i) for i in range(n)]
        h, w = self.pool.shape[1:3]
        heat = np.zeros((h, w), np.float32)
        bf = self.prm.precision == "bf16"
        for r0 in range(0, h, _HEAT_ROWS):
            blk = heat[r0:r0 + _HEAT_ROWS]
            for a in terms:
                np.add(blk, a[r0:r0 + _HEAT_ROWS], out=blk)
                if bf:
                    blk[...] = _bf16(blk)
        return heat

    def outputs(self, frames: Iterable[int]
                ) -> Tuple[np.ndarray, np.ndarray]:
        """(maps (n, H, W, 3), stats (n, 4)) of the given frame indices."""
        res = [self.output(i)[:2] for i in frames]
        return (np.stack([m for m, _ in res]),
                np.stack([s for _, s in res]))
