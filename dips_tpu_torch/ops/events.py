"""Motion-event segmentation over the per-frame statistics stream.

The pipeline already reduces every frame to four scalars on device
(``ops/oracle.STAT_NAMES``: mean diff, mean |diff|, max |diff|, changed
pixel count).  This module turns that stream into discrete MOTION EVENTS
— "something moved between frames 120 and 213, peaking at X" — with
hysteresis and debouncing, so a camera fleet can alert/record on events
instead of shipping every diff map.

Host-side by design: the detector consumes the tiny (B, 4) stats arrays
the engine already downloads — no extra device work, no extra transfer —
and is therefore identical across single-chip, multi-stream, and
multi-host engines.  (The reference has no analogue; its closest feature
is eyeballing the live overlay, dips_alt/src/lib.rs.)

Segmentation rules (classic two-threshold hysteresis + debounce):

* an event OPENS when the chosen metric rises to ``on >= on_threshold``;
* it CLOSES when the metric falls below ``off_threshold`` (default
  ``on_threshold / 2``) and stays below for ``cooldown`` consecutive
  frames (brief dips inside one physical event don't split it);
* events shorter than ``min_frames`` are discarded (single-frame noise,
  decode glitches);
* baseline (re)capture frames report zero diff by construction and so
  never open an event.

Adaptive mode (``on_threshold="auto"``): every camera/codec pair has its
own noise floor — lossy compression on a textured scene keeps a large
fraction of pixels permanently "changed" by a few LSB, so no fixed
threshold fits a mixed fleet.  Auto mode estimates the floor online from
the frames observed while NO event is open (rolling LOW-quartile +
interquartile spread, robust both to outliers and to warmup
contamination from a stream that starts mid-motion) and opens at
``floor + auto_k * spread`` (closing at half that margin).  The floor is
frozen while an event is open so motion never inflates it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from .reference import STAT_NAMES

__all__ = ["MotionEvent", "MotionDetector", "METRICS"]

#: metric name -> stats column.  ``changed_frac`` is ``changed_count``
#: normalised by the frame's pixel count (pass ``pixels=`` to the
#: detector), so thresholds are resolution-independent.
METRICS = {
    "mean_abs_diff": 1,
    "max_abs_diff": 2,
    "changed_count": 3,
    "changed_frac": 3,
}


@dataclass(frozen=True)
class MotionEvent:
    """One closed motion event, in absolute frame indices (inclusive)."""
    start_frame: int
    end_frame: int
    peak: float        # max metric value inside the event
    peak_frame: int    # where the peak occurred
    mean: float        # mean metric value inside the event

    @property
    def frames(self) -> int:
        return self.end_frame - self.start_frame + 1

    def to_dict(self) -> dict:
        return {"start_frame": self.start_frame,
                "end_frame": self.end_frame, "frames": self.frames,
                "peak": self.peak, "peak_frame": self.peak_frame,
                "mean": self.mean}


class MotionDetector:
    """Streaming hysteresis segmenter.  Feed per-frame stats batches (in
    frame order) with ``update``; closed events come back as they close,
    ``flush()`` closes a still-open event at end of stream.

    Stateless across streams — use one detector per stream.
    """

    def __init__(self, on_threshold,
                 off_threshold: Optional[float] = None,
                 metric: str = "mean_abs_diff",
                 min_frames: int = 1, cooldown: int = 0,
                 pixels: Optional[int] = None,
                 auto_k: float = 8.0, auto_warmup: int = 16,
                 auto_window: int = 256):
        if metric not in METRICS:
            raise ValueError(
                f"metric {metric!r} not one of {sorted(METRICS)}")
        if metric == "changed_frac" and not pixels:
            raise ValueError("metric='changed_frac' needs pixels=H*W")
        self.metric = metric
        self._col = METRICS[metric]
        self._scale = 1.0 / float(pixels) if metric == "changed_frac" else 1.0
        self.auto = on_threshold == "auto"
        if self.auto:
            if off_threshold is not None:
                raise ValueError(
                    "off_threshold is computed in auto mode (estimated "
                    "floor + margin/2) — omit it (--event-off) or use a "
                    "fixed on_threshold")
            if auto_k <= 0 or auto_warmup < 1 or auto_window < auto_warmup:
                raise ValueError(
                    "auto mode needs auto_k > 0 and "
                    "auto_window >= auto_warmup >= 1")
            self.auto_k = float(auto_k)
            self.auto_warmup = int(auto_warmup)
            self._floor_samples: List[float] = []  # rolling, idle-only
            self._auto_window = int(auto_window)
            self._auto_cache: Optional[tuple] = None  # thresholds() memo
            self.on_threshold = self.off_threshold = None
        else:
            self.on_threshold = float(on_threshold)
            self.off_threshold = (float(off_threshold) if off_threshold
                                  is not None else self.on_threshold / 2.0)
            if self.off_threshold > self.on_threshold:
                raise ValueError(
                    f"off_threshold {self.off_threshold} > on_threshold "
                    f"{self.on_threshold} (hysteresis must close lower "
                    f"than it opens)")
        self.min_frames = max(1, int(min_frames))
        self.cooldown = max(0, int(cooldown))
        self._open: Optional[dict] = None
        self._below = 0           # consecutive sub-off frames while open
        self._next_index = 0      # expected frame index (drift guard)

    def thresholds(self) -> tuple:
        """Current (on, off) levels.  Fixed mode: the constructor values.
        Auto mode: ``q25 + k*spread`` / ``q25 + k/2*spread`` over the
        idle-frame window (spread = half the interquartile range), or
        ``(inf, inf)`` until ``auto_warmup`` idle frames have been
        observed.  The LOW quartile (not the median) anchors the floor so
        that a stream which starts DURING motion — whose warmup samples
        are contaminated, since no threshold exists yet to exclude them —
        still recovers as long as >=25% of the window is genuinely idle;
        a sustained-motion start inflates the spread (deafer for a while)
        but not the floor."""
        if not self.auto:
            return self.on_threshold, self.off_threshold
        if len(self._floor_samples) < self.auto_warmup:
            return float("inf"), float("inf")
        if self._auto_cache is None:
            # memoized: the floor only moves when an idle frame lands in
            # the window (update() invalidates); while an event is open —
            # or on repeated queries — no percentile is recomputed
            q25, q75 = np.percentile(self._floor_samples, (25, 75))
            spread = (q75 - q25) / 2.0
            # a dead-still window (spread 0) must not make 1-LSB flicker
            # an event: keep a minimum margin of 1% of the floor, or an
            # absolute epsilon when the floor itself is ~0 (one pixel for
            # the count metric, 1e-4 for the normalized ones)
            eps = 1.0 if self.metric == "changed_count" else 1e-4
            margin = self.auto_k * max(spread, 0.01 * q25, eps)
            self._auto_cache = (float(q25 + margin),
                                float(q25 + margin / 2.0))
        return self._auto_cache

    def update(self, stats: np.ndarray,
               start_index: Optional[int] = None) -> List[MotionEvent]:
        """Consume a (B, NUM_STATS) stats batch whose first row is frame
        ``start_index`` (defaults to continuing from the previous batch).
        Returns the events that CLOSED within this batch."""
        stats = np.asarray(stats)
        if stats.ndim != 2 or stats.shape[1] < len(STAT_NAMES):
            raise ValueError(
                f"expected (B, {len(STAT_NAMES)}) stats, got {stats.shape}")
        if start_index is None:
            start_index = self._next_index
        elif self._open is not None and start_index != self._next_index:
            raise ValueError(
                f"stats gap inside an open event: expected frame "
                f"{self._next_index}, got {start_index}")
        values = stats[:, self._col].astype(np.float64) * self._scale
        closed: List[MotionEvent] = []
        for i, v in enumerate(values):
            idx = start_index + i
            on_t, off_t = self.thresholds()
            if self._open is None:
                if v >= on_t:
                    self._open = {"start": idx, "peak": v, "peak_at": idx,
                                  "sum": v, "n": 1, "last_above": idx,
                                  "sum_end": v, "n_end": 1}
                    self._below = 0
                elif self.auto:
                    # idle frame: feeds the rolling noise-floor estimate
                    self._floor_samples.append(v)
                    if len(self._floor_samples) > self._auto_window:
                        del self._floor_samples[0]
                    self._auto_cache = None  # floor moved
            else:
                ev = self._open
                ev["sum"] += v
                ev["n"] += 1
                if v > ev["peak"]:
                    ev["peak"], ev["peak_at"] = v, idx
                if v < off_t:
                    self._below += 1
                    if self._below > self.cooldown:
                        e = self._close(ev["last_above"])
                        if e is not None:
                            closed.append(e)
                else:
                    self._below = 0
                    ev["last_above"] = idx
                    # snapshot the running sum so a discarded sub-off tail
                    # (cooldown frames after the true end) never skews the
                    # reported event mean
                    ev["sum_end"], ev["n_end"] = ev["sum"], ev["n"]
        self._next_index = start_index + len(values)
        return closed

    def _close(self, end_frame: int) -> Optional[MotionEvent]:
        ev, self._open, self._below = self._open, None, 0
        n_frames = end_frame - ev["start"] + 1
        if n_frames < self.min_frames:
            return None
        # mean over the event span only (the sub-off tail is excluded)
        mean = ev["sum_end"] / ev["n_end"]
        return MotionEvent(start_frame=ev["start"], end_frame=end_frame,
                           peak=float(ev["peak"]),
                           peak_frame=int(ev["peak_at"]), mean=float(mean))

    @property
    def is_open(self) -> bool:
        """True while an event is in progress (between open and close)."""
        return self._open is not None

    def flush(self) -> List[MotionEvent]:
        """Close any still-open event at end of stream."""
        if self._open is None:
            return []
        e = self._close(self._open["last_above"])
        return [e] if e is not None else []


def detect_events(stats: Sequence[np.ndarray], **kwargs) -> List[MotionEvent]:
    """One-shot convenience: segment a whole run's stats (any batching)."""
    det = MotionDetector(**kwargs)
    out: List[MotionEvent] = []
    for batch in stats:
        out.extend(det.update(np.atleast_2d(np.asarray(batch))))
    out.extend(det.flush())
    return out
