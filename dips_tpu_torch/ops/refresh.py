"""Adaptive baseline refresh over the per-frame statistics stream.

The reference re-captures its baseline only on demand: static refresh
markers given up front (dips_alt/src/lib.rs:668-670) or a human pressing
the SnapShot button (dips_alt/src/lib.rs:296-298).  Neither helps an
unattended camera whose scene changes wholesale mid-stream — a lighting
flip, a camera bump, a scene cut — after which every pixel diffs "hot"
against the stale baseline forever and the output is useless noise.

:class:`BaselineRefreshPolicy` automates the SnapShot button.  It watches
the four per-frame scalars the pipeline already reduces on device
(``ops/oracle.STAT_NAMES``) and requests a re-capture when the chosen
metric stays at/above ``threshold`` for ``persist`` consecutive frames:
a step change touches most of the frame *and stays there*, which is
exactly what a high ``changed_frac`` sustained over a few frames means,
while ordinary motion flips a small fraction and flash glitches last a
frame or two.

Host-side by design, like :class:`~dips_tpu.ops.events.MotionDetector`:
it consumes the tiny (4,) stats rows the engine already downloads, so it
is identical across single-chip, multi-stream and multi-host engines and
costs nothing on device.

Latency and the cooldown: ``DiPsEngine.snapshot()`` takes effect at the
NEXT dispatch, and with ``pipeline_depth=2`` one batch is already in
flight — so up to ~2 batches of frames still diff against the old
baseline after a trigger.  The ``cooldown`` must swallow that window or
the policy would re-trigger on its own latency; the
:func:`wire <dips_tpu.app.perform_dips>` default is
``persist + 2 * batch``.  If the metric is STILL at/above threshold once
the cooldown expires, the policy fires again: a scene churning wholesale
has no meaningful pinned baseline, and a periodic re-pin at cooldown
cadence is the sane degraded behavior (documented, not accidental).
"""

from __future__ import annotations

from typing import List, Optional

from .events import METRICS


def parse_auto_refresh_arg(value: str) -> dict:
    """``FRAC[:PERSIST[:COOLDOWN]]`` (the --auto-refresh flag shared by
    the CLI and the serving daemon) -> BaselineRefreshPolicy kwargs.
    Raises ValueError on malformed input; range checks happen in the
    policy constructor."""
    parts = value.split(":")
    if not 1 <= len(parts) <= 3:
        raise ValueError("too many fields")
    cfg = {"threshold": float(parts[0])}
    if len(parts) > 1:
        cfg["persist"] = int(parts[1])
    if len(parts) > 2:
        cfg["cooldown"] = int(parts[2])
    return cfg


class BaselineRefreshPolicy:
    """Streaming scene-change detector -> re-snapshot requests.

    Feed per-frame stats rows in order with :meth:`feed`; it returns True
    on the frame where a baseline re-capture should be requested (call
    ``engine.snapshot()`` then).  One policy per stream.

    Args:
      threshold: trigger level for ``metric``.  The default metric is
        ``changed_frac`` (changed pixels / analysis pixels, resolution-
        independent), where 0.6 means "60% of the frame changed" — far
        above ordinary motion, typical of a global scene change.
      persist: consecutive at/above-threshold frames required (debounces
        single-frame flashes and decode glitches).
      cooldown: frames after a trigger during which the policy is inert
        (must cover the snapshot latency — see module docstring).
      metric: one of ``ops.events.METRICS``.
      pixels: analysis-pixel count, required for ``changed_frac``
        (``engine.analysis_pixels`` — roi-aware).
    """

    def __init__(self, threshold: float = 0.6, persist: int = 3,
                 cooldown: int = 64, metric: str = "changed_frac",
                 pixels: Optional[int] = None):
        if metric not in METRICS:
            raise ValueError(
                f"metric {metric!r} not one of {sorted(METRICS)}")
        if metric == "changed_frac" and not pixels:
            raise ValueError("metric='changed_frac' needs pixels=H*W")
        if not threshold > 0:
            raise ValueError(f"threshold must be > 0, got {threshold}")
        if metric == "changed_frac" and threshold > 1:
            raise ValueError(
                f"changed_frac threshold is a fraction in (0, 1], "
                f"got {threshold}")
        if persist < 1 or cooldown < 0:
            raise ValueError("need persist >= 1 and cooldown >= 0")
        self.threshold = float(threshold)
        self.persist = int(persist)
        self.cooldown = int(cooldown)
        self.metric = metric
        self._col = METRICS[metric]
        self._scale = (1.0 / float(pixels) if metric == "changed_frac"
                       else 1.0)
        self._hot = 0                  # consecutive at-threshold frames
        self._cool_until = -1          # no triggers while idx < this
        #: frame indices where a refresh fired (run log / artifact)
        self.refreshes: List[int] = []

    def feed(self, idx: int, stats) -> bool:
        """One frame's stats row (NUM_STATS,); True = request a snapshot
        now.  ``idx`` is the absolute frame index (monotonic per stream,
        used only for the cooldown window and the refresh log)."""
        if idx < self._cool_until:
            # inside the post-trigger window the metric is expected to be
            # high (old-baseline frames still in flight) — not evidence
            self._hot = 0
            return False
        value = float(stats[self._col]) * self._scale
        if value >= self.threshold:
            self._hot += 1
        else:
            self._hot = 0
        if self._hot < self.persist:
            return False
        self._hot = 0
        self._cool_until = idx + 1 + self.cooldown
        self.refreshes.append(idx)
        return True

    def suppress_until(self, idx: int) -> None:
        """Extend the cooldown so no trigger fires before frame ``idx``.

        For batch consumers whose snapshot lands only after the whole
        request (the serving daemon's process_many): a fire mid-request
        keeps diffing the old baseline until the request ends, so the
        fire-relative cooldown alone can re-trigger on its own latency
        within one large request.  Calling
        ``suppress_until(engine.frame_index + pol.cooldown)`` after the
        request re-bases the window on when the snapshot actually lands."""
        self._cool_until = max(self._cool_until, int(idx))
        self._hot = 0
