"""Per-session analytics (mixin for ``DiPsServer``): flicker analyzers,
motion-event detectors + webhook fan-out, and adaptive baseline-refresh
policies riding each session's engine through park/resume."""

from __future__ import annotations

import logging
import time

import numpy as np

log = logging.getLogger("dips_tpu.serve")


class AnalyticsMixin:
    """Stats-stream consumers of ``DiPsServer`` (config attributes —
    ``event_cfg``, ``refresh_cfg``, ``_webhook`` — live on the server)."""

    # -- per-session flicker analysis (ops/analysis.py) --------------------
    @staticmethod
    def _bind_flicker(eng, header) -> None:
        """Attach a FlickerAnalyzer to the session's engine when the bind
        request asks for one (``flicker_hz`` + ``flicker_fps``).  It rides
        the engine through park/resume like the motion detector; the map
        is NOT part of checkpoints (it is derived data — a restart starts
        its window fresh)."""
        hz = header.get("flicker_hz")
        if hz is None:
            if header.get("flicker_fps") is not None:
                raise ValueError("flicker_fps needs flicker_hz")
            return
        fps = header.get("flicker_fps")
        if fps is None:
            raise ValueError(
                "flicker_hz needs flicker_fps (the daemon cannot know a "
                "camera's frame rate)")
        old = getattr(eng, "_flicker", None)
        if old is not None:
            if (old.freq_hz, old.fps) != (float(hz), float(fps)):
                raise ValueError(
                    f"session already analyzes {old.freq_hz:g} Hz @ "
                    f"{old.fps:g} fps; reset it before binding "
                    f"{float(hz):g} Hz @ {float(fps):g} fps")
            return  # resume keeps the accumulated window
        if hasattr(eng, "bind_flicker"):
            # coalesced slot: arm the coalescer's FLEET analyzer (one
            # stacked dispatch updates every armed slot per batch) — the
            # returned view duck-types FlickerAnalyzer for the read path
            # and no-ops update() (the coalescer feeds the frames)
            eng._flicker = eng.bind_flicker(float(hz), float(fps))
            return
        from ..ops.analysis import FlickerAnalyzer
        eng._flicker = FlickerAnalyzer(float(hz), float(fps),
                                       batch=eng.batch, device=eng.device)

    # -- per-session motion events (ops/events.py) ------------------------
    def _detector_for(self, eng):
        """Lazily attach a MotionDetector to the session's engine; it
        parks/resumes with it, so an open event survives a reconnect."""
        det = getattr(eng, "_motion_det", None)
        if det is None:
            from ..ops.events import MotionDetector
            cfg = dict(self.event_cfg)
            if cfg.get("metric") == "changed_frac":
                cfg.setdefault(
                    "pixels",
                    eng.props.analysis_pixels(eng.height, eng.width))
            det = MotionDetector(**cfg)
            eng._motion_det = det
        return det

    def _apply_events(self, eng, hdr, n_frames: int) -> None:
        """Segment this request's stats rows; annotate the reply with the
        events that closed and whether one is open."""
        if self.event_cfg is None:
            return
        det = self._detector_for(eng)
        stats = np.asarray(hdr["stats"], np.float32)
        closed = det.update(stats, start_index=eng.frame_index - n_frames)
        if closed:
            self._count("motion_events", len(closed))
            self._post_webhook(eng, closed)
        hdr["events"] = [e.to_dict() for e in closed]
        hdr["event_open"] = det.is_open

    # -- per-session adaptive baseline refresh (ops/refresh.py) -----------
    def _refresher_for(self, eng):
        """Lazily attach a BaselineRefreshPolicy to the session's engine;
        it parks/resumes with it, like the motion detector."""
        pol = getattr(eng, "_refresher", None)
        if pol is None:
            from ..ops.refresh import BaselineRefreshPolicy
            cfg = dict(self.refresh_cfg)
            if cfg.get("metric", "changed_frac") == "changed_frac":
                cfg.setdefault(
                    "pixels",
                    eng.props.analysis_pixels(eng.height, eng.width))
            # cover the snapshot latency: the re-capture lands on the
            # NEXT dispatch, so up to one request's batch still diffs
            # against the old baseline
            cfg.setdefault("cooldown", cfg.get("persist", 3)
                           + 2 * max(1, eng.batch))
            pol = BaselineRefreshPolicy(**cfg)
            eng._refresher = pol
        return pol

    def _apply_refresh(self, eng, hdr, n_frames: int) -> None:
        """Feed this request's stats rows to the session's refresh policy;
        a trigger requests ``eng.snapshot()`` (takes effect next dispatch)
        and annotates the reply with the fired frame index."""
        if self.refresh_cfg is None:
            return
        pol = self._refresher_for(eng)
        start = eng.frame_index - n_frames
        fired = []
        for i, row in enumerate(hdr["stats"]):
            if pol.feed(start + i, row):
                fired.append(start + i)
                self._count("auto_refreshes")  # one per policy fire, so
                # the metric matches pol.refreshes even in large requests
        if fired:
            eng.snapshot()
            hdr["baseline_refresh"] = fired[-1]   # back-compat scalar
            hdr["baseline_refreshes"] = fired     # every fired index
            # the snapshot lands only at the NEXT dispatch (after this
            # whole request): re-base the cooldown on the request end so
            # the policy cannot re-trigger on its own landing latency
            pol.suppress_until(eng.frame_index + pol.cooldown)

    def _post_webhook(self, eng, events) -> None:
        """Fan closed events out to the --event-webhook URL (async,
        best-effort; outcomes land in the webhook_* metrics)."""
        if self._webhook is None or not events:
            return
        tok = getattr(eng, "session_token", None)
        for e in events:
            self._webhook.post({
                "type": "motion_event",
                "session": tok,
                "geometry": f"{eng.height}x{eng.width}",
                "port": self.port,
                "ts": time.time(),
                "event": e.to_dict(),
            })
