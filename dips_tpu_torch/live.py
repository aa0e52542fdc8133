"""Live preview mode: webcam -> pipeline -> window, with runtime controls.

The capability equivalent of the reference's winit/egui live app
(``run_dips_app``, dips_alt/src/lib.rs:113-552).  GPU hosts are headless, so
the egui overlay (dips_alt/src/gui/mod.rs:14-148 — SnapShot button, colorize
checkbox, filter/chroma combos, sensitivity and window sliders, each change
rebuilding ``DiPsCompute``) becomes a keyboard-driven state machine over the
cv2 preview window, factored into :class:`LiveController` so it is testable
headless.

Key map (egui-widget parity first, rebuild semantics identical: a parameter
change rebuilds the engine while the snapshot baseline / temporal ring /
frame cursor carry over — ref redip closure, dips_alt/src/lib.rs:267-293):

  s        re-capture the snapshot baseline   (SnapShot button, lib.rs:296)
  o        toggle colorize <-> grayscale      (colorize checkbox)
  f        cycle filter sigmoid -> inv_sigmoid -> none   (filter combo)
  c        cycle chroma all -> r -> g -> b    (chroma combo)
  - / +    sensitivity down / up by 0.5       (sensitivity slider)
  [ / ]    sigmoid horizontal scalar -/+ 1    (window slider's sibling)
  w / W    spatial window -/+ 2 (odd 1..7)    (window size slider)
  t / T    temporal ring length -/+ 1 (1..16)
  m        toggle method overall <-> per_frame
  e        toggle motion-EVENT detection (auto noise-floor; "MOTION" in
           the title while one is open, closed events print to stdout)
  a        toggle adaptive baseline AUTO-REFRESH (ops/refresh.py): a
           wholesale scene change re-pins the snapshot automatically —
           the hands-free sibling of the 's' key (overall method only)
  q / ESC  quit
"""

from __future__ import annotations

import sys
from typing import Optional

from .models import DiPsEngine
from .properties import (ChromaFilter, DiPsFilter, DiPsMethod,
                         DiPsProperties)

_FILTER_CYCLE = [DiPsFilter.SIGMOID, DiPsFilter.INVERSE_SIGMOID,
                 DiPsFilter.UNFILTERED]
_CHROMA_CYCLE = [ChromaFilter.ALL, ChromaFilter.RED, ChromaFilter.GREEN,
                 ChromaFilter.BLUE]


class LiveController:
    """Key -> properties state machine for the live preview.

    ``handle_key`` returns True when the engine must be rebuilt (the egui
    overlay's pipeline-rebuild-on-change semantics); the new configuration
    is in ``props``.  ``snapshot_requested`` / ``quit`` are one-shot flags
    the run loop consumes.
    """

    def __init__(self, props: DiPsProperties,
                 auto_refresh: Optional[dict] = None):
        self.props = props
        self.snapshot_requested = False
        self.quit = False
        #: motion-event detection toggle ('e'); the run loop owns the
        #: detector itself (it needs the frame geometry)
        self.events_enabled = False
        #: adaptive baseline auto-refresh toggle ('a'); the run loop owns
        #: the BaselineRefreshPolicy (it needs the analysis-pixel count).
        #: ``auto_refresh`` pre-enables it with policy kwargs (--auto-
        #: refresh --live); 'a' then toggles the same configuration.
        self.auto_refresh_cfg = dict(auto_refresh or {})
        self.auto_refresh_enabled = auto_refresh is not None

    def _cycle(self, cycle, current):
        return cycle[(cycle.index(current) + 1) % len(cycle)]

    def handle_key(self, key: int | str) -> bool:
        """Process one key (int keycode or 1-char string); True = rebuild."""
        if isinstance(key, int):
            if key == 27:  # ESC
                self.quit = True
                return False
            if not 0 <= key < 0x110000:
                return False
            key = chr(key)
        p = self.props
        if key == "q":
            self.quit = True
            return False
        if key == "s":
            self.snapshot_requested = True
            return False
        if key == "e":
            self.events_enabled = not self.events_enabled
            return False  # a detector toggle never rebuilds the engine
        if key == "a":
            self.auto_refresh_enabled = not self.auto_refresh_enabled
            return False  # policy toggle, not a pipeline change
        if key == "o":
            new = p.with_colorize(not p.colorize)
        elif key == "f":
            new = p.with_filter(self._cycle(_FILTER_CYCLE, p.filter))
        elif key == "c":
            new = p.with_chroma(self._cycle(_CHROMA_CYCLE, p.chroma))
        elif key == "m":
            new = p.with_method(DiPsMethod.PER_FRAME
                                if p.method == DiPsMethod.OVERALL
                                else DiPsMethod.OVERALL)
        elif key == "-":
            new = p.with_sensitivity(max(0.0, p.sensitivity - 0.5))
        elif key in ("+", "="):
            new = p.with_sensitivity(p.sensitivity + 0.5)
        elif key == "[":
            new = p.with_sigmoid_horizontal_scalar(
                p.sigmoid_horizontal_scalar - 1)
        elif key == "]":
            new = p.with_sigmoid_horizontal_scalar(
                p.sigmoid_horizontal_scalar + 1)
        elif key == "w":
            new = p.with_window_size(max(1, p.window_size - 2))
        elif key == "W":
            new = p.with_window_size(p.window_size + 2)
        elif key == "t":
            new = p.with_temporal_size(p.temporal_size - 1)
        elif key == "T":
            new = p.with_temporal_size(p.temporal_size + 1)
        else:
            return False
        changed = new != p
        self.props = new
        return changed

    def status_line(self) -> str:
        """One-line HUD of the current configuration."""
        p = self.props
        return (f"{p.method.name.lower()} {p.output.name.lower()} "
                f"filt={p.filter.name.lower()} chroma={p.chroma.name.lower()} "
                f"w={p.window_size} t={p.temporal_size} "
                f"sens={p.sensitivity:g} scalar={p.sigmoid_horizontal_scalar:g}"
                + (" events=auto" if self.events_enabled else "")
                + (" refresh=auto" if self.auto_refresh_enabled else ""))


def rebuild_engine(old: DiPsEngine, props: DiPsProperties,
                   device="cuda") -> DiPsEngine:
    """New engine for ``props`` carrying over the streaming state.

    The baseline, temporal ring tail, heatmap and frame cursor survive the
    rebuild when the state representations are compatible (same geometry,
    both f32-baseline modes or both raw modes); otherwise the new engine
    starts fresh — matching the reference, which re-snapshots after every
    egui change (index = 0, dips_alt/src/lib.rs:267-293).
    """
    eng = DiPsEngine(props, old.height, old.width, batch=old.batch,
                     device=device)
    if eng._raw_mode == old._raw_mode:
        state = old.state_dict()
        tail = state["tail"]
        if tail is not None:
            t_new = props.temporal_size
            if len(tail) > t_new:       # shrink: keep the newest frames
                tail = tail[-t_new:]
            elif len(tail) < t_new:     # grow: replay the oldest frame
                import numpy as np
                pad = np.repeat(tail[:1], t_new - len(tail), axis=0)
                tail = np.concatenate([pad, tail])
            state["tail"] = tail
        eng.load_state_dict(state)
    return eng


def _to_bgr(out):
    """uint8 (H, W, C) diff map -> BGR for imshow (C == 1 shows the plane)."""
    import cv2
    if out.ndim == 2 or out.shape[-1] == 1:
        return cv2.cvtColor(out.reshape(out.shape[0], out.shape[1]),
                            cv2.COLOR_GRAY2BGR)
    return cv2.cvtColor(out, cv2.COLOR_RGB2BGR)


def run_live(props: DiPsProperties, camera: int = 0, batch: int = 1,
             device="cuda",
             reader: Optional[object] = None,
             auto_refresh: Optional[dict] = None) -> int:
    """The preview loop; ``reader`` is injectable for tests.
    ``auto_refresh`` (BaselineRefreshPolicy kwargs, from --auto-refresh)
    starts with adaptive baseline refresh enabled; the 'a' key toggles it
    either way."""
    import os
    import cv2
    from .io.video import open_camera
    if reader is None:
        try:
            reader = open_camera(camera)
        except Exception as e:
            print(f"no camera available: {e}", file=sys.stderr)
            return 1
    # cv2's GTK backend ABORTS (not raises) on a missing X/Wayland display,
    # so probe the environment before touching highgui.
    if sys.platform.startswith("linux") and not (
            os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")):
        print("no display available for --live (DISPLAY unset)",
              file=sys.stderr)
        reader.close()
        return 1
    try:
        cv2.namedWindow("DiPs")
    except cv2.error as e:
        print(f"no display available for --live: {e}", file=sys.stderr)
        reader.close()
        return 1

    ctl = LiveController(props, auto_refresh=auto_refresh)
    engine = None
    detector = None
    refresher = None
    try:
        while not ctl.quit:
            frame = reader.read()
            if frame is None:
                break
            if engine is None:
                h, w = frame.shape[:2]
                try:
                    engine = DiPsEngine(ctl.props, h, w, batch=batch,
                                        device=device)
                except ValueError as e:  # e.g. --roi outside the camera
                    print(f"error: {e}", file=sys.stderr)
                    return 1
            outs, stats = engine.process_batch([frame])
            title = "DiPs  " + ctl.status_line()
            if ctl.events_enabled:
                if detector is None:
                    from .ops.events import MotionDetector
                    detector = MotionDetector(
                        "auto", metric="changed_frac",
                        pixels=engine.analysis_pixels, min_frames=2)
                for ev in detector.update(
                        stats, start_index=engine.frame_index - 1):
                    print(f"motion event: frames {ev.start_frame}-"
                          f"{ev.end_frame} peak {ev.peak:.4f}")
                if detector.is_open:
                    title += "  [MOTION]"
            else:
                detector = None
            if ctl.auto_refresh_enabled and (
                    ctl.props.method == DiPsMethod.OVERALL):
                if refresher is None:
                    from .ops.refresh import BaselineRefreshPolicy
                    cfg = dict(ctl.auto_refresh_cfg)
                    cfg.setdefault("cooldown",
                                   cfg.get("persist", 3) + 2 * batch)
                    refresher = BaselineRefreshPolicy(
                        pixels=engine.analysis_pixels, **cfg)
                if refresher.feed(engine.frame_index - 1, stats[0]):
                    engine.snapshot()
                    print(f"auto-refresh: baseline re-pinned at frame "
                          f"{engine.frame_index - 1}")
            else:
                refresher = None
            shown = _to_bgr(outs[0])
            if ctl.props.roi is not None:
                # outline the analysis region so the operator sees what
                # the stats/events actually watch
                y0, x0, y1, x1 = ctl.props.roi
                cv2.rectangle(shown, (x0, y0), (x1 - 1, y1 - 1),
                              (0, 255, 255), 1)
            cv2.imshow("DiPs", shown)
            cv2.setWindowTitle("DiPs", title)
            key = cv2.waitKey(1) & 0xFF
            if key != 0xFF and ctl.handle_key(int(key)):
                engine = rebuild_engine(engine, ctl.props, device)
                detector = None   # new pixel math = new noise floor
                refresher = None  # ditto for the refresh policy
            if ctl.snapshot_requested and engine is not None:
                engine.snapshot()
                ctl.snapshot_requested = False
        return 0
    finally:
        reader.close()
        cv2.destroyAllWindows()
