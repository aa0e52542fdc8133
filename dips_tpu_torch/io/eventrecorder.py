"""Event-triggered recording: write video ONLY around motion.

The NVR recipe on top of :mod:`~dips_tpu.ops.events`: a rolling pre-roll
buffer of recent frames, a segment writer that opens when the detector
opens an event (flushing the pre-roll so the lead-in is on disk), and a
post-roll countdown after it closes.  A new event during post-roll merges
into the same segment — adjacent bursts produce one clip, not confetti.

Storage math is the point: a fleet camera that is idle 95% of the time
writes ~5% of the video (plus rolls), while the stats/events channel
still covers 100% of frames.  The recorder is pure host logic over
frames the pipeline already produced — no extra device work.

Feed order matters: ``feed(frame, stats_row, index)`` once per frame, in
frame order (exactly what ``perform_dips``'s emit loop has in hand).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, List, Optional

import numpy as np

from ..ops.events import MotionDetector

__all__ = ["EventRecorder"]


class EventRecorder:
    """Segment-writing state machine.

    ``open_writer(seg_index, start_frame)`` returns a writer with
    ``write(frame)`` / ``close()`` (and optionally ``.path``).  The
    detector decides when motion exists; this class decides what lands
    on disk:

    * idle: frames go to a ``pre_roll``-deep ring;
    * detector opens: a segment opens at (open frame - buffered frames)
      and the ring flushes into it;
    * detector closes: ``post_roll`` more frames are written, then the
      segment closes — unless a new event opens first, which merges;
    * ``finish()`` (EOS) closes whatever is open.

    A segment triggered by an event the detector later debounces away
    (shorter than its ``min_frames``) still exists on disk — frames
    cannot be unwritten; it is simply a short clip.  ``segments`` lists
    every written segment with its frame span and the closed events it
    covered.
    """

    def __init__(self, detector: Optional[MotionDetector],
                 open_writer: Callable[[int, int], object],
                 pre_roll: int = 30, post_roll: int = 30):
        #: None for the edge-recording shape: segmentation state comes
        #: from reply annotations via :meth:`feed_annotated` instead
        self.detector = detector
        self._open_writer = open_writer
        self.pre_roll = max(0, int(pre_roll))
        self.post_roll = max(0, int(post_roll))
        self._ring: deque = deque(maxlen=self.pre_roll)
        self._writer = None
        self._post_left: Optional[int] = None  # counting down after close
        self._seg: Optional[dict] = None
        self._last_index: Optional[int] = None  # newest fed frame index
        self.segments: List[dict] = []

    def _start_segment(self, index: int) -> None:
        start = index - len(self._ring)
        self._writer = self._open_writer(len(self.segments), start)
        self._seg = {"start_frame": start, "end_frame": index,
                     "frames": 0, "events": [],
                     "path": getattr(self._writer, "path", None)}
        for f in self._ring:
            self._writer.write(f)
            self._seg["frames"] += 1
        self._ring.clear()

    def _close_segment(self) -> None:
        self._writer.close()
        self._writer = None
        self._post_left = None
        self.segments.append(self._seg)
        self._seg = None

    def feed(self, frame: np.ndarray, stats_row: np.ndarray,
             index: int) -> None:
        if self.detector is None:
            raise ValueError(
                "this recorder was built without a detector (edge "
                "shape): drive it with feed_annotated() instead")
        closed = self.detector.update(np.atleast_2d(stats_row),
                                      start_index=index)
        self.feed_annotated(frame, self.detector.is_open,
                            [e.to_dict() for e in closed], index)

    def feed_annotated(self, frame: np.ndarray, open_now: bool,
                       closed: List[dict], index: int) -> None:
        """Segment on EXTERNALLY-determined event state instead of this
        recorder's own detector — the edge-recording shape: a camera
        client records its ORIGINAL frames, driven by the ``--events``
        annotations the serving daemon already returns
        (``DiPsClient.event_open`` / ``.last_events``), so the pixels
        never need a second analysis pass.  Use a frame ``index``
        consistent with the SESSION cursor across reconnects (seed it
        from ``hello()['frame_index']``), or the daemon-side event
        indices inside the manifest won't line up with the clip spans."""
        self._last_index = index
        if self._writer is None:
            # ``closed`` non-empty with no writer open happens in the edge
            # shape when an event opens AND closes within one batched
            # request (open_now is already False again for every frame of
            # the batch): open retroactively from the pre-roll ring, or
            # the event gets neither a clip nor a manifest entry.
            if open_now or closed:
                self._start_segment(index)
            else:
                self._ring.append(frame)
                return
        self._writer.write(frame)
        self._seg["frames"] += 1
        self._seg["end_frame"] = index
        self._seg["events"] += list(closed)
        if open_now:
            self._post_left = None  # merged: a burst re-arms the segment
        else:
            if self._post_left is None:
                self._post_left = self.post_roll
            if self._post_left <= 0:
                self._close_segment()
            else:
                self._post_left -= 1

    def finish(self, final_events: Optional[List[dict]] = None
               ) -> List[dict]:
        """EOS: flush the detector's open event and close the segment.
        Returns all segments.

        ``final_events``: edge shape only — the events the SOURCE flushed
        at end of stream (e.g. ``DiPsClient.last_events`` right after
        ``close()``, which carries an anonymous session's flush), so a
        recording that stops mid-motion still attributes its final clip."""
        flushed = list(final_events or [])
        if self.detector is not None:
            flushed += [e.to_dict() for e in self.detector.flush()]
        if self._writer is None and flushed and self._ring:
            # events closed at EOS with no segment open (e.g. a burst
            # entirely inside the final batch): the pre-roll ring is the
            # only footage still in hand — write it so the events get a
            # clip and a manifest entry instead of vanishing.
            self._start_segment(self._last_index + 1)
            self._seg["end_frame"] = self._last_index
        if self._writer is not None:
            self._seg["events"] += flushed
            self._close_segment()
        self._ring.clear()
        return self.segments
