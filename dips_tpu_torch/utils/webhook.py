"""Best-effort async JSON webhook delivery for motion-event alerts.

The serving daemon (`--events --event-webhook URL`) pushes each closed
:class:`~dips_tpu.ops.events.MotionEvent` to an HTTP endpoint so a camera
fleet gets alerts without polling process replies.  Design constraints:

- **Never block a session thread**: `post()` enqueues and returns; one
  background thread delivers.  The queue is bounded — under a receiver
  outage new alerts drop (counted) rather than growing without bound.
- **Best effort, observable**: per-delivery retries with backoff, then
  the failure is counted and the alert dropped.  Delivery/failed/dropped
  counts surface in the daemon's metrics, which is where an operator
  finds out the receiver is down.

The reference has no serving daemon or alerting at all (SURVEY §5
"failure detection: absent"); this is fleet-operations surface around
the rebuild's motion-event segmenter (ops/events.py).
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Optional

log = logging.getLogger("dips.webhook")

_WAKE = object()  # queue sentinel: wake the worker so it sees _closed


class WebhookSender:
    """Asynchronous bounded-queue JSON POSTer.

    ``on_result(outcome)`` (optional) is called with ``"delivered"``,
    ``"failed"`` or ``"dropped"`` — the daemon wires this to its metrics
    counters.  Thread-safe: ``post`` may be called from many threads.
    """

    def __init__(self, url: str, timeout_s: float = 5.0, retries: int = 2,
                 backoff_s: float = 0.5, queue_max: int = 256,
                 on_result: Optional[Callable[[str], None]] = None):
        if not url.lower().startswith(("http://", "https://")):
            raise ValueError(f"webhook url must be http(s), got {url!r}")
        self.url = url
        self.timeout_s = float(timeout_s)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self._on_result = on_result
        self._q: queue.Queue = queue.Queue(maxsize=queue_max)
        self._closed = False
        self._abort = threading.Event()  # set => stop retrying/draining NOW
        # serializes the closed-check+enqueue in post() against close()
        # flipping _closed, so nothing can slip into the queue after
        # close()'s final drain (which would be a lost, uncounted alert)
        self._post_lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dips-webhook")
        self._thread.start()

    # -- producer side ----------------------------------------------------
    def post(self, payload: dict) -> bool:
        """Enqueue one JSON payload; returns False (and counts a drop)
        when the queue is full or the sender is closed."""
        with self._post_lock:
            if self._closed:
                self._note("dropped")
                return False
            try:
                self._q.put_nowait(payload)
                return True
            except queue.Full:
                self._note("dropped")
                return False

    def close(self, flush_timeout_s: float = 5.0) -> None:
        """Stop accepting, give the backlog ``flush_timeout_s`` to drain,
        then abort: remaining retry backoffs are cancelled and the
        undelivered backlog is counted as dropped, so no worker activity
        (or log noise) outlives this call by more than one in-flight
        request.  (That request is *usually* bounded by ``timeout_s``,
        but urllib's timeout is per socket operation — a drip-feeding
        receiver or a stalled DNS lookup can hold it longer; after the
        abort the worker drops everything else the moment it returns.)"""
        with self._post_lock:
            if self._closed:
                return
            self._closed = True
        try:
            self._q.put_nowait(_WAKE)
        except queue.Full:
            pass  # worker is busy with a backlog; it re-checks _closed
        self._thread.join(timeout=flush_timeout_s)
        if self._thread.is_alive():
            self._abort.set()
            # One in-flight urlopen (bounded by timeout_s per socket op)
            # may still be running; after it, a fast drain-as-dropped.
            self._thread.join(timeout=self.timeout_s + 1.0)
        # The worker can exit with items still queued: its Empty branch
        # re-checks _closed between a put and the next get, and a racing
        # post() may have enqueued just before _closed flipped.  Count
        # them so no alert vanishes without an outcome.  (If the worker
        # is somehow still alive past both joins, leave the queue to it —
        # with _abort set it drains everything as dropped itself.)
        while not self._thread.is_alive():
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _WAKE:
                self._note("dropped")

    # -- worker side -------------------------------------------------------
    def _note(self, outcome: str) -> None:
        if self._on_result is not None:
            try:
                self._on_result(outcome)
            except Exception:  # noqa: BLE001 — metrics must not kill alerts
                log.exception("webhook on_result callback failed")

    def _deliver(self, payload: dict) -> None:
        body = json.dumps(payload).encode()
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json",
                     "User-Agent": "dips-tpu-webhook"})
        last_err: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            if attempt:
                # Event.wait doubles as an abortable sleep: close() sets
                # _abort once the flush window expires and this returns
                # immediately instead of serving out the backoff schedule.
                if self._abort.wait(self.backoff_s * attempt):
                    self._note("dropped")
                    return
            try:
                with urllib.request.urlopen(req, timeout=self.timeout_s) \
                        as resp:
                    if 200 <= resp.status < 300:
                        self._note("delivered")
                        return
                    last_err = urllib.error.HTTPError(
                        self.url, resp.status, "non-2xx", resp.headers,
                        None)
            except Exception as e:  # noqa: BLE001 — network best-effort
                last_err = e
        log.warning("webhook delivery to %s failed after %d attempts: %r",
                    self.url, self.retries + 1, last_err)
        self._note("failed")

    def _run(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=0.25)
            except queue.Empty:
                if self._closed:
                    return
                continue
            if item is not _WAKE:
                if self._abort.is_set():
                    self._note("dropped")
                else:
                    self._deliver(item)
            elif self._closed and self._q.empty():
                return
