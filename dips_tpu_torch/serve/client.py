"""Clients: :class:`DiPsClient` (one connection) and
:class:`ResilientDiPsClient` (edge links: backoff reconnection + resume
with exactly-once frame accounting)."""

from __future__ import annotations

import logging
import socket
import time
from typing import Optional, Tuple

import numpy as np

from ..errors import ReplyLost
from .protocol import _recv, _send

log = logging.getLogger("dips_tpu.serve")


class DiPsClient:
    """Minimal client for :class:`DiPsServer`.

    ``session``: optional stable token (e.g. a camera id).  Requests carry
    it, and the server parks/resumes that session's streaming state across
    reconnects; without it, a multi-session server hands out fresh state
    per connection.

    ``roi``: optional per-session analysis region (y0, x0, y1, x1) — each
    camera in a fleet watches a different scene, so the rectangle rides
    the requests and the server binds THIS session's engine with it
    (statistics/heatmap/motion events reduce over it; maps stay
    full-frame).  Not available on request-coalescing daemons (their
    stacked kernel is shared — use the daemon-wide ``--roi`` there)."""

    def __init__(self, port: int, host: str = "127.0.0.1",
                 session: Optional[str] = None,
                 roi: Optional[Tuple[int, int, int, int]] = None,
                 flicker_hz: Optional[float] = None,
                 flicker_fps: Optional[float] = None):
        self.session = session
        self.roi = None if roi is None else tuple(int(v) for v in roi)
        #: per-session flicker analysis: the server streams a
        #: FlickerAnalyzer at flicker_hz over this session's frames
        #: (flicker_fps = the camera's frame rate, which the daemon
        #: cannot know); fetch the map with :meth:`flicker`
        self.flicker_hz = flicker_hz
        self.flicker_fps = flicker_fps
        #: motion-event annotations from the LAST process reply (populated
        #: only when the daemon runs with --events)
        self.last_events: list = []
        self.event_open: bool = False
        #: frame index where the LAST process reply re-pinned the baseline
        #: (--auto-refresh daemons), else None
        self.last_refresh: Optional[int] = None
        self._sock = socket.create_connection((host, port))

    def __enter__(self) -> "DiPsClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _rpc(self, header: dict, payload: bytes = b"") -> Tuple[dict, bytes]:
        if self.session is not None:
            header = dict(header, session=self.session)
        if self.roi is not None:
            # consumed at first-request engine bind; inert afterwards
            header = dict(header, roi=list(self.roi))
        if self.flicker_hz is not None or self.flicker_fps is not None:
            header = dict(header, flicker_hz=self.flicker_hz,
                          flicker_fps=self.flicker_fps)
        if payload:
            header = dict(header, payload_len=len(payload))
        _send(self._sock, header, payload)
        resp = _recv(self._sock)
        if resp is None:
            raise ConnectionError("server closed")
        return resp

    def hello(self) -> dict:
        h, _ = self._rpc({"cmd": "hello"})
        return h

    def metrics(self) -> dict:
        """Daemon counters: uptime, connections/requests/frames served,
        errors, active/parked sessions."""
        h, _ = self._rpc({"cmd": "metrics"})
        if not h.get("ok"):
            raise RuntimeError(h.get("error"))
        return h

    @staticmethod
    def _decode_maps(h: dict, body: bytes) -> np.ndarray:
        shape = tuple(h["shape"])
        if h.get("packed"):  # bit-packed THRESHOLD masks (ops/wire.py)
            from ..ops import wire
            hh, w = shape[-3], shape[-2]
            if h.get("padded"):  # device-packed padded planes, verbatim
                hp, wp = h["padded"]
                rows = np.frombuffer(body, np.uint8).reshape(
                    *shape[:-3], 1, hp // 8, wp)
                mask = wire.unpack_mask_host(rows, hh)[..., :w]
                return np.moveaxis(mask, -3, -1)
            rows = np.frombuffer(body, np.uint8).reshape(
                *shape[:-3], (hh + 7) // 8, w)
            return wire.unpack_mask_host(rows, hh)[..., None]
        return np.frombuffer(body, np.uint8).reshape(shape)

    def _note_events(self, h: dict) -> None:
        """On an --events daemon, every process reply carries the motion
        events that closed plus the open flag; mirror them here.  On an
        --auto-refresh daemon, ``last_refresh`` is the frame index where
        THIS reply re-pinned the session's baseline (None otherwise)."""
        if "events" in h:
            self.last_events = list(h["events"])
            self.event_open = bool(h.get("event_open"))
        self.last_refresh = h.get("baseline_refresh")

    def process(self, frame: np.ndarray, packed: bool = False
                ) -> Tuple[np.ndarray, np.ndarray]:
        """One-frame round trip.  ``packed=True`` asks the server to
        bit-pack THRESHOLD masks on the wire (8x smaller payload; ignored —
        and flagged off in the response — for other output modes).  On an
        ``--events`` daemon, ``self.last_events`` / ``self.event_open``
        reflect this reply's motion-event annotations."""
        h, body = self._rpc({"cmd": "process", "shape": list(frame.shape),
                             "packed": packed},
                            np.ascontiguousarray(frame).tobytes())
        if not h.get("ok"):
            raise RuntimeError(h.get("error"))
        self._note_events(h)
        return self._decode_maps(h, body), np.asarray(h["stats"], np.float32)

    def process_many(self, frames: np.ndarray, packed: bool = False
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched round trip: (N, H, W, 3) uint8 -> ((N, H, W, C) maps,
        (N, NUM_STATS) stats) in one request."""
        frames = np.ascontiguousarray(frames, np.uint8)
        h, body = self._rpc({"cmd": "process_batch",
                             "shape": list(frames.shape),
                             "packed": packed}, frames.tobytes())
        if not h.get("ok"):
            raise RuntimeError(h.get("error"))
        self._note_events(h)
        return self._decode_maps(h, body), np.asarray(h["stats"], np.float32)

    def snapshot(self) -> None:
        h, _ = self._rpc({"cmd": "snapshot"})
        if not h.get("ok"):
            raise RuntimeError(h.get("error"))

    def flicker(self) -> Tuple[np.ndarray, dict]:
        """This session's flicker amplitude map (H, W) f32 plus its
        metadata ({freq_hz, frames}); needs flicker_hz/flicker_fps."""
        h, body = self._rpc({"cmd": "flicker"})
        if not h.get("ok"):
            raise RuntimeError(h.get("error"))
        amp = np.frombuffer(body, np.float32).reshape(h["shape"])
        return amp, {"freq_hz": h["freq_hz"], "frames": h["frames"]}

    def reset(self) -> None:
        """Clear the session's streaming state (cursor, ring, baseline)."""
        h, _ = self._rpc({"cmd": "reset"})
        if not h.get("ok"):
            raise RuntimeError(h.get("error"))

    def save(self, path: str) -> None:
        h, _ = self._rpc({"cmd": "save", "path": path})
        if not h.get("ok"):
            raise RuntimeError(h.get("error"))

    def load(self, path: str) -> int:
        h, _ = self._rpc({"cmd": "load", "path": path})
        if not h.get("ok"):
            raise RuntimeError(h.get("error"))
        return int(h["frame_index"])

    def heatmap(self) -> np.ndarray:
        h, body = self._rpc({"cmd": "heatmap"})
        if not h.get("ok"):
            raise RuntimeError(h.get("error"))
        return np.frombuffer(body, np.float32).reshape(h["shape"])

    def close(self) -> None:
        try:
            h, _ = self._rpc({"cmd": "close"})
            if isinstance(h, dict):
                self._note_events(h)  # anonymous close flushes open events
        except ConnectionError:
            pass
        self._sock.close()


class ResilientDiPsClient:
    """Edge-camera client: :class:`DiPsClient` + automatic reconnection.

    Built for flaky links (cellular cameras, WAN backhaul): a connection
    failure mid-request reconnects with exponential backoff and resumes
    the parked session — a ``session`` token is therefore REQUIRED
    (resume is what makes reconnecting meaningful).  The INITIAL connect
    gets the same backoff: a camera that boots while the daemon is still
    coming up dials until it answers instead of dying at start-up.

    Streamed frames are accounted exactly-once against the server's
    session cursor: after a reconnect, ``hello`` reveals whether the
    in-flight frames were processed before the connection died.  If they
    never arrived they are resent transparently; if they WERE processed
    (the reply died on the wire) the client raises :class:`ReplyLost` —
    resending would double-process them — records them in
    ``dropped_replies``, and the next call continues the stream.  A
    server that lost the session's state entirely (daemon restart)
    resumes fresh with a warning.
    """

    def __init__(self, port: int, host: str = "127.0.0.1",
                 session: str = "", retries: int = 5,
                 backoff_s: float = 0.2, max_backoff_s: float = 5.0,
                 roi: Optional[Tuple[int, int, int, int]] = None,
                 flicker_hz: Optional[float] = None,
                 flicker_fps: Optional[float] = None):
        if not session:
            raise ValueError("ResilientDiPsClient requires a session token "
                             "(reconnects resume the parked session)")
        self.port, self.host, self.session = int(port), host, str(session)
        self.roi = None if roi is None else tuple(int(v) for v in roi)
        #: per-session flicker analysis, re-bound on every reconnect (the
        #: parked window itself survives with the named session)
        self.flicker_hz = flicker_hz
        self.flicker_fps = flicker_fps
        self.retries = int(retries)
        self.backoff_s, self.max_backoff_s = backoff_s, max_backoff_s
        #: frames whose processing is confirmed server-side
        self._cursor = 0
        #: frames processed by the server whose replies died on the wire
        self.dropped_replies = 0
        self._cli = None
        # the initial connect gets the same backoff as reconnects: an
        # edge camera often boots before (or during) a daemon restart
        self._cursor = self._dial()

    #: network failures worth a reconnect (ConnectionError/BrokenPipe/
    #: timeout are all OSError subclasses)
    _NET_ERRORS = (OSError,)

    def _dial(self) -> int:
        """Connect (with exponential backoff) + resume; returns the
        server's session cursor."""
        delay = self.backoff_s
        for attempt in range(self.retries + 1):
            try:
                self._cli = DiPsClient(self.port, self.host,
                                       session=self.session, roi=self.roi,
                                       flicker_hz=self.flicker_hz,
                                       flicker_fps=self.flicker_fps)
                return int(self._cli.hello().get("frame_index", 0))
            except self._NET_ERRORS:
                if attempt == self.retries:
                    break
                time.sleep(delay)
                delay = min(delay * 2, self.max_backoff_s)
        raise ConnectionError(
            f"could not connect to {self.host}:{self.port} after "
            f"{self.retries + 1} attempts")

    def _reconnect(self) -> int:
        """Drop the dead connection and dial again."""
        if self._cli is not None:
            try:
                self._cli._sock.close()
            except OSError:
                pass
        return self._dial()

    def process(self, frame: np.ndarray, packed: bool = False
                ) -> Tuple[np.ndarray, np.ndarray]:
        outs, stats = self.process_many(frame[None], packed=packed)
        return outs[0], stats[0]

    def process_many(self, frames: np.ndarray, packed: bool = False
                     ) -> Tuple[np.ndarray, np.ndarray]:
        frames = np.ascontiguousarray(frames, np.uint8)
        n = len(frames)
        attempts = 0
        while True:
            try:
                outs, stats = self._cli.process_many(frames, packed=packed)
                self._cursor += n
                return outs, stats
            except self._NET_ERRORS:
                attempts += 1
                if attempts > self.retries:
                    raise
                server_ci = self._reconnect()
                if server_ci >= self._cursor + n:
                    # the batch WAS processed; only the reply was lost
                    self._cursor = server_ci
                    self.dropped_replies += n
                    raise ReplyLost(n)
                if server_ci < self._cursor:
                    log.warning(
                        "session %r state lost server-side (cursor %d < "
                        "confirmed %d): resuming fresh", self.session,
                        server_ci, self._cursor)
                self._cursor = server_ci
                # not processed: loop resends the same frames

    def _retry(self, fn):
        """Run an IDEMPOTENT command, reconnecting on network failure."""
        attempts = 0
        while True:
            try:
                return fn(self._cli)
            except self._NET_ERRORS:
                attempts += 1
                if attempts > self.retries:
                    raise
                self._cursor = self._reconnect()

    @property
    def last_events(self) -> list:
        """Motion events from the last process reply (``--events``
        daemons).  Empty right after a reconnect until the next reply —
        an open event itself survives server-side with the parked
        session."""
        return self._cli.last_events if self._cli is not None else []

    @property
    def event_open(self) -> bool:
        return bool(self._cli is not None and self._cli.event_open)

    @property
    def last_refresh(self) -> Optional[int]:
        """Frame index where the last process reply re-pinned the baseline
        (``--auto-refresh`` daemons), else None."""
        return self._cli.last_refresh if self._cli is not None else None

    def hello(self) -> dict:
        return self._retry(lambda c: c.hello())

    def metrics(self) -> dict:
        return self._retry(lambda c: c.metrics())

    def snapshot(self) -> None:
        self._retry(lambda c: c.snapshot())

    def heatmap(self) -> np.ndarray:
        return self._retry(lambda c: c.heatmap())

    def save(self, path: str) -> None:
        self._retry(lambda c: c.save(path))

    def load(self, path: str) -> int:
        ci = self._retry(lambda c: c.load(path))
        self._cursor = int(ci)
        return int(ci)

    def reset(self) -> None:
        self._retry(lambda c: c.reset())
        self._cursor = 0

    def close(self) -> None:
        if self._cli is None:
            return
        try:
            self._cli.close()
        except self._NET_ERRORS:
            pass

    def __enter__(self) -> "ResilientDiPsClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
