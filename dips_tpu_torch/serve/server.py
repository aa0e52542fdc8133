"""The serving daemon core: accept loop, per-connection sessions and the
request dispatcher (see the package docstring for the wire protocol).

Counterpart of ``dips_tpu/serve/server.py``: the sessions run the port's
engines on ``device`` ("cuda" by default; "cpu" must be asked for)."""

from __future__ import annotations

import glob
import json
import logging
import os
import socket
import threading
import time
from typing import Optional

import numpy as np

from ..models import DiPsEngine
from ..models.pipeline import resolve_device
from ..properties import GEOMETRY_NAMES, DiPsProperties, parse_geometry
from .analytics import AnalyticsMixin
from .coalesce import StreamCoalescer, _CoalescedSession
from .metrics import _start_metrics_http
from .protocol import _LEN, _PARTIAL_TIMEOUT_S, _process_reply, _recv
from .sessions import SessionMixin

log = logging.getLogger("dips_tpu.serve")


def _send(sock: socket.socket, header: dict, payload: bytes = b"") -> None:
    """``protocol._send`` under a stall deadline: each ``send`` waits at
    most ``_PARTIAL_TIMEOUT_S`` for room in the socket buffer, and every
    byte that leaves restarts that clock, as ``_recv_exact`` does for
    reads.  (A socket timeout bounds a whole ``sendall``: 100 MB of 1080p
    maps to a slow link outlast any fixed bound, and a reply cut part-way
    desyncs the client's stream.)  A full stall shuts the socket down, so
    that no later message lands behind the partial one, and raises
    ``socket.timeout``; the socket's own timeout is restored."""
    hdr = json.dumps(header).encode()
    poll = sock.gettimeout()
    sock.settimeout(_PARTIAL_TIMEOUT_S)
    try:
        for part in (_LEN.pack(len(hdr)) + hdr, payload):
            view = memoryview(part).cast("B")
            while view:
                view = view[sock.send(view):]
    except socket.timeout:
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        raise
    finally:
        sock.settimeout(poll)


class DiPsServer(SessionMixin, AnalyticsMixin):
    """Serves up to ``max_sessions`` concurrent clients on a TCP port, each
    with its own engine (private streaming state on the shared card).

    ``device``: "cuda" (the default: the current card, and a coalescer's
    mesh over the visible cards), "cuda:N" or "cpu" (every mesh cell on
    that one device).  Without a card "cuda" raises
    :class:`~dips_tpu_torch.errors.DeviceError` here, before any session.

    ``coalesce=N`` switches to the shared stacked-stream dispatcher: N
    session slots on ONE :class:`StreamCoalescer` (see its docstring);
    every command keeps working, including per-slot ``save``/``load``
    (checkpoints are ``DiPsEngine``-format, so sessions migrate between
    dedicated and coalesced servers)."""
    def __init__(self, props: DiPsProperties,
                 height: Optional[int] = None, width: Optional[int] = None,
                 port: int = 0, host: str = "127.0.0.1", batch: int = 1,
                 device="cuda", max_sessions: int = 1,
                 packed_wire: bool = False, coalesce: int = 0,
                 coalesce_window_ms: float = 2.0, coalesce_devices: int = 1,
                 coalesce_mesh=None,
                 input_layout: str = "planar",
                 metrics_port: Optional[int] = None,
                 autosave_dir: Optional[str] = None,
                 autosave_every: int = 256,
                 events: Optional[dict] = None,
                 event_webhook: Optional[str] = None,
                 downscale: int = 1,
                 auto_refresh: Optional[dict] = None):
        #: the device every session's engine runs on (fails without a card
        #: unless "cpu" was asked for)
        self.device = resolve_device(device)
        #: daemon-wide on-device input decimation (``--downscale K``):
        #: every session's engine analyzes at 1/K scale (k x k box mean
        #: inside the device layout prep — DiPsEngine.downscale).  Clients
        #: keep sending full-res frames; reply maps/stats are at the
        #: decimated geometry (``hello``'s config carries both).  Session
        #: geometry keys (pooling, flexible sizing) stay in INPUT dims.
        self.downscale = max(1, int(downscale))
        #: per-session motion-event segmentation (ops/events.py): a dict
        #: of MotionDetector kwargs (on_threshold may be "auto"; pixels is
        #: filled in per session from its geometry).  process replies gain
        #: ``events`` (closed this request) + ``event_open``; a graceful
        #: close flushes the open event into its reply.  None disables.
        self.event_cfg = dict(events) if events is not None else None
        if self.event_cfg is not None:
            # validate NOW: a bad threshold combination must refuse to
            # start the daemon, not error every process request after the
            # engine state already advanced
            from ..ops.events import MotionDetector
            probe = dict(self.event_cfg)
            if probe.get("metric") == "changed_frac":
                probe.setdefault("pixels", 1)
            MotionDetector(**probe)
        #: per-session adaptive baseline refresh (ops/refresh.py): a dict
        #: of BaselineRefreshPolicy kwargs — each session gets its own
        #: policy over its reply stats, and a wholesale scene change on
        #: that camera re-pins ITS baseline (the automated SnapShot
        #: button; unattended fleet cameras are exactly the use case).
        #: The fired reply carries ``baseline_refresh``: the frame index.
        #: OVERALL method only; None disables.
        self.refresh_cfg = (dict(auto_refresh) if auto_refresh is not None
                            else None)
        if self.refresh_cfg is not None:
            from ..properties import DiPsMethod
            if props.method is not DiPsMethod.OVERALL:
                raise ValueError(
                    "auto_refresh re-pins the OVERALL baseline; "
                    "method=per_frame has none")
            # validate NOW, same contract as event_cfg below
            from ..ops.refresh import BaselineRefreshPolicy
            probe = dict(self.refresh_cfg)
            if probe.get("metric", "changed_frac") == "changed_frac":
                probe.setdefault("pixels", 1)
            probe.setdefault("cooldown", 0)
            BaselineRefreshPolicy(**probe)
        #: push alerts: every closed motion event is POSTed (JSON, async
        #: best-effort, bounded queue — see utils/webhook.py) to this URL,
        #: so a fleet gets notifications without polling process replies.
        self._webhook = None
        if event_webhook is not None:
            if self.event_cfg is None:
                raise ValueError("event_webhook requires events: nothing "
                                 "fires without a motion detector "
                                 "(--events)")
            from ..utils.webhook import WebhookSender
            self._webhook = WebhookSender(
                event_webhook,
                on_result=lambda outcome: self._count(f"webhook_{outcome}"))
        #: crash-safety checkpoints for NAMED sessions: every
        #: ``autosave_every`` processed frames (and on graceful close) a
        #: session's streaming state is written to
        #: ``autosave_dir/<token>.npz`` (atomic tmp+rename); after a daemon
        #: restart, the first bind of that token restores it, so a fleet
        #: survives a crash with at most ``autosave_every`` frames of
        #: baseline drift instead of resuming fresh.  None disables.
        self.autosave_dir = autosave_dir
        self.autosave_every = max(1, int(autosave_every))
        if autosave_dir is not None:
            os.makedirs(autosave_dir, exist_ok=True)
            # a crash mid-autosave leaves an orphaned tmp file behind; the
            # '#' marker cannot appear in a quote()-escaped token, so these
            # are never live checkpoints.  Only sweep OLD ones: during a
            # fast restart the previous daemon can still be mid-save, and
            # deleting its in-flight tmp makes its os.replace fail.
            now = time.time()
            for stale in glob.glob(os.path.join(autosave_dir,
                                                "*.#tmp#*.npz")):
                try:
                    if now - os.path.getmtime(stale) > 60.0:
                        os.remove(stale)
                except OSError:
                    pass
        self._coalescer: Optional[StreamCoalescer] = None
        self._coalesce_cfg: Optional[dict] = None
        self._coalescers: dict = {}   # flexible mode: (h, w) -> coalescer
        self._props = props
        #: geometry-flexible daemon: no fixed height/width — each session's
        #: engine is sized from its FIRST frame (or checkpoint), and idle
        #: engines/coalescers pool per geometry.  One daemon serves a
        #: mixed camera fleet; with ``coalesce=N`` each geometry gets its
        #: own lazily-created stacked-stream coalescer (a stacked kernel
        #: shape is per geometry).
        self.flexible = height is None or width is None
        if coalesce > 0:
            if packed_wire:
                raise ValueError("packed_wire (device packing) is not "
                                 "available with coalesce; clients can "
                                 "still request host-packed masks")
            self._coalesce_cfg = dict(
                n_streams=coalesce, batch=batch, device=device,
                window_ms=coalesce_window_ms, n_devices=coalesce_devices,
                mesh_shape=(tuple(int(v) for v in coalesce_mesh)
                            if coalesce_mesh is not None else None),
                input_layout=input_layout, downscale=self.downscale)
            if not self.flexible:
                self._coalescer = StreamCoalescer(props, height, width,
                                                  **self._coalesce_cfg)
            self.engine = None  # sessions share the coalescers' engines
            max_sessions = max(int(max_sessions), coalesce)
        elif self.flexible:
            self._mk_engine = lambda h, w, p=None: DiPsEngine(
                p or props, h, w, batch=batch, device=self.device,
                packed_wire=packed_wire, input_layout=input_layout,
                downscale=self.downscale)
            self.engine = None
        else:
            self._mk_engine = lambda p=None: DiPsEngine(
                p or props, height, width, batch=batch, device=self.device,
                packed_wire=packed_wire, input_layout=input_layout,
                downscale=self.downscale)
            #: the default session engine (kept for embedding/back-compat)
            self.engine = self._mk_engine()
        self.max_sessions = max(1, int(max_sessions))
        self._sessions = threading.Semaphore(self.max_sessions)
        # Engine pool.  Anonymous engines return here when a session ends;
        # on a SINGLE-session server the lone engine unambiguously resumes
        # a reconnecting client, on a multi-session server pooled engines
        # are reset before reuse (no cross-client state leaks).  Clients
        # that want resume on a multi-session server tag requests with a
        # "session" token; those engines park in _named keyed by token.
        #: idle anonymous engines: a list in fixed mode, a per-geometry
        #: dict {(h, w): [engines]} on a flexible daemon
        self._pool = ({} if self.flexible
                      else ([] if self.engine is None else [self.engine]))
        self._named: dict = {}   # session token -> parked engine
        #: token -> live connection socket: a NEW connection with the same
        #: token kicks the old holder (latest-wins, device-shadow style)
        #: and waits for its state to park before resuming it
        self._active: dict = {}
        #: parked named sessions beyond this are evicted oldest-first
        self.max_named_sessions = 8 * self.max_sessions
        #: flexible-daemon bounds on idle device state under geometry
        #: churn: total idle pooled engines, and registered per-geometry
        #: coalescers (idle ones beyond the cap are evicted; live ones
        #: never are).  warm_geometries raises them as needed.
        self.max_pooled_engines = max(8, self.max_sessions)
        self.max_geometries = 8
        self._pool_lock = threading.Lock()
        self._threads: list = []
        #: live accepted sockets: shutdown() force-closes them so the
        #: port frees immediately (a lingering ESTABLISHED socket blocks
        #: a same-port rebind — the systemd fast-restart case)
        self._client_socks: set = set()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(self.max_sessions)
        self.port = self._sock.getsockname()[1]
        self._wake_host = host if host not in ("", "0.0.0.0") \
            else "127.0.0.1"
        self._stop = threading.Event()
        self._accept_done = threading.Event()
        self._accepting = False
        self._accept_thread: Optional[threading.Thread] = None
        self._started = time.monotonic()
        # observability counters (served by the "metrics" command);
        # guarded by _metrics_lock, incremented on the session threads
        self._metrics_lock = threading.Lock()
        self._counters = {"connections": 0, "requests": 0, "frames": 0,
                          "request_errors": 0, "rejected": 0,
                          "active_sessions": 0,
                          # fleet-link health: abortive disconnects and
                          # latest-wins token takeovers (reconnect storms
                          # show up here before anywhere else)
                          "link_drops": 0, "takeovers": 0,
                          # crash-safety checkpoints written / sessions
                          # restored from one after a daemon restart
                          "autosaves": 0, "autorestores": 0,
                          # closed motion events across all sessions
                          # (served only when the daemon runs --events)
                          "motion_events": 0,
                          # adaptive baseline re-pins across all sessions
                          # (counts only when the daemon runs
                          # --auto-refresh)
                          "auto_refreshes": 0,
                          # --event-webhook delivery outcomes (stay zero
                          # without one configured)
                          "webhook_delivered": 0, "webhook_failed": 0,
                          "webhook_dropped": 0}
        # optional Prometheus scrape endpoint (GET /metrics)
        self._metrics_httpd = None
        self.metrics_port: Optional[int] = None
        if metrics_port is not None:
            self._metrics_httpd = _start_metrics_http(self, metrics_port,
                                                      host)
            self.metrics_port = self._metrics_httpd.server_address[1]
        import collections
        #: service time of the last 1024 process/process_batch requests
        #: (seconds; includes any coalescer wait), for latency percentiles
        self._latencies = collections.deque(maxlen=1024)

    #: named geometry shorthand accepted by warm_geometries / --warm
    GEOMETRY_NAMES = GEOMETRY_NAMES

    def warm_geometries(self, geometries) -> None:
        """Pre-build pooled engines for the given geometries and drive
        one frame through each, so the FIRST camera of each resolution
        does not pay the first-use latency (on a card, the first launch
        in the process builds the CUDA kernels).  Each entry is "HxW" or
        a name ("480p", "720p", "1080p", "4k").  Flexible daemons pool
        the warmed engines per geometry; fixed daemons accept only their
        own geometry."""
        for g in geometries:
            h, w = parse_geometry(g)
            if self._coalesce_cfg is not None:
                # coalesced: create (or pick) the geometry's coalescer and
                # drive one dummy frame through a slot: its first launch
                if self._coalescer is not None:
                    ce = self._coalescer.engine
                    if (h, w) != (ce.in_height, ce.in_width):
                        raise ValueError(
                            f"warm geometry {h}x{w} != fixed server "
                            f"{ce.in_height}x{ce.in_width}")
                # warming N geometries implies keeping N alive
                self.max_geometries = max(self.max_geometries,
                                          len(geometries))
                co = self._co_for((h, w))
                slot = co.bind()
                try:
                    co.submit(slot, [np.zeros((h, w, 3), np.uint8)])
                finally:
                    co.release(slot)  # non-park release resets the slot
                log.info("warmed %dx%d", h, w)
                continue
            if not self.flexible:
                if (h, w) != (self.engine.in_height, self.engine.in_width):
                    raise ValueError(
                        f"warm geometry {h}x{w} != fixed server "
                        f"{self.engine.in_height}x{self.engine.in_width}")
                eng = self.engine
            else:
                eng = self._mk_engine(h, w)
            # one dummy frame drives the first launch; reset clears state
            eng.process_frames(
                [np.zeros((h, w, 3), np.uint8)])
            eng.reset()
            if self.flexible:
                with self._pool_lock:
                    self.max_pooled_engines = max(self.max_pooled_engines,
                                                  len(geometries))
                    self._pool_idle_engine(eng)
            log.info("warmed %dx%d", h, w)

    def _count(self, key: str, n: int = 1) -> None:
        with self._metrics_lock:
            self._counters[key] += n

    def _observe_latency(self, seconds: float) -> None:
        with self._metrics_lock:
            self._latencies.append(seconds)

    def metrics(self) -> dict:
        """Daemon-level counters + live session/parked state (the `metrics`
        wire command returns exactly this)."""
        with self._metrics_lock:
            c = dict(self._counters)
            lats = sorted(self._latencies)
        with self._pool_lock:
            c["parked_sessions"] = len(self._named)
        c["max_sessions"] = self.max_sessions
        c["uptime_s"] = round(time.monotonic() - self._started, 3)
        c["coalesced"] = self._coalesce_cfg is not None
        if (self._coalesce_cfg is not None
                and self._coalesce_cfg.get("mesh_shape")):
            # row-sharded big-frame serving (--coalesce-mesh): operators
            # can confirm the grid from metrics alone
            c["coalesce_mesh"] = "x".join(
                str(v) for v in self._coalesce_cfg["mesh_shape"])
        c["flexible"] = self.flexible
        if self.flexible and self._coalesce_cfg is None:
            with self._pool_lock:
                c["pooled_engines"] = {f"{h}x{w}": len(v)
                                       for (h, w), v in self._pool.items()
                                       if v}
        if lats:
            def q(p):
                return round(1e3 * lats[min(len(lats) - 1,
                                            int(p * len(lats)))], 3)
            c["latency_ms"] = {"count": len(lats), "p50": q(0.50),
                               "p90": q(0.90), "p99": q(0.99),
                               "max": round(1e3 * lats[-1], 3)}
        if self._coalesce_cfg is not None:
            with self._pool_lock:
                cos = ([self._coalescer] if self._coalescer is not None
                       else list(self._coalescers.values()))
            disp = folded = 0
            for co in cos:
                with co._cv:
                    disp += co.dispatches
                    folded += co.frames_folded
            c["coalesce_dispatches"] = disp
            c["coalesce_mean_fill"] = (round(folded / disp, 3) if disp
                                       else 0.0)
        return c

    def serve_forever(self) -> None:
        log.info("serving on port %d (max %d sessions)", self.port,
                 self.max_sessions)
        self._accept_thread = threading.current_thread()
        self._accepting = True
        try:
            self._accept_loop()
        finally:
            # the listener must die HERE, on the accepting thread: a
            # close() from another thread while accept() is in flight
            # leaves the kernel socket alive (and LISTENING) until the
            # syscall returns, which blocks a same-port daemon restart
            try:
                self._sock.close()
            except OSError:
                pass
            self._accept_done.set()
        for th in self._threads:
            th.join(timeout=5.0)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._sock.settimeout(0.5)
                client, addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            if self._stop.is_set():  # shutdown()'s wake-up connection
                try:
                    client.close()
                except OSError:
                    pass
                break
            # brief grace so a just-closed session's slot can free up
            if not self._sessions.acquire(timeout=1.0):
                self._count("rejected")
                log.warning("rejecting %s: %d sessions busy", addr,
                            self.max_sessions)
                try:
                    with client:
                        _send(client, {"ok": False,
                                       "error": "server at session limit"})
                except OSError:
                    pass
                continue
            th = threading.Thread(target=self._session, args=(client, addr),
                                  daemon=True)
            self._threads = [t for t in self._threads if t.is_alive()]
            self._threads.append(th)
            th.start()
    def _session(self, client: socket.socket, addr) -> None:
        # the engine binds INSIDE _serve_client; the holder hands it back
        # even when the connection dies mid-request (ConnectionResetError
        # etc.) — an abortive disconnect must park/pool the engine, never
        # leak it (or its coalescer slot)
        bound: list = []
        self._count("connections")
        self._count("active_sessions")
        with self._pool_lock:
            self._client_socks.add(client)
        try:
            with client:
                log.info("client %s", addr)
                try:
                    self._serve_client(client, bound)
                except (ConnectionResetError, BrokenPipeError) as e:
                    # routine for edge fleets (RST on cell links, token
                    # takeover kicks): one line, not a traceback
                    self._count("link_drops")
                    log.info("client %s link dropped (%s)", addr, e)
                except Exception:
                    # one bad/broken client must never kill the daemon
                    log.exception("client %s dropped", addr)
        finally:
            try:
                if bound:
                    self._release_engine(bound[0])
            except Exception:
                # release can touch the device (coalescer reset_stream);
                # a transient failure there must not skip the bookkeeping
                # below or the session slot leaks until restart
                log.exception("releasing engine for %s failed", addr)
            finally:
                with self._pool_lock:
                    self._client_socks.discard(client)
                    for tok in [t for t, c in self._active.items()
                                if c is client]:
                        del self._active[tok]
                self._count("active_sessions", -1)
                self._sessions.release()

    def _serve_client(self, client: socket.socket, bound: list):
        """Serve one connection.  The engine bound at the first request is
        appended to ``bound`` so _session can park it on ANY exit path,
        including a mid-request exception."""
        eng = None
        # periodic timeout so shutdown() can interrupt an idle connection
        client.settimeout(0.5)
        while not self._stop.is_set():
            try:
                msg = _recv(client)
            except socket.timeout:
                continue
            except (ValueError, json.JSONDecodeError) as e:
                log.warning("protocol error: %s", e)
                try:
                    _send(client, {"ok": False, "error": str(e)})
                except OSError:
                    pass
                return
            if msg is None:
                return
            header, payload = msg
            cmd = header.get("cmd")
            if eng is None:  # first request binds the session's engine
                token = header.get("session")
                tok = str(token) if token is not None else None
                geometry = None
                if cmd in ("process", "process_batch"):
                    shp = header.get("shape") or ()
                    if len(shp) >= 3:
                        try:
                            geometry = (int(shp[-3]), int(shp[-2]))
                        except (TypeError, ValueError) as e:
                            self._count("request_errors")
                            _send(client, {"ok": False,
                                           "error": f"bad shape: {e}"})
                            continue
                elif cmd == "load" and self.flexible:
                    try:  # peek the checkpoint's geometry to size the engine
                        geometry = self._peek_geometry(header["path"])
                        if geometry is not None and self.downscale > 1:
                            # checkpoints store ANALYSIS dims; sessions
                            # are sized by their input geometry
                            geometry = tuple(v * self.downscale
                                             for v in geometry)
                    except Exception as e:
                        self._count("request_errors")
                        _send(client, {"ok": False, "error": str(e)})
                        continue
                if self.flexible and geometry is None:
                    if tok is not None:
                        # a reconnect can race the old connection's park:
                        # kick + wait BEFORE the parked check, or the
                        # pre-bind hello below reports frame_index 0 and
                        # the client wrongly concludes its state is gone
                        self._takeover_token(tok, client)
                    with self._pool_lock:
                        parked = tok is not None and tok in self._named
                    if (not parked and tok is not None
                            and self.autosave_dir is not None
                            and cmd not in ("metrics", "close")):
                        # daemon restart: recover the session's geometry
                        # from its autosave so even a pre-bind hello binds,
                        # restores, and reports the TRUE cursor (a 0 here
                        # would make a resilient client resume fresh).
                        # metrics/close stay bind-free — a monitoring
                        # scrape must not trigger checkpoint IO + a build.
                        # A corrupt file (ANY load error, not just OSError)
                        # reads as no geometry: the session starts fresh
                        # instead of bricking the token's reconnect path.
                        try:
                            geometry = self._peek_geometry(
                                self._autosave_path(tok))
                            if geometry is not None and self.downscale > 1:
                                geometry = tuple(v * self.downscale
                                                 for v in geometry)
                        except Exception:
                            pass
                    if not parked and geometry is None:
                        # geometry-free commands answer without binding;
                        # state commands need a frame/checkpoint first
                        if cmd == "hello":
                            _send(client, {
                                "ok": True, "frame_index": 0,
                                "config": {
                                    "height": None, "width": None,
                                    "flexible": True, "roi": None,
                                    "downscale": self.downscale,
                                    "coalesced":
                                        self._coalesce_cfg is not None}})
                            continue
                        if cmd == "metrics":
                            self._count("requests")
                            _send(client, dict(self.metrics(), ok=True,
                                               frame_index=0))
                            continue
                        if cmd == "close":
                            _send(client, {"ok": True})
                            return
                roi = header.get("roi")
                if roi is not None:
                    try:
                        roi = tuple(int(v) for v in roi)
                        if len(roi) != 4:
                            raise ValueError
                    except (TypeError, ValueError):
                        self._count("request_errors")
                        _send(client, {"ok": False,
                                       "error": f"bad roi {header['roi']!r}"
                                                " (want [y0, x0, y1, x1])"})
                        continue
                if tok is not None:
                    self._takeover_token(tok, client)
                try:
                    eng = self._bind_engine(tok, geometry, roi)
                    bound.append(eng)
                except Exception as e:
                    self._count("request_errors")
                    _send(client, {"ok": False, "error": str(e)})
                    continue
                if tok is not None:
                    with self._pool_lock:
                        self._active[tok] = client
            self._count("requests")
            try:
                if header.get("flicker_hz") is not None \
                        or header.get("flicker_fps") is not None:
                    # (re-)attach the session's flicker analyzer: no-op
                    # when one with the same parameters is already bound,
                    # fresh after reset/load dropped it, an error on a
                    # parameter mismatch (clients carry the params on
                    # every request)
                    self._bind_flicker(eng, header)
                if cmd in ("process", "process_batch"):
                    n_frames = (1 if cmd == "process"
                                else int(header["shape"][0]))
                    self._count("frames", n_frames)
                if cmd == "metrics":
                    m = self.metrics()
                    m["frame_index"] = eng.frame_index
                    _send(client, dict(m, ok=True))
                elif cmd == "hello":
                    _send(client, {
                        "ok": True,
                        "frame_index": eng.frame_index,
                        "config": {
                            "height": eng.height, "width": eng.width,
                            "batch": eng.batch,
                            # the CUDA kernels, or their plain twins
                            "backend": ("kernel" if eng.device.type == "cuda"
                                        else "plain"),
                            "method": eng.props.method.name,
                            "output": eng.props.output.name,
                            "roi": (list(eng.props.roi)
                                    if eng.props.roi else None),
                            # height/width above are the ANALYSIS dims
                            # (what replies are shaped as); with
                            # downscale > 1, frames must arrive at
                            # input_height/input_width
                            "downscale": self.downscale,
                            "input_height": getattr(eng, "in_height",
                                                    eng.height),
                            "input_width": getattr(eng, "in_width",
                                                   eng.width),
                            "coalesced": isinstance(eng, _CoalescedSession),
                            "auto_refresh": self.refresh_cfg is not None,
                        }})
                elif cmd == "process":
                    shape = tuple(header["shape"])
                    frame = np.frombuffer(payload, np.uint8).reshape(shape)
                    t0 = time.monotonic()
                    hdr, body = _process_reply(eng, [frame], header)
                    self._observe_latency(time.monotonic() - t0)
                    self._apply_events(eng, hdr, n_frames)
                    self._apply_refresh(eng, hdr, n_frames)
                    hdr["stats"] = hdr["stats"][0]
                    hdr["shape"] = hdr["shape"][1:]  # per-frame shape
                    _send(client, hdr, body)
                    fl = getattr(eng, "_flicker", None)
                    if fl is not None:
                        # after the reply: the analyzer is only read by a
                        # later "flicker" command, so its dispatch must
                        # not sit in this request's latency
                        fl.update(frame)
                    self._maybe_autosave(eng, n_frames)
                elif cmd == "process_batch":
                    shape = tuple(header["shape"])
                    frames = np.frombuffer(payload, np.uint8).reshape(shape)
                    t0 = time.monotonic()
                    hdr, body = _process_reply(eng, frames, header)
                    self._observe_latency(time.monotonic() - t0)
                    self._apply_events(eng, hdr, n_frames)
                    self._apply_refresh(eng, hdr, n_frames)
                    _send(client, hdr, body)
                    fl = getattr(eng, "_flicker", None)
                    if fl is not None:
                        fl.update(frames)  # post-reply, see "process"
                    self._maybe_autosave(eng, n_frames)
                elif cmd == "snapshot":
                    eng.snapshot()
                    _send(client, {"ok": True})
                elif cmd == "flicker":
                    fl = getattr(eng, "_flicker", None)
                    if fl is None:
                        raise ValueError(
                            "session has no flicker analyzer: bind with "
                            "flicker_hz + flicker_fps "
                            "(DiPsClient(flicker_hz=..., flicker_fps=...))")
                    amp = fl.amplitude().astype(np.float32)
                    body = amp.tobytes()
                    _send(client, {"ok": True, "shape": list(amp.shape),
                                   "freq_hz": fl.freq_hz,
                                   "frames": fl.frames_seen,
                                   "payload_len": len(body)}, body)
                elif cmd == "heatmap":
                    hm = eng.heatmap().astype(np.float32)
                    body = hm.tobytes()
                    _send(client, {"ok": True, "shape": list(hm.shape),
                                   "payload_len": len(body)}, body)
                elif cmd == "save":
                    eng.save(str(header["path"]))
                    _send(client, {"ok": True})
                elif cmd == "load":
                    eng.load(str(header["path"]))
                    # the restored cursor may jump anywhere: segmentation
                    # restarts (an open event cannot span a state swap)
                    eng._motion_det = None
                    eng._flicker = None  # rebound from the next request
                    if isinstance(eng, _CoalescedSession):
                        # the fleet analyzer's slot must restart too (a
                        # rebind would otherwise resume the pre-load
                        # window across the state swap)
                        eng._co.unbind_flicker(eng.slot)
                    _send(client, {"ok": True,
                                   "frame_index": eng.frame_index})
                elif cmd == "reset":
                    eng.reset()
                    eng._motion_det = None
                    eng._flicker = None  # rebound from the next request
                    tok = getattr(eng, "session_token", None)
                    if self.autosave_dir is not None and tok is not None:
                        # explicit state discard also discards the
                        # crash-safety checkpoint (a restart must not
                        # resurrect what the client reset)
                        eng._autosave_due = 0
                        try:
                            os.remove(self._autosave_path(tok))
                        except OSError:
                            pass
                    _send(client, {"ok": True})
                elif cmd == "close":
                    reply = {"ok": True}
                    tok = getattr(eng, "session_token", None)
                    det = getattr(eng, "_motion_det", None)
                    if det is not None and tok is None:
                        # anonymous close = end of stream: flush the open
                        # event into the goodbye (named sessions keep it
                        # open across park/resume instead)
                        flushed = det.flush()
                        reply["events"] = [e.to_dict() for e in flushed]
                        self._count("motion_events", len(flushed))
                        self._post_webhook(eng, flushed)
                    # a graceful goodbye flushes any unsaved tail first
                    self._maybe_autosave(eng, force=True)
                    # park BEFORE replying: when the client's close()
                    # returns, a reconnect is guaranteed to find the
                    # parked state (no release/rebind race)
                    self._release_engine(eng)
                    bound.clear()
                    eng = None
                    _send(client, reply)
                    return
                else:
                    _send(client, {"ok": False,
                                   "error": f"unknown cmd {cmd!r}"})
            except Exception as e:  # per-request isolation
                self._count("request_errors")
                log.exception("request failed")
                try:
                    _send(client, {"ok": False, "error": str(e)})
                except OSError:
                    return  # client gone mid-error: drop the connection

    def shutdown(self) -> None:
        self._stop.set()
        # Reading _accepting here is race-free: _stop is set first, and
        # _accept_loop checks _stop before every accept(), so if we read
        # False the loop either already exited or will exit before its
        # first accept — no syscall can be left in flight unseen.
        #
        # When shutdown() runs ON the accepting thread itself (a signal
        # handler suspending the accept loop — the daemon's SIGTERM path),
        # skip the wake/wait handshake: no accept syscall is in flight
        # while the handler runs, so closing the listener below genuinely
        # frees the port, and waiting on _accept_done would self-deadlock
        # (only this thread's serve_forever can set it) and burn the full
        # timeout on every daemon stop.
        on_accept_thread = (self._accept_thread is
                            threading.current_thread())
        if self._accepting and not on_accept_thread:
            # wake a blocked accept() NOW (the in-flight syscall keeps the
            # kernel socket listening even after close()), then wait for
            # the accepting thread to close the listener itself — the
            # port must be genuinely free when shutdown() returns, or a
            # same-port daemon restart races EADDRINUSE
            try:
                with socket.create_connection(
                        (self._wake_host, self.port), timeout=1.0):
                    pass
            except OSError:
                pass
            self._accept_done.wait(timeout=5.0)
        with self._pool_lock:
            cos = ([self._coalescer] if self._coalescer is not None
                   else list(self._coalescers.values()))
        for co in cos:
            co.shutdown()
        if self._metrics_httpd is not None:
            self._metrics_httpd.shutdown()
            self._metrics_httpd.server_close()
        try:
            self._sock.close()
        except OSError:
            pass
        # force-close live session sockets: their ESTABLISHED state would
        # otherwise hold TCP state against the freed port
        with self._pool_lock:
            socks = list(self._client_socks)
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        if self._webhook is not None:
            # bounded flush: pending alerts get a moment to deliver, a
            # dead receiver cannot hold the daemon's stop hostage
            self._webhook.close(flush_timeout_s=2.0)

