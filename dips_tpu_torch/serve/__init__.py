"""Frame-serving daemon: a TCP service around :class:`DiPsEngine`.

The port of ``dips_tpu/serve/`` onto the port's engines, with the same wire
protocol, commands, flags, metrics and checkpoint files: a client or a
checkpoint of either package works with the other's daemon.  The sessions
run on one device, "cuda" by default (``DiPsServer(device=...)``, the
daemon's ``--device``); "cpu" must be asked for.  ``hello`` reports
``"backend": "kernel"`` on a card (the CUDA kernels launch) and ``"plain"``
on the CPU (their plain twins run), for dedicated and coalesced sessions
alike.

The reference is a desktop tool; the rebuild is meant for production
deployment, so the engine gets a serving surface: a long-lived process that
owns the device pipeline and accepts raw frames over a socket.

Protocol (little-endian, length-prefixed JSON header + raw payload):

  request:  u32 header_len | header JSON | payload bytes
  response: u32 header_len | header JSON | payload bytes

Header commands:
  {"cmd": "hello"}                      -> {"ok", "config", "frame_index"}
  {"cmd": "process", "shape": [H,W,3]}  + uint8 RGB payload
        -> {"ok", "stats": [...], "shape": [H,W,C]} + uint8 map payload
  {"cmd": "process_batch", "shape": [N,H,W,3]} + uint8 RGB payload
        -> {"ok", "stats": [[...]xN], "shape": [N,H,W,C]} + uint8 payload
        (one request per device batch: amortises the per-request round
        trip the way the engine amortises per-frame dispatch)
  {"cmd": "snapshot"}                   -> {"ok"}   (re-pin the baseline)
        (--events daemons add "events"/"event_open" to process replies;
        --auto-refresh daemons add "baseline_refresh": the frame index
        where this reply's stats re-pinned the session's baseline)
  {"cmd": "heatmap"}                    -> {"ok", "shape"} + f32 payload
  {"cmd": "flicker"}                    -> {"ok", "shape", "freq_hz",
        "frames"} + f32 amplitude payload (requires binding with
        "flicker_hz" + "flicker_fps": the server then streams a
        per-session FlickerAnalyzer over the frames it already has —
        per-camera vibration/mains-flicker maps without shipping pixels
        twice; reset/load restart the window)
  {"cmd": "save", "path": P}            -> {"ok"}   (checkpoint to disk)
  {"cmd": "load", "path": P}            -> {"ok", "frame_index"}
  {"cmd": "reset"} / {"cmd": "close"}
  {"cmd": "metrics"}                    -> {"ok", "uptime_s", "connections",
        "requests", "frames", "request_errors", "rejected",
        "active_sessions", "parked_sessions", "max_sessions", "coalesced",
        "latency_ms" (process-request service time: {count, p50, p90,
        p99, max} over the last 1024 requests), "coalesce_dispatches" /
        "coalesce_mean_fill" (coalesced servers: device dispatches and
        mean frames folded per dispatch), "flexible" (+ per-geometry
        "pooled_engines" on flexible daemons), "frame_index"}

Each connection gets its OWN engine (private baseline/ring/heatmap state),
so up to ``max_sessions`` clients — e.g. N cameras — stream concurrently
against one card; their launches queue on the device's stream.
Omitting height/width starts a geometry-FLEXIBLE daemon: each session's
engine is sized from its first frame (or loaded checkpoint) and idle
engines pool per geometry — one daemon serves a mixed-resolution camera
fleet.  With ``--coalesce N`` a flexible daemon creates one stacked-stream
coalescer PER GEOMETRY (lazily, or up front via ``--warm``), so mixed
fleets still share device dispatches within each resolution.

A request may also carry ``"roi": [y0, x0, y1, x1]`` — a per-session
analysis region consumed at the first-request engine bind (each fleet
camera watches a different scene): that session's statistics, heatmap
and motion events reduce over the rectangle while its maps stay
full-frame.  Not available on coalescing daemons (the stacked kernel is
shared; use the daemon-wide ``--roi``), and a parked named session only
resumes under the same roi (``reset`` first to change it).

Reconnect/resume semantics: a client may tag its requests with a
``"session": <token>`` field (``DiPsClient(session=...)``); on reconnect
the same token resumes that session's streaming state (cursor, baseline,
ring).  Tokens are latest-wins: a new connection with a live token kicks
the previous holder and waits for its state to park (the dead-link
reconnect case).  :class:`ResilientDiPsClient` wraps this with automatic
backoff reconnection and exactly-once frame accounting for flaky edge
links.  Untagged clients get FRESH state on a multi-session server — a
pooled engine is reset before reuse, so one camera's baseline can never
leak into another's stream — except on a single-session server, where the
lone anonymous engine unambiguously resumes (back-compat).

Crash safety: ``--autosave DIR`` periodically checkpoints each NAMED
session's streaming state (every ``--autosave-every`` frames, atomically,
plus a flush on graceful close); after a daemon restart the first bind of
a token restores its last autosave, so a camera fleet survives a crash
with a bounded baseline-drift window instead of resuming fresh.  An
explicit ``reset`` discards the session's autosave too.

Motion events: ``--events`` runs a per-session
:class:`~dips_tpu_torch.ops.events.MotionDetector` over the stats the daemon
already computes; process replies gain ``events`` (closed this request)
and ``event_open``, named sessions carry an open event across
park/resume, anonymous closes flush it into the goodbye, and the
``motion_events`` counter lands in metrics/Prometheus.  The default
``--event-on auto`` learns each camera's noise floor online.  Adding
``--event-webhook URL`` pushes every closed event to an HTTP endpoint
(async best-effort JSON POST, utils/webhook.py) so a fleet gets alerts
without polling; delivery outcomes land in the ``webhook_*`` counters.
Start with
``python -m dips_tpu_torch.serve --port 7807 --height H --width W
[--device cuda|cuda:N|cpu] [options]``.
"""

from .protocol import (_LEN, _MAX_HEADER, _MAX_PAYLOAD,  # noqa: F401
                       _PARTIAL_TIMEOUT_S, _process_reply, _recv,
                       _recv_exact, _send, log)
from .coalesce import StreamCoalescer, _CoalescedSession  # noqa: F401
from .metrics import _prometheus_text, _start_metrics_http  # noqa: F401
from .server import DiPsServer  # noqa: F401
from .client import DiPsClient, ResilientDiPsClient  # noqa: F401
from .daemon import main  # noqa: F401

__all__ = ["DiPsServer", "DiPsClient", "ResilientDiPsClient",
           "StreamCoalescer", "main"]
