"""Observability: Prometheus text rendering + the GET /metrics scrape
endpoint."""

from __future__ import annotations

import threading


def _prometheus_text(m: dict) -> str:
    """Render a metrics() dict in Prometheus exposition format."""
    lines = []

    def emit(name, value, kind="counter", labels=""):
        lines.append(f"# TYPE dips_{name} {kind}")
        lines.append(f"dips_{name}{labels} {value}")

    for key, kind in (("connections", "counter"), ("requests", "counter"),
                      ("frames", "counter"), ("request_errors", "counter"),
                      ("rejected", "counter"), ("link_drops", "counter"),
                      ("takeovers", "counter"), ("autosaves", "counter"),
                      ("autorestores", "counter"),
                      ("motion_events", "counter"),
                      ("webhook_delivered", "counter"),
                      ("webhook_failed", "counter"),
                      ("webhook_dropped", "counter"),
                      ("active_sessions", "gauge"),
                      ("parked_sessions", "gauge"),
                      ("max_sessions", "gauge"), ("uptime_s", "gauge")):
        if key in m:
            emit(key, m[key], kind)
    if "latency_ms" in m:
        lat = m["latency_ms"]
        lines.append("# TYPE dips_request_latency_ms summary")
        for q in ("p50", "p90", "p99"):
            lines.append(
                f'dips_request_latency_ms{{quantile="{q}"}} {lat[q]}')
        lines.append(f"dips_request_latency_ms_count {lat['count']}")
    if m.get("coalesced"):
        emit("coalesce_dispatches", m.get("coalesce_dispatches", 0))
        emit("coalesce_mean_fill", m.get("coalesce_mean_fill", 0.0),
             "gauge")
    pooled = m.get("pooled_engines") or {}
    if pooled:
        # one TYPE line for the whole metric family — a repeated TYPE
        # makes the Prometheus text parser reject the entire scrape
        lines.append("# TYPE dips_pooled_engines gauge")
        for geom, cnt in pooled.items():
            lines.append(f'dips_pooled_engines{{geometry="{geom}"}} {cnt}')
    return "\n".join(lines) + "\n"


def _start_metrics_http(server: "DiPsServer", port: int, host: str):
    """Serve GET /metrics (Prometheus text format) for scraping."""
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_error(404)
                return
            body = _prometheus_text(server.metrics()).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet: scrapes are frequent
            pass

    httpd = http.server.ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd
