"""serve.server_ms_p50: the daemon's own median latency at the window's
end (``latency_ms.p50`` of its ``metrics`` reply: the last 1024
requests, from receipt to reply, the coalescer's wait included)."""


def read(run):
    lat = (run.server or {}).get("latency_ms")
    return float(lat["p50"]) if lat else None
