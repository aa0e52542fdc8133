"""Serving load generator: measured RPS/latency against a live daemon.

The serving daemon exports request-latency percentiles (`metrics`), but a
deployment needs a load source to make them meaningful.  This drives K
concurrent camera sessions against a daemon and reports throughput +
client-side latency percentiles as ONE JSON line — the ops-side
acceptance tool for a serving rollout (see docs/OPERATIONS.md).

    python -m dips_tpu.loadgen --port 7807 --clients 8 --frames 64 \
        --geometry 480p [--batch B] [--session-prefix cam]

Synthetic frames are generated per client (seeded by client index);
`--batch B` sends process_batch requests of B frames (the recommended
shape — one request per device batch).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np

from .properties import GEOMETRY_NAMES, parse_geometry  # noqa: F401


def run_load(port: int, host: str = "127.0.0.1", clients: int = 4,
             frames: int = 32, height: int = 480, width: int = 854,
             batch: int = 1, session_prefix: str = "loadgen",
             warmup: int = 1) -> dict:
    """Drive the daemon; returns the measured summary dict.  ``warmup``
    un-timed requests per client run before the measured window so a
    cold daemon's jit compile doesn't pollute the percentiles (pass 0 to
    measure the cold path deliberately)."""
    from .serve import DiPsClient

    if clients < 1 or batch < 1:
        return {"ok": False,
                "errors": [f"clients={clients} and batch={batch} must "
                           f"be >= 1"]}
    if frames < batch:
        return {"ok": False,
                "errors": [f"frames={frames} < batch={batch}: zero "
                           f"measured requests per client"]}

    lat_lock = threading.Lock()
    latencies: list = []
    errors: list = []
    barrier = threading.Barrier(clients + 1)

    def worker(k: int):
        rng = np.random.default_rng(k)
        buf = rng.integers(0, 255, (batch, height, width, 3), np.uint8)
        cli = None
        try:
            cli = DiPsClient(port, host,
                             session=f"{session_prefix}-{k}")
            for _ in range(warmup):
                cli.process_many(buf)
            barrier.wait()  # everyone warm + connected, then the clock
            local = []
            for _ in range(frames // batch):
                t0 = time.monotonic()
                cli.process_many(buf)
                local.append(time.monotonic() - t0)
            with lat_lock:
                latencies.extend(local)
        except Exception as e:
            try:
                barrier.abort()
            except threading.BrokenBarrierError:
                pass
            with lat_lock:
                errors.append(f"client {k}: {e!r}")
        finally:
            if cli is not None:
                try:
                    cli.close()
                except OSError:
                    pass

    threads = [threading.Thread(target=worker, args=(k,), daemon=True)
               for k in range(clients)]  # daemon: a hung client thread
    # must not keep the process alive past the bounded join below
    for t in threads:
        t.start()
    try:
        barrier.wait(timeout=120)
    except threading.BrokenBarrierError:
        pass
    t0 = time.monotonic()
    for t in threads:
        # bounded: one daemon that accepts but never answers must not
        # wedge the load generator forever (client sockets are blocking)
        t.join(timeout=300)
    wall = time.monotonic() - t0
    hung = [t.name for t in threads if t.is_alive()]
    if hung:
        with lat_lock:
            errors.append(f"{len(hung)} client thread(s) never finished "
                          "(daemon accepted but did not answer)")

    if errors:
        return {"ok": False, "errors": errors}
    if not latencies:
        return {"ok": False, "errors": ["no measured requests"]}
    lat = sorted(latencies)

    def q(p):
        return round(1e3 * lat[min(len(lat) - 1, int(p * len(lat)))], 3)

    n_requests = len(lat)
    n_frames = n_requests * batch
    return {
        "ok": True, "clients": clients, "batch": batch,
        "geometry": f"{height}x{width}", "requests": n_requests,
        "frames": n_frames, "wall_s": round(wall, 3),
        "rps": round(n_requests / wall, 1) if wall else 0.0,
        "fps": round(n_frames / wall, 1) if wall else 0.0,
        "latency_ms": {"p50": q(0.50), "p90": q(0.90), "p99": q(0.99),
                       "max": round(1e3 * lat[-1], 3)},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dips-loadgen",
        description="drive a dips serving daemon with K concurrent "
                    "camera sessions; print ONE JSON summary line")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--frames", type=int, default=32,
                    help="frames per client (rounded down to --batch)")
    ap.add_argument("--geometry", default="480p",
                    help="HxW or 480p/720p/1080p/4k")
    ap.add_argument("--batch", type=int, default=1,
                    help="frames per request (process_batch)")
    ap.add_argument("--session-prefix", default="loadgen")
    ap.add_argument("--warmup", type=int, default=1,
                    help="un-timed requests per client before the "
                         "measured window (0 = measure the cold path)")
    args = ap.parse_args(argv)
    try:
        h, w = parse_geometry(args.geometry)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    summary = run_load(args.port, args.host, clients=args.clients,
                       frames=args.frames, height=h, width=w,
                       batch=args.batch,
                       session_prefix=args.session_prefix,
                       warmup=args.warmup)
    print(json.dumps(summary))
    return 0 if summary.get("ok") else 1


if __name__ == "__main__":
    raise SystemExit(main())
