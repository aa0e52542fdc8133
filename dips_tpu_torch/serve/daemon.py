"""``python -m dips_tpu_torch.serve`` — the daemon CLI entry point.

Counterpart of ``dips_tpu/serve/daemon.py`` with the same flags, messages
and exit codes (2 for a usage error), on the port's CLI parser: its
``--device`` (default "cuda"; without a card the daemon exits 1, as the
run CLI does, unless ``--device cpu`` is given) takes the place of
``--backend``.  ``--compile-cache [DIR]`` keeps the built CUDA kernels under
DIR (``utils/compilecache.py``) where the JAX daemon keeps XLA's
executables."""

from __future__ import annotations

import argparse
import sys

from ..errors import DiPsError
from .server import DiPsServer


def main(argv=None) -> int:
    from ..cli import build_parser, props_from_args
    ap = argparse.ArgumentParser(parents=[build_parser()], add_help=False,
                                 conflict_handler="resolve")
    ap.add_argument("--port", type=int, default=7807)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--height", type=int, default=None,
                    help="fixed frame height; omit BOTH -h/-w for a "
                         "geometry-flexible daemon (each session sized "
                         "from its first frame; mixed camera fleets; "
                         "composes with --coalesce: one stacked "
                         "dispatcher per geometry)")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--sessions", type=int, default=1,
                    help="max concurrent client sessions (each gets its "
                         "own engine state)")
    ap.add_argument("--packed-wire", action="store_true",
                    help="THRESHOLD only: bit-pack masks on the device "
                         "before the D2H copy (8x less transfer)")
    ap.add_argument("--coalesce", type=int, default=0, metavar="N",
                    help="share ONE stacked-stream kernel across N session "
                         "slots (concurrent requests fold into one device "
                         "dispatch; the many-camera deployment shape)")
    ap.add_argument("--coalesce-window-ms", type=float, default=2.0,
                    help="how long a request waits for co-tenant frames "
                         "before dispatching anyway")
    ap.add_argument("--coalesce-devices", type=int, default=1, metavar="D",
                    help="shard the coalesced stream slots over D mesh "
                         "cells (N must divide by D): the first D cards "
                         "with --device cuda, D cells on the one device "
                         "with --device cuda:N or cpu")
    ap.add_argument("--coalesce-mesh", metavar="SxR", default=None,
                    help="shard the coalesced slots over a 2-D grid (S "
                         "stream shards x R row slabs) instead of the 1-D "
                         "--coalesce-devices mesh — the BIG-FRAME serving "
                         "shape: a single huge stream (8K camera) gets "
                         "R-way row sharding when per-card line rate is "
                         "the bottleneck.  N must divide by S and, on a "
                         "card, the padded frame height must 8-row-align "
                         "by R.  --device cuda wants S*R cards; --device "
                         "cuda:N (or cpu) puts every cell on that device")
    ap.add_argument("--input-layout", choices=("planar", "hwc"),
                    default="planar",
                    help="'hwc': upload raw frames and planarize ON DEVICE "
                         "(frees host CPU per frame; recommended for card "
                         "serving - wire frames are already HWC)")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="P",
                    help="also serve Prometheus metrics on http://HOST:P"
                         "/metrics (0 = ephemeral port, printed at start)")
    ap.add_argument("--max-geometries", type=int, default=None, metavar="G",
                    help="flexible daemons: keep at most G idle per-"
                         "geometry coalescers / pooled engines alive under "
                         "geometry churn (default 8; live sessions are "
                         "never evicted)")
    ap.add_argument("--autosave", default=None, metavar="DIR",
                    help="crash-safety checkpoints: periodically save each "
                         "NAMED session's streaming state to DIR; after a "
                         "daemon restart, reconnecting sessions resume "
                         "from their last autosave instead of fresh")
    ap.add_argument("--autosave-every", type=int, default=256, metavar="N",
                    help="frames between a session's autosaves (a graceful "
                         "close always flushes)")
    ap.add_argument("--warm", default=None, metavar="GEOMS",
                    help="comma-separated geometries to warm at startup "
                         "(HxW or 480p/720p/1080p/4k): one frame through "
                         "each, so the first camera of each resolution "
                         "skips the first-use latency (the kernel build)")
    ap.add_argument("--events", action="store_true",
                    help="per-session motion-event segmentation "
                         "(ops/events.py): process replies gain 'events' "
                         "(closed this request) and 'event_open'; the "
                         "motion_events counter appears in metrics")
    ap.add_argument("--event-on", default="auto", metavar="X|auto",
                    type=lambda s: s if s == "auto" else float(s),
                    help="event OPEN level; 'auto' (default) learns each "
                         "session's noise floor online — the right choice "
                         "for a mixed camera fleet")
    ap.add_argument("--event-off", type=float, default=None, metavar="X",
                    help="close level (fixed mode only; default half of "
                         "--event-on)")
    ap.add_argument("--event-metric", default="changed_frac",
                    choices=("mean_abs_diff", "max_abs_diff",
                             "changed_count", "changed_frac"))
    ap.add_argument("--event-min-frames", type=int, default=2, metavar="N")
    ap.add_argument("--event-cooldown", type=int, default=0, metavar="N")
    ap.add_argument("--event-webhook", default=None, metavar="URL",
                    help="POST every closed motion event to URL as JSON "
                         "(async best-effort with retries; outcomes in "
                         "the webhook_* metrics).  Requires --events")
    ap.add_argument("--auto-refresh", default=None,
                    metavar="FRAC[:PERSIST[:COOLDOWN]]",
                    help="per-session adaptive baseline refresh: re-pin a "
                         "session's snapshot when at least FRAC of its "
                         "analysis pixels stay changed for PERSIST frames "
                         "(default 3) — the automated SnapShot button for "
                         "unattended fleet cameras.  The fired reply "
                         "carries 'baseline_refresh' (frame index); "
                         "fires count in the auto_refreshes metric")
    from ..utils.compilecache import (add_compile_cache_flag,
                                     apply_compile_cache_flag)
    add_compile_cache_flag(ap)
    args = ap.parse_args(argv)
    if args.event_webhook and not args.events:
        print("error: --event-webhook requires --events", file=sys.stderr)
        return 2
    if args.event_on == "auto" and args.event_off is not None:
        print("error: --event-off is computed in auto mode (estimated "
              "floor + margin/2) — drop it or use a fixed --event-on",
              file=sys.stderr)
        return 2
    auto_refresh = None
    if args.auto_refresh:
        from ..ops.refresh import parse_auto_refresh_arg
        try:
            auto_refresh = parse_auto_refresh_arg(args.auto_refresh)
        except ValueError:
            print(f"error: bad --auto-refresh {args.auto_refresh!r} "
                  "(want FRAC[:PERSIST[:COOLDOWN]], e.g. 0.6:3:64)",
                  file=sys.stderr)
            return 2
    cache_dir = apply_compile_cache_flag(args)
    if cache_dir:
        print(f"compile cache: {cache_dir}", flush=True)
    try:
        props = props_from_args(args)
    except ValueError as e:  # e.g. a malformed/inverted --roi rectangle
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        coalesce_mesh = None
        if args.coalesce_mesh:
            try:
                coalesce_mesh = tuple(
                    int(v) for v in args.coalesce_mesh.lower().split("x"))
                if len(coalesce_mesh) != 2 or min(coalesce_mesh) < 1:
                    raise ValueError(args.coalesce_mesh)
            except ValueError:
                print(f"bad --coalesce-mesh {args.coalesce_mesh!r} "
                      f"(want SxR with S,R >= 1, e.g. 1x4)",
                      file=sys.stderr)
                return 2
            if args.coalesce_devices != 1:
                print("--coalesce-mesh replaces --coalesce-devices "
                      "(pick one)", file=sys.stderr)
                return 2
            if args.coalesce <= 0:
                # without a coalescer there is nothing to shard — silently
                # serving per-session on one card would contradict the
                # fail-at-startup promise
                print("--coalesce-mesh requires --coalesce N (the mesh "
                      "shards coalesced session slots)", file=sys.stderr)
                return 2
        server = DiPsServer(props, args.height, args.width, port=args.port,
                            host=args.host, batch=args.batch,
                            device=args.device,
                            max_sessions=args.sessions,
                            packed_wire=args.packed_wire,
                            coalesce=args.coalesce,
                            coalesce_window_ms=args.coalesce_window_ms,
                            coalesce_devices=args.coalesce_devices,
                            coalesce_mesh=coalesce_mesh,
                            input_layout=args.input_layout,
                            metrics_port=args.metrics_port,
                            autosave_dir=args.autosave,
                            autosave_every=args.autosave_every,
                            downscale=args.downscale,
                            events=(dict(on_threshold=args.event_on,
                                         off_threshold=args.event_off,
                                         metric=args.event_metric,
                                         min_frames=args.event_min_frames,
                                         cooldown=args.event_cooldown)
                                    if args.events else None),
                            event_webhook=args.event_webhook,
                            auto_refresh=auto_refresh)
        if args.max_geometries is not None:
            server.max_geometries = max(1, args.max_geometries)
            server.max_pooled_engines = max(server.max_pooled_engines,
                                            server.max_geometries)
        if args.warm:
            server.warm_geometries(args.warm.split(","))
    except ValueError as e:
        # configuration the flags alone cannot validate — an --roi larger
        # than --height/--width, packed-wire+coalesce, a --warm geometry
        # the roi does not fit — is a user error, not a traceback
        print(f"error: {e}", file=sys.stderr)
        return 2
    except DiPsError as e:  # no card for --device cuda: the run CLI's rc
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"dips server on {args.host}:{server.port}", flush=True)
    if server.metrics_port is not None:
        print(f"metrics on http://{args.host}:{server.metrics_port}/metrics",
              flush=True)
    # graceful daemon shutdown on SIGTERM (systemd/k8s stop), not just ^C
    import signal

    def _term(signum, frame):
        server.shutdown()
    try:
        signal.signal(signal.SIGTERM, _term)
    except ValueError:
        pass  # non-main thread (embedded use): ^C/shutdown() still work
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
    return 0
