"""Camera-fleet demo: the production serving shape end to end.

One geometry-FLEXIBLE daemon with per-geometry request coalescing serves
a mixed-resolution fleet; each "camera" is a thread streaming through a
ResilientDiPsClient (auto-reconnect + exactly-once frame accounting), and
one camera deliberately drops its connection mid-stream to show the
resume path.  Finishes with a daemon metrics dump.

Run:
  python -m dips_tpu_torch.examples.camera_fleet [--cpu]
"""

import os
import sys

if not __package__:  # run as a script path: the repository root on sys.path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import argparse
import socket
import struct
import threading

import numpy as np

from dips_tpu_torch.examples import example_device, run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--frames", type=int, default=12)
    args = ap.parse_args()
    device = example_device(args.cpu)

    from dips_tpu_torch import DiPsProperties
    from dips_tpu_torch.serve import DiPsServer, ResilientDiPsClient

    # Geometry-flexible (no height/width) + coalesced: each resolution
    # gets a lazily-built stacked-stream coalescer shared by its cameras.
    props = DiPsProperties(window_size=3, temporal_size=2)
    server = DiPsServer(props, port=0, batch=2, coalesce=2, max_sessions=8,
                        input_layout="hwc", device=device)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    print(f"daemon on port {server.port} (flexible, coalesce=2)")

    fleet = {  # camera id -> geometry (mixed resolutions on ONE daemon)
        "lobby": (48, 64), "dock": (48, 64), "yard": (32, 96),
    }
    changed = {}
    failures = []

    def camera(name, geom):
        import zlib
        h, w = geom
        # crc32: deterministic across processes (str hash is randomized)
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        cli = ResilientDiPsClient(server.port, session=name,
                                  backoff_s=0.05)
        try:
            total = 0
            for i in range(args.frames):
                frame = rng.integers(0, 256, (h, w, 3), np.uint8)
                if name == "dock" and i == args.frames // 2:
                    # flaky link: abortive RST mid-stream -- the client
                    # reconnects and the session resumes where it left off
                    cli._cli._sock.setsockopt(
                        socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
                    cli._cli._sock.close()
                _out, stats = cli.process(frame)
                total += int(stats[3])
            changed[name] = total
            fi = cli.hello()["frame_index"]
            if fi != args.frames:
                failures.append(f"{name}: cursor {fi} != {args.frames}")
        finally:
            cli.close()

    def guarded(name, geom):
        try:
            camera(name, geom)
        except Exception as e:
            failures.append(f"{name}: {e!r}")

    threads = [threading.Thread(target=guarded, args=(n, g))
               for n, g in fleet.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failures:
        raise SystemExit(f"FAILED: {failures}")

    for name in sorted(changed):
        print(f"  {name}: {args.frames} frames, "
              f"{changed[name]} changed px total")
    m = server.metrics()
    print(f"daemon: {m['requests']} requests, {m['frames']} frames, "
          f"{m['coalesce_dispatches']} coalesced dispatches "
          f"(mean fill {m['coalesce_mean_fill']})")
    server.shutdown()
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(run(main))
