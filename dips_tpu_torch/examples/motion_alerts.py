"""Motion-alert demo: the serving daemon's --events surface end to end.

A daemon runs with per-session motion-event segmentation in AUTO mode
(each camera learns its own noise floor online -- no threshold tuning per
camera).  Two simulated cameras stream: a "gate" camera that sees a
visitor walk through mid-stream, and a "warehouse" camera that stays
still.  The gate camera's replies carry the event (open flag while the
visitor is in frame, a closed event record after), the warehouse stays
silent, and the daemon's motion_events counter reflects exactly one
alert.

Run:
  python -m dips_tpu_torch.examples.motion_alerts [--cpu]
"""

import os
import sys

if not __package__:  # run as a script path: the repository root on sys.path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import argparse
import threading

import numpy as np

from dips_tpu_torch.examples import example_device, run


def camera_frames(n_idle, n_motion, n_tail, h=72, w=96, seed=0):
    """Textured scene; a bright 'visitor' crosses during the middle span."""
    rng = np.random.default_rng(seed)
    base = rng.integers(60, 90, (h, w, 3), np.uint8)
    frames = []
    for i in range(n_idle + n_motion + n_tail):
        f = base.copy()
        if n_idle <= i < n_idle + n_motion:
            x = 4 + 5 * (i - n_idle)
            f[20:56, x:x + 20] = (235, 235, 235)
        frames.append(f)
    return frames


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    device = example_device(args.cpu)

    from dips_tpu_torch import DiPsProperties
    from dips_tpu_torch.properties import DiPsFilter, OutputMode
    from dips_tpu_torch.serve import DiPsClient, DiPsServer

    props = DiPsProperties(window_size=1, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED,
                           output=OutputMode.ABSDIFF)
    srv = DiPsServer(props, 72, 96, port=0, batch=4, max_sessions=2,
                     events=dict(on_threshold="auto", min_frames=2,
                                 metric="changed_frac", auto_warmup=8),
                     device=device)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    print(f"daemon with --events on port {srv.port}")

    feeds = {"gate": camera_frames(24, 8, 8, seed=1),
             "warehouse": camera_frames(40, 0, 0, seed=2)}
    alerts = {}

    def run_camera(name):
        cli = DiPsClient(srv.port, session=name)
        events, was_open = [], False
        frames = feeds[name]
        for s in range(0, len(frames), 4):
            cli.process_many(np.stack(frames[s:s + 4]))
            if cli.event_open and not was_open:
                print(f"  [{name}] MOTION OPEN (auto threshold)")
            was_open = cli.event_open
            for ev in cli.last_events:
                print(f"  [{name}] motion event closed: frames "
                      f"{ev['start_frame']}-{ev['end_frame']} "
                      f"peak {ev['peak']:.3f}")
                events.append(ev)
        cli.close()
        events += cli.last_events  # an anonymous close would flush here
        alerts[name] = events

    threads = [threading.Thread(target=run_camera, args=(n,))
               for n in feeds]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    m = srv.metrics()
    print(f"daemon: {m['frames']} frames, {m['motion_events']} motion "
          f"event(s)")
    srv.shutdown()
    assert len(alerts["gate"]) == 1, alerts
    assert alerts["warehouse"] == [], alerts
    print("OK")


if __name__ == "__main__":
    raise SystemExit(run(main))
