"""Find the knee of a serving cell: the highest total rate at which the
backlog does not grow.

    python3 -m portbench.sweep --workload colorize_1080p.cams8 \\
        --rates 20,40,60 --seconds 10 --seed 1

Runs the cell once a rate (on the card, as the benchmark does) and prints
one JSON line a rate: the reply times, how late the generator sent (over
the window's first and last thirds: a backlog that grows sends ever
later), and the requests that did not complete.  The benchmark's own runs
never sweep: a cell's file holds its rate as a number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import run as harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    harness.pin_environment()
    cell, cfg = harness.cell_files(args.workload)
    from .record import percentile
    for rate in (float(r) for r in args.rates.split(",")):
        c = json.loads(json.dumps(cell))
        c["traffic"]["rate_fps"] = rate
        driver = __import__(f"portbench.drivers.{c['driver']}",
                            fromlist=["run"])
        from .record import Context
        run = driver.run(Context(cell=c, config=cfg, seed=args.seed,
                                 seconds=args.seconds, trace=False,
                                 device="cuda", t0=time.perf_counter()))
        late = run.lateness_ms
        firsts, lasts = [], []
        for cam in run.notes["late_by_camera"]:
            third = max(1, len(cam) // 3)
            firsts.append(np.mean(cam[:third]))
            lasts.append(np.mean(cam[-third:]))
        print(json.dumps({
            "rate_fps": rate, "attempted": run.attempted,
            "failed": run.failed,
            "completed_fps": run.frames / run.window_s,
            "reply_ms_p50": percentile(run.reply_ms, 50),
            "reply_ms_p95": percentile(run.reply_ms, 95),
            "late_ms_first_third": float(np.mean(firsts)),
            "late_ms_last_third": float(np.mean(lasts)),
            "late_ms_max": float(np.max(late)),
            "coalesce_fill": (run.server or {}).get("coalesce_mean_fill"),
            "correct": all(v <= lim for _, v, lim in run.checks)}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
