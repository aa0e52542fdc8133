"""The control of the correctness check: the plain reference, computed in
the next precision below the configuration's (its ``control_precision``:
int4 for the uint8 ABSDIFF pipeline, bfloat16 for the float32 COLORIZE
one), put in the program's place and held to the same comparison.  Its
readings set the upper end of each limit; it has to come out as not
correct.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \\
        [--frames N] [--streams K]

For each seed it makes the cell's frames at the cell's own size, and for
``--streams`` of the cell's streams (from the first) replays ``--frames``
frames of each: the checked batches (one drawn from the seed and the
last, ``batch`` frames each, or single frames for a serving cell), the
heatmap at the end and the baseline, in the control's precision, and
compares them with the reference at the configuration's precision.  It
prints one JSON line a seed with every number and its limit.  It runs on
the CPU; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

import numpy as np

from .check import Checks, base_gap, heat_gap, maps_lsb, stats_gap
from .frames import make_pool, rng_of, stream_offsets
from .reference import StreamReplay, params_from_config
from .run import cell_files


def readings(cell: dict, cfg: dict, seed: int, frames: int,
             streams: int = 1, precision: str = "") -> Dict[str, float]:
    """The numbers the check compares, for the reference at
    ``precision`` (default: the configuration's control precision) in the
    program's place."""
    traffic = cell["traffic"]
    h, w = int(cfg["height"]), int(cfg["width"])
    per = 1 if cell["driver"] == "serve_cams" else int(cfg["batch"])
    pool = make_pool(seed, h, w, traffic)
    n_streams = int(traffic.get("streams", traffic.get("cameras", 1)))
    offs = stream_offsets(n_streams, traffic)[:streams]
    full = params_from_config(cfg)
    low = params_from_config(cfg, precision or cfg["control_precision"])
    checks = Checks(cell["limits"])
    rng = rng_of(seed, 1)
    n_calls = frames // per
    picks = sorted({int(rng.integers(0, n_calls - 1)), n_calls - 1})
    planes: dict = {}
    for off in offs:
        ref = StreamReplay(pool, off, full, planes)
        ctl = StreamReplay(pool, off, low, planes)
        for k in picks:
            idx = range(k * per, (k + 1) * per)
            got_maps, got_stats = ctl.outputs(idx)
            exp_maps, exp_stats = ref.outputs(idx)
            checks.add("maps_lsb", maps_lsb(got_maps, exp_maps))
            checks.add("stats_gap", stats_gap(got_stats, exp_stats))
        checks.add("heat_gap", heat_gap(ctl.heatmap(frames),
                                        ref.heatmap(frames)))
        if "base_gap" in cell["limits"]:
            checks.add("base_gap", base_gap(ctl.baseline(), ref.baseline()))
    if "missing" in cell["limits"]:
        checks.add("missing", 0)
    out = {n: v for n, v, _ in checks.items()}
    out["correct"] = checks.correct
    return out


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--streams", type=int, default=1)
    args = ap.parse_args(argv)
    cell, cfg = cell_files(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(cell, cfg, seed, args.frames, args.streams)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": cfg["control_precision"],
                          "readings": r, "limits": cell["limits"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
