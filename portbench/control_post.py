"""The control of the post-analysis cells' check: the plain reference in
the next precision below the configuration's (bfloat16: the COLORIZE
arithmetic, the denoise's forward spectrum and the DFT's spectrum
rounded to it) put in the program's place and held to the comparison
``drivers/run_stream.py`` makes, through its own ``check_batch`` and
``check_dft``.  It has to come out as not correct.

    python3 -m portbench.control_post --workload <cell> --seeds 1,2,3 \\
        [--frames N]

For each seed it makes the cell's frames at the cell's own size and
replays ``--frames`` frames of the stream: the checked batches (one drawn
from the seed and the last, as the closed loop keeps them),
``frames_checked`` frames of each denoised (every channel), the heatmap
at the end, the baseline, and the DFT of the mean-|diff| series of every
frame.  Beside the control it reads each step alone in bfloat16:
``alone_maps_lsb`` / ``alone_flip_share``, the bf16 denoise of the
reference's own maps against their full-precision denoise (the same
frames, the same comparison); ``dft_gap`` is already the bf16 DFT alone,
held to the float64 DFT of its own series.  It prints one JSON line a
seed with every number and its limit.  It runs on the CPU; the
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

import numpy as np

from .check import Checks, base_gap, heat_gap, per_stream
from .drivers.run_stream import check_batch, check_dft
from .frames import make_pool, rng_of
from .reference import StreamReplay, params_from_config
from .reference.dips import _bf16
from .reference.post import denoise_plane, rdft_magnitude
from .run import cell_files


def _bf16_rdft_magnitude(series: np.ndarray) -> np.ndarray:
    spec = np.fft.rfft(np.asarray(series, np.float32)).astype(np.complex64)
    return np.abs(_bf16(spec.real) + 1j * _bf16(spec.imag))


class _Denoised:
    """Frame j's (H, W, C) map of ``maps``, denoised on first use."""

    def __init__(self, maps: list, radius: int, precision: str):
        self.maps, self.radius, self.precision = maps, radius, precision
        self.done = {}

    def __getitem__(self, j: int) -> np.ndarray:
        if j not in self.done:
            m = self.maps[j]
            self.done[j] = np.stack(per_stream(lambda c: denoise_plane(
                np.ascontiguousarray(m[..., c]), self.radius,
                self.precision), range(m.shape[-1])), axis=-1)
        return self.done[j]


def readings(cell: dict, cfg: dict, seed: int, frames: int,
             precision: str = "") -> Dict[str, float]:
    """The numbers the check compares, for the reference at ``precision``
    (default: the configuration's control precision) in the program's
    place, and the denoise alone at that precision (``alone_*``)."""
    traffic = cell["traffic"]
    h, w, b = int(cfg["height"]), int(cfg["width"]), int(cfg["batch"])
    radius = int(cfg["post"]["denoise_radius"])
    low_name = precision or cfg["control_precision"]
    post = "full" if low_name == "full" else "bf16"
    pool = make_pool(seed, h, w, traffic)
    ref = StreamReplay(pool, 0, params_from_config(cfg))
    ctl = StreamReplay(pool, 0, params_from_config(cfg, low_name))
    checks, alone = Checks(cell["limits"]), Checks(cell["limits"])
    rng = rng_of(seed, 1)
    pick, pick_alone = rng_of(seed, 2), rng_of(seed, 2)
    n_calls = frames // b
    calls = sorted({int(rng.integers(0, n_calls - 1)), n_calls - 1})
    exp = per_stream(lambda i: ref.output(i)[:2], range(frames))
    got = per_stream(lambda i: ctl.output(i)[:2], range(frames))
    n_check = int(traffic["frames_checked"])
    for k in calls:
        e, g = exp[k * b:(k + 1) * b], got[k * b:(k + 1) * b]
        check_batch(checks, _Denoised([m for m, _ in g], radius, post),
                    np.stack([s for _, s in g]), e, radius, pick, n_check)
        check_batch(alone, _Denoised([m for m, _ in e], radius, post),
                    np.stack([s for _, s in e]), e, radius, pick_alone,
                    n_check)
    checks.add("heat_gap", heat_gap(ctl.heatmap(frames), ref.heatmap(frames)))
    checks.add("base_gap", base_gap(ctl.baseline(), ref.baseline()))
    series = np.array([s[1] for _, s in got], np.float32)
    check_dft(checks, rdft_magnitude(series) if post == "full"
              else _bf16_rdft_magnitude(series), series)
    out = {n: v for n, v, _ in checks.items()}
    out["correct"] = checks.correct
    for n, v, _ in alone.items():
        if n in ("maps_lsb", "flip_share"):
            out["alone_" + n] = v
    return out


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, default=64)
    args = ap.parse_args(argv)
    cell, cfg = cell_files(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(cell, cfg, seed, args.frames)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": cfg["control_precision"],
                          "readings": r, "limits": cell["limits"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
