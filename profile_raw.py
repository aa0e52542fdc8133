#!/usr/bin/env python3
"""Time the raw step (``csrc/raw_ring.cu``) in each of its forms on one card.

    python3 profile_raw.py [--package-root DIR] [--reps N] [--out FILE]
                           [--host-profile]

1080p (Hp 1080, Wp 2048), B = 16: the ring and the tail step at s = 1 and
s = 8 stacked streams, each in ABSDIFF, THRESHOLD and STATS_ONLY, and the
``dyn_rows`` form (ABSDIFF with an roi) as the ``[grid]`` path's (2, 3)
grid launches it, six launches of 4 streams x 360 rows.  For each form:
the wrapper's ms a stream-frame (CUDA events over back-to-back calls, the
host's work included), the host's ms a call (the calls enqueued back to
back, the host clock stopped before the card catches up), the kernels
alone (their device intervals in a
``torch.profiler`` trace: every kernel whose name holds ``raw_step``;
the stats reduction's kernel, part of the step, also apart), and the
bound (``chip_smoke.bound``: bytes over 3.35 TB/s).

``--package-root DIR`` imports ``dips_tpu_torch`` from DIR (an unpacked
checkout of another commit), so that two commits are timed on one card
by calls of this script in one session.  ``--host-profile`` adds a
``cProfile`` of the s = 1 ring wrapper fed host flags, as the engine feeds
it (where the host's time goes).  Prints one JSON line a form and the
card's ``nvidia-smi`` line; ``--out`` writes them all as one JSON file.
Needs a card: without one it exits 1.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import subprocess
import sys
import time

H, W, B, S = 1080, 1920, 16, 8
GRID = (2, 3)  # [grid]'s one-card mesh: 4 streams x 360 rows a cell


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not available"


def events_ms(fn, reps: int) -> float:
    """ms a call of ``fn`` over ``reps`` back-to-back calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def host_ms(fn, reps: int) -> float:
    """ms of host time a call of ``fn``: the calls enqueued back to back,
    the card left to catch up after the clock stops."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return host


def alone_ms(fn, reps: int):
    """(ms a call of the raw_step kernels ``fn`` launches, of those the
    stats reduction's, kernel launches a call) from their device
    intervals; (None, None, 0) if the trace has none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [(e.name, e.time_range.end - e.time_range.start)
          for e in prof.events()
          if e.device_type == DeviceType.CUDA and "raw_step" in e.name]
    if not ev:
        return None, None, 0
    stats = sum(us for name, us in ev if "stats" in name)
    return (sum(us for _, us in ev) / 1e3 / reps, stats / 1e3 / reps,
            len(ev) / reps)


def forms(dev):
    """name -> (call, props, streams a call, rows a stream, slabs)."""
    import numpy as np
    import torch
    from dips_tpu_torch.ops import cuda_fused as cf
    from dips_tpu_torch.ops.reference import pad_geometry
    from dips_tpu_torch.properties import DiPsProperties, OutputMode
    hp, wp = pad_geometry(H, W)
    t = DiPsProperties().temporal_size
    g = torch.Generator(device=dev).manual_seed(5)
    raw = torch.randint(0, 256, (t + B, 3, S * hp, wp), generator=g,
                        dtype=torch.uint8, device=dev)
    out = {}
    for mode in (OutputMode.ABSDIFF, OutputMode.THRESHOLD,
                 OutputMode.STATS_ONLY):
        props = DiPsProperties(output=mode)
        for s in (1, S):
            rows = (s * hp, wp)
            x = raw[:, :, :s * hp].contiguous()
            flags = np.zeros((s, B), bool)
            flags[:, 0] = True
            valid = np.ones((s, B), bool)
            z8 = lambda: torch.zeros((3,) + rows, dtype=torch.uint8,  # noqa
                                     device=dev)
            prev, base = z8(), z8()
            heat = torch.zeros(rows, device=dev)
            ring = (lambda p=props, s=s, x=x, f=flags, v=valid, pr=prev,
                    ba=base, he=heat: cf.absdiff_step_ring_stacked(
                        p, H, W, s, x[t:], pr, ba, f, he, v, [0] * s))
            tail = (lambda p=props, s=s, x=x, f=flags, v=valid, ba=base,
                    he=heat: cf.absdiff_step_stacked(p, H, W, s, x, ba, f,
                                                     he, v))
            for proto, fn in (("ring", ring), ("tail", tail)):
                out[f"{proto} {mode.name} s={s}"] = (fn, props, s, hp, 0)
    # the dyn_rows form as the (2, 3) grid launches it
    from dips_tpu_torch.parallel import grid2d
    props = DiPsProperties(output=OutputMode.ABSDIFF,
                           roi=(400, 100, 1000, 1700))
    s_l, hs = S // GRID[0], hp // GRID[1]
    flags = np.zeros((s_l, B), bool)
    flags[:, 0] = True
    valid = np.ones((s_l, B), bool)
    cells = []
    for i in range(GRID[0]):
        for j in range(GRID[1]):
            x = torch.randint(0, 256, (t + B, 3, s_l * hs, wp), generator=g,
                              dtype=torch.uint8, device=dev)
            st = [torch.zeros((3, s_l * hs, wp), dtype=torch.uint8,
                              device=dev) for _ in range(2)] + [
                torch.zeros((s_l * hs, wp), device=dev)]
            cells.append((x, st, grid2d._raw_grid_bounds(props, H, W, hs,
                                                         j)))

    def ring_cells():
        for x, st, rb in cells:
            cf.absdiff_step_ring_stacked(props, H, W, s_l, x[t:], st[0],
                                         st[1], flags, st[2], valid,
                                         [0] * s_l, row_bounds=rb)

    def tail_cells():
        for x, st, rb in cells:
            cf.absdiff_step_stacked(props, H, W, s_l, x, st[1], flags,
                                    st[2], valid, row_bounds=rb)

    out["ring dyn_rows (2, 3) grid"] = (ring_cells, props, S, hp, 0)
    out["tail dyn_rows (2, 3) grid"] = (tail_cells, props, S, hp, 0)
    return out


def host_profile(dev) -> str:
    """cProfile of 200 calls of the s = 1 ring ABSDIFF wrapper fed host
    flags: the top 25 functions by own time."""
    import numpy as np
    import torch
    from dips_tpu_torch.ops import cuda_fused as cf
    from dips_tpu_torch.ops.reference import pad_geometry
    from dips_tpu_torch.properties import DiPsProperties, OutputMode
    hp, wp = pad_geometry(H, W)
    props = DiPsProperties(output=OutputMode.ABSDIFF)
    raw = torch.zeros((B, 3, hp, wp), dtype=torch.uint8, device=dev)
    st = [torch.zeros((3, hp, wp), dtype=torch.uint8, device=dev)
          for _ in range(2)] + [torch.zeros((hp, wp), device=dev)]
    flags = np.zeros(B, bool)
    flags[0] = True
    valid = np.ones(B, bool)
    call = lambda: cf.absdiff_step_ring(props, H, W, raw, st[0], st[1],  # noqa
                                        flags, st[2], valid, 0)
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for _ in range(200):
        call()
    prof.disable()
    host = (time.perf_counter() - t0) / 200 * 1e3
    torch.cuda.synchronize()
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(25)
    return f"host ms a call (under cProfile): {host:.4f}\n" + buf.getvalue()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package-root", default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    ap.add_argument("--host-profile", action="store_true")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    if args.package_root:
        sys.path.insert(0, os.path.abspath(args.package_root))
    if here not in sys.path:
        sys.path.append(here)
    import torch
    if not torch.cuda.is_available():
        print("profile_raw: needs a CUDA card", file=sys.stderr)
        return 1
    import dips_tpu_torch
    from chip_smoke import bound
    dev = torch.device("cuda")
    card = card_line()
    print(f"[raw] package {os.path.dirname(dips_tpu_torch.__file__)}; "
          f"{card}", flush=True)
    rows = []
    for name, (fn, props, s, hp, slabs) in forms(dev).items():
        frames = s * B
        wrapper = [events_ms(fn, args.reps) / frames for _ in range(2)]
        host = host_ms(fn, args.reps)
        alone, stats, launches = alone_ms(fn, args.reps)
        kernel = "absdiff_step_ring" if name.startswith("ring") \
            else "absdiff_step"
        bound_ms, by = bound(kernel, props, s, B, hp, 2048, slabs)
        row = {"form": name, "wrapper_ms": wrapper, "host_ms_a_call": host,
               "alone_ms": None if alone is None else alone / frames,
               "alone_stats_kernel_ms": None if stats is None
               else stats / frames,
               "kernel_launches_a_call": launches, "bound_ms": bound_ms,
               "bound_by": by,
               "alone_share_of_bound": None if alone is None
               else bound_ms / (alone / frames),
               "card": card}
        print(json.dumps(row), flush=True)
        rows.append(row)
    result = {"package": os.path.dirname(dips_tpu_torch.__file__),
              "card": card, "rows": rows}
    if args.host_profile:
        result["host_profile"] = host_profile(dev)
        print(result["host_profile"], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
