#!/usr/bin/env python3
"""Where the time goes in the port's engines on one card, both protocols.

    python3 profile_engines.py [--batches 3] [--out chiprun_out/profile.json]

Runs on a machine with an NVIDIA card.  For the single-stream engine
(1080p, B = 16) and the 8-stream fleet (1080p x 8, B = 16), COLORIZE w3/T4
and ABSDIFF, each on the ring-carry and the tail protocol: one warm-up
batch, then ``--batches`` batches of seeded frames under ``torch.profiler``.
Prints one JSON line per run, and writes them all to ``--out``:

* ``wall_ms``: host clock per batch, host frames in to host maps out;
* ``busy_ms``: the union of the device's kernel and copy intervals per
  batch, and ``idle_share`` = 1 - busy / wall;
* ``step_ms``: the step's device time per launch (the raw step's
  launch is its kernel and the stats reduction kernel after it, both
  counted);
* ``d2h_ms`` / ``h2d_ms``: device time of the copies per batch;
* ``top``: the five device ops with the most time per batch.

Each run also prints the card's name and power limit.  Without a card it
exits non-zero.

``--threshold`` instead profiles the THRESHOLD pipeline, ring-carry, with
and without ``packed_wire`` (the masks bit-packed on the card before the
download), single stream and fleet, in turns (unpacked, packed, packed,
unpacked); each row also gives ``d2h_mb``, the map bytes downloaded per
batch.

``--ring-paths`` instead times what every version of the package has:
the single-stream ring wrappers (``absdiff_step_ring`` with device flags
and a host seed, then with host flags; ``batch_step_ring``) at 1080p,
B = 16, three times 100 calls each, in ms per frame with CUDA events, and
the ring-carry ``DiPsEngine`` end to end (COLORIZE w3/T4 and ABSDIFF,
frames/s over 12 batches after one warm-up batch).  Two versions compare
on one card by running this script from a directory of its own with each
version on ``PYTHONPATH`` in turn.
"""

import argparse
import json
import subprocess
import time

import numpy as np

H, W, B, S = 1080, 1920, 16, 8


def frames_of(seed, n, h=H, w=W):
    """Seeded (n, H, W, 3) u8 frames: a square moving over noise."""
    rng = np.random.default_rng(seed)
    bg = rng.integers(0, 256, (h, w, 3), np.uint8)
    out = np.repeat(bg[None], n, axis=0)
    for i in range(n):
        y, x = (7 * i) % (h - 108), (13 * i) % (w - 108)
        out[i, y:y + 108, x:x + 108] = (250, 30, 30)
    return out


def device_intervals(prof):
    """(name, start_us, end_us) of every device event of a profile."""
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def union_us(iv) -> float:
    total, end = 0.0, -1.0
    for _, a, b in sorted(iv, key=lambda x: x[1]):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def profile(run_batch, n_batches: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    run_batch(0)  # warm-up
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_batches):
            run_batch(i + 1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_batches
    iv = device_intervals(prof)
    if not iv:
        raise SystemExit("profile_engines: the profiler saw no device event")
    per = {}
    for name, a, b in iv:
        per[name] = per.get(name, 0.0) + (b - a)
    step = [(b - a) for name, a, b in iv if "_kernel" in name
            and ("raw_step" in name or "median_" in name)]
    # launches: the step kernels, not the raw step's stats kernel
    launches = sum(1 for name, _, _ in iv if "_kernel" in name
                   and "stats" not in name
                   and ("raw_step" in name or "median_" in name))
    busy = union_us(iv) / 1e3 / n_batches
    pick = lambda key: sum(v for k, v in per.items()
                           if key in k) / 1e3 / n_batches
    top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
            "step_ms": sum(step) / 1e3 / launches if launches else None,
            "step_launches": launches,
            "d2h_ms": pick("DtoH"), "h2d_ms": pick("HtoD"),
            "top": [(k[:60], v / 1e3 / n_batches) for k, v in top]}


def time_ring_paths(card: str) -> dict:
    """ms per frame of the single-stream ring wrappers (three runs each)
    and frames/s of the ring engine end to end."""
    import torch
    from dips_tpu_torch.ops import cuda_fused as cf
    from dips_tpu_torch.ops.reference import pad_geometry
    from dips_tpu_torch.properties import DiPsProperties, OutputMode
    dev = torch.device("cuda")
    hp, wp = pad_geometry(H, W)
    rp, mp = DiPsProperties(output=OutputMode.ABSDIFF), DiPsProperties()
    raw = torch.randint(0, 256, (B, 3, hp, wp), dtype=torch.uint8,
                        device=dev)
    flags = torch.zeros(B, dtype=torch.bool, device=dev)
    flags[0] = True
    valid = torch.ones(B, dtype=torch.bool, device=dev)
    hflags, hvalid = flags.cpu().numpy(), valid.cpu().numpy()
    rs = [torch.zeros((3, hp, wp), dtype=torch.uint8, device=dev)
          for _ in range(2)] + [torch.zeros((hp, wp), device=dev)]
    ms = [torch.zeros((4, hp, wp), device=dev)] + [
        torch.zeros((hp, wp), device=dev) for _ in range(3)]

    def per_frame(fn, reps=100):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps / B

    calls = {
        "absdiff_step_ring": lambda: cf.absdiff_step_ring(
            rp, H, W, raw, rs[0], rs[1], flags, rs[2], valid, 0),
        "absdiff_step_ring host flags": lambda: cf.absdiff_step_ring(
            rp, H, W, raw, rs[0], rs[1], hflags, rs[2], hvalid, 0),
        "batch_step_ring": lambda: cf.batch_step_ring(
            mp, H, W, raw, *ms[:3], flags, ms[3], valid, 0, 0)}
    res = {name: [per_frame(fn) for _ in range(3)]
           for name, fn in calls.items()}
    from dips_tpu_torch import DiPsEngine
    one = [list(frames_of(1, B)), list(frames_of(2, B))]
    for label, props in (("COLORIZE w3/T4", mp), ("ABSDIFF", rp)):
        eng = DiPsEngine(props, H, W, batch=B, device="cuda")
        eng.process_batch(one[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(12):
            eng.process_batch(one[i % 2])
        res[f"engine {label} frames/s"] = 12 * B / (time.perf_counter()
                                                    - t0)
        del eng
    return res | {"card": card}


def profile_threshold(card, one, fleet_feeds, n_batches) -> list:
    """THRESHOLD rows, ring-carry, unpacked and packed_wire in turns."""
    from dips_tpu_torch import (DiPsEngine, DiPsProperties,
                                MultiStreamEngine, OutputMode)
    from dips_tpu_torch.ops.reference import pad_geometry
    props = DiPsProperties(output=OutputMode.THRESHOLD)
    hp, wp = pad_geometry(H, W)
    rows = []
    for packed in (False, True, True, False):
        for fleet in (False, True):
            s = S if fleet else 1
            if fleet:
                eng = MultiStreamEngine(props, H, W, S, batch=B,
                                        device="cuda", packed_wire=packed)
                row = profile(lambda i: eng.process_batch(
                    fleet_feeds[i % 2]), n_batches)
            else:
                eng = DiPsEngine(props, H, W, batch=B, device="cuda",
                                 packed_wire=packed)
                row = profile(lambda i: eng.process_batch(one[i % 2]),
                              n_batches)
            row.update(
                engine=(f"MultiStreamEngine 1080p x {S} B=16" if fleet
                        else "DiPsEngine 1080p B=16"),
                pipeline="THRESHOLD" + (" packed_wire" if packed else ""),
                protocol="ring", card=card,
                d2h_mb=s * B * (hp // 8 * wp if packed else H * W) / 1e6)
            print(json.dumps(row), flush=True)
            rows.append(row)
            del eng
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--ring-paths", action="store_true")
    ap.add_argument("--threshold", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_engines: torch sees no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    if args.ring_paths:
        print(json.dumps(time_ring_paths(card)), flush=True)
        return
    from dips_tpu_torch import (DiPsEngine, DiPsProperties,
                                MultiStreamEngine, OutputMode)
    one = [list(frames_of(1, B)), list(frames_of(2, B))]
    fleet_feeds = [[list(frames_of(10 * j + si, B)) for si in range(S)]
                   for j in range(2)]
    rows = []
    if args.threshold:
        rows = profile_threshold(card, one, fleet_feeds, args.batches)
    pipelines = [] if args.threshold else [
        ("COLORIZE w3/T4", DiPsProperties()),
        ("ABSDIFF", DiPsProperties(output=OutputMode.ABSDIFF))]
    for label, props in pipelines:
        for ring in (True, False):
            eng = DiPsEngine(props, H, W, batch=B, device="cuda",
                             ring_carry=ring)
            row = profile(lambda i: eng.process_batch(one[i % 2]),
                          args.batches)
            row.update(engine="DiPsEngine 1080p B=16", pipeline=label,
                       protocol="ring" if ring else "tail", card=card)
            print(json.dumps(row), flush=True)
            rows.append(row)
            del eng
            fleet = MultiStreamEngine(props, H, W, S, batch=B,
                                      device="cuda", ring_carry=ring)
            row = profile(lambda i: fleet.process_batch(fleet_feeds[i % 2]),
                          args.batches)
            row.update(engine=f"MultiStreamEngine 1080p x {S} B=16",
                       pipeline=label, protocol="ring" if ring else "tail",
                       card=card)
            print(json.dumps(row), flush=True)
            rows.append(row)
            del fleet
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
