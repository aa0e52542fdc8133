#!/usr/bin/env python3
"""Where the time goes in the port's engines on one card, both protocols.

    python3 profile_engines.py [--batches 3] [--out profile.json]

Runs on a machine with an NVIDIA card.  For the single-stream engine
(1080p, B = 16) and the 8-stream fleet (1080p x 8, B = 16), COLORIZE w3/T4
and ABSDIFF, each on the ring-carry and the tail protocol, and COLORIZE
w3/T4 with ``emit_maps=False`` on the ring-carry protocol (stats only: no
maps come down): one warm-up batch, then a closed loop of ``LOOP``
batches that holds its first result and its last one, as the benchmark's
closed loop holds a sample batch and the last, then ``--batches`` batches
of seeded frames under ``torch.profiler``.  Prints one JSON line per run,
and writes them all to ``--out``:

* ``loop_ms``: host clock per batch of the closed loop, untraced;
* ``reuse_share``: the share of the loop's batches whose download
  page-locked no new host block (``utils/downloads.py``), with
  ``new_blocks``, their count, and ``pinned_peak_bytes``, the page-locked
  host memory of the run at its peak (the engine's upload buffers
  included);
* ``wall_ms``: host clock per batch, host frames in to host maps out;
* ``busy_ms``: the union of the device's kernel and copy intervals per
  batch, and ``idle_share`` = 1 - busy / wall;
* ``step_ms``: the step's device time per launch (the raw step's
  launch is its kernel and the stats reduction kernel after it, both
  counted);
* ``d2h_ms`` / ``h2d_ms``: device time of the copies per batch;
  ``d2h_mb``, the bytes the engine downloaded per batch, and
  ``d2h_gbps``, those bytes over ``d2h_ms``;
* ``top``: the five device ops with the most time per batch;
* ``stage_ms``: host time of each engine stage per batch, the union of
  its ``dips.engine.<stage>`` spans (``stage_in``, ``tail_keep``,
  ``h2d``, ``dispatch``, ``wait``, ``d2h``; the fleet's per-stream spans
  count once), and ``idle_staging_share``: the share of the wall in
  which the device is idle while the host is inside ``stage_in`` or
  ``tail_keep``;
* ``staging``: the engine's staging record over the row (warm-up, loop
  and traced batches; ``utils/staging.py``): ``pooled_share`` (the
  calls whose host copy the thread pool made), ``threads``, ``gbps``,
  the bytes staged over the time in ``stage_in`` and ``tail_keep``, and
  ``pieces``, the upload pieces a batch (1.0: every batch went up whole;
  None on a package without the record or the count).

Each run also prints the card's name and power limit.  Without a card it
exits non-zero.

``--threshold`` instead profiles the THRESHOLD pipeline, ring-carry, with
and without ``packed_wire`` (the masks bit-packed on the card before the
download), single stream and fleet, in turns (unpacked, packed, packed,
unpacked).

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
#: batches of the untraced closed loop of every row
LOOP = 40


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


def stage_spans(prof):
    """(stage, start_us, end_us) of every engine stage span of a profile."""
    from torch.autograd import DeviceType

    from dips_tpu_torch.utils.profiling import SPAN_PREFIX
    return [(e.name[len(SPAN_PREFIX):], e.time_range.start,
             e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CPU
            and e.name.startswith(SPAN_PREFIX)]


def merged(iv):
    """The union of the intervals as disjoint [start, end] pairs."""
    out = []
    for _, a, b in sorted(iv, key=lambda x: x[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def union_us(iv) -> float:
    return sum(b - a for a, b in merged(iv))


def idle_inside_us(spans, iv) -> float:
    """Time inside the union of ``spans`` with no device interval."""
    busy = merged(iv)
    idle = 0.0
    for a, b in merged(spans):
        idle += (b - a) - sum(max(0.0, min(b, d) - max(a, c))
                              for c, d in busy)
    return idle


def closed_loop(run_batch, downloads) -> dict:
    """``LOOP`` batches, each called as the last returns, holding the
    first result and the last one: the host time a batch and how often a
    download page-locked a new block."""
    new0 = downloads.new_blocks
    first = last = None
    t0 = time.perf_counter()
    for i in range(LOOP):
        last = run_batch(i + 1)
        if first is None:
            first = last
    loop = (time.perf_counter() - t0) * 1e3 / LOOP
    new = downloads.new_blocks - new0
    return {"loop_ms": loop, "new_blocks": new,
            "reuse_share": 1 - new / LOOP}


def profile(run_batch, downloads, n_batches: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    # this run's page-locked memory only: the earlier runs' cached blocks
    # are freed
    torch._C._host_emptyCache()
    torch.cuda.reset_peak_host_memory_stats()
    run_batch(0)  # warm-up
    looped = closed_loop(run_batch, downloads)
    torch.cuda.synchronize()
    nbytes0 = downloads.nbytes
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_batches):
            run_batch(i + 1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_batches
    d2h_mb = (downloads.nbytes - nbytes0) / 1e6 / n_batches
    pinned_peak = torch.cuda.host_memory_stats()["allocated_bytes.peak"]
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
    spans = stage_spans(prof)
    stage_ms = {}
    for name, _, _ in spans:
        stage_ms[name] = union_us([x for x in spans if x[0] == name]
                                  ) / 1e3 / n_batches
    staging = [x for x in spans if x[0] in ("stage_in", "tail_keep")]
    d2h = pick("DtoH")
    return looped | {
        "pinned_peak_bytes": pinned_peak,
        "wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
        "step_ms": sum(step) / 1e3 / launches if launches else None,
        "step_launches": launches,
        "d2h_ms": d2h, "h2d_ms": pick("HtoD"), "d2h_mb": d2h_mb,
        "d2h_gbps": d2h_mb / d2h if d2h else None,
        "top": [(k[:60], v / 1e3 / n_batches) for k, v in top],
        "stage_ms": stage_ms,
        "idle_staging_share": idle_inside_us(staging, iv) / 1e3
        / n_batches / wall}


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


def profile_engine(eng, feeds, n_batches: int, **labels) -> dict:
    """One run of ``eng`` on the two inputs of ``feeds`` in turns, its
    downloads counted, printed as a JSON line with ``labels``."""
    from dips_tpu_torch.utils.profiling import StageTimers
    eng.timers = StageTimers()
    row = profile(lambda i: eng.process_batch(feeds[i % 2]), eng.downloads,
                  n_batches)
    staged = getattr(eng, "staging", None)
    row["staging"] = None if staged is None else {
        "pooled_share": staged.pooled_share, "threads": staged.threads,
        "gbps": staged.gbps(eng.timers), "batches": staged.batches,
        "pieces": getattr(staged, "pieces", None)}
    row.update(labels)
    print(json.dumps(row), flush=True)
    return row


def profile_threshold(card, one, fleet_feeds, n_batches) -> list:
    """THRESHOLD rows, ring-carry, unpacked and packed_wire in turns."""
    from dips_tpu_torch import (DiPsEngine, DiPsProperties,
                                MultiStreamEngine, OutputMode)
    props = DiPsProperties(output=OutputMode.THRESHOLD)
    rows = []
    for packed in (False, True, True, False):
        pipeline = "THRESHOLD" + (" packed_wire" if packed else "")
        eng = DiPsEngine(props, H, W, batch=B, device="cuda",
                         packed_wire=packed)
        rows.append(profile_engine(
            eng, one, n_batches, engine="DiPsEngine 1080p B=16",
            pipeline=pipeline, protocol="ring", card=card))
        del eng
        eng = MultiStreamEngine(props, H, W, S, batch=B, device="cuda",
                                packed_wire=packed)
        rows.append(profile_engine(
            eng, fleet_feeds, n_batches,
            engine=f"MultiStreamEngine 1080p x {S} B=16",
            pipeline=pipeline, protocol="ring", card=card))
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
    # (label, properties, protocols): the stats-only rows download no
    # maps, the control of every change to the maps' download
    pipelines = [] if args.threshold else [
        ("COLORIZE w3/T4", DiPsProperties(), (True, False)),
        ("ABSDIFF", DiPsProperties(output=OutputMode.ABSDIFF),
         (True, False)),
        ("COLORIZE w3/T4 emit_maps=False",
         DiPsProperties(emit_maps=False), (True,))]
    for label, props, protocols in pipelines:
        for ring in protocols:
            protocol = "ring" if ring else "tail"
            eng = DiPsEngine(props, H, W, batch=B, device="cuda",
                             ring_carry=ring)
            rows.append(profile_engine(
                eng, one, args.batches,
                engine="DiPsEngine 1080p B=16", pipeline=label,
                protocol=protocol, card=card))
            del eng
            eng = MultiStreamEngine(props, H, W, S, batch=B, device="cuda",
                                    ring_carry=ring)
            rows.append(profile_engine(
                eng, fleet_feeds, args.batches,
                engine=f"MultiStreamEngine 1080p x {S} B=16",
                pipeline=label, protocol=protocol, card=card))
            del eng
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
