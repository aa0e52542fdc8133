"""One stream of a high-resolution camera analysed at a lower one, closed
loop: ``DiPsEngine(downscale=k).process_batch`` of B host frames at the
input size after another, as fast as it returns; maps and stats, at the
analysis size, land on the host.

The configuration gives the analysis size (``height``, ``width``), the
factor ``downscale`` and the input size (``input_height``,
``input_width``), as the daemon's ``hello`` does.  The frame pool is made
at the input size from the cell's ``traffic`` (as ``engine_stream``'s);
the reference replays the pool's frames pooled by the frozen box mean
(``reference/pool.py``), so the check holds the pooled frames to it too:
a pooled byte off by one moves the carried baseline (``base_gap``).
The engine's ``pool_counts`` (the decimation's own counters, where the
program keeps them) are read over the traced stretch beside its stage
timers.
"""

from __future__ import annotations

import time

import numpy as np

from .. import closedloop, program
from ..check import (Checks, base_gap, heat_gap, maps_lsb, per_stream,
                     stats_gap)
from ..frames import make_pool
from ..record import Context, Run
from ..reference import StreamReplay, params_from_config, pool_planes
from ..reference.pool import pool_frames


def run(ctx: Context) -> Run:
    import torch
    from dips_tpu_torch import DiPsEngine
    from dips_tpu_torch.utils.profiling import StageTimers

    cfg, traffic = ctx.config, ctx.cell["traffic"]
    h, w, b = int(cfg["height"]), int(cfg["width"]), int(cfg["batch"])
    k = int(cfg["downscale"])
    in_h, in_w = int(cfg["input_height"]), int(cfg["input_width"])
    if (in_h, in_w) != (h * k, w * k):
        raise ValueError(f"input {in_h}x{in_w} is not {k} x the analysis "
                         f"size {h}x{w}")
    res = Run(cell=ctx.cell, config=cfg)
    pool = make_pool(ctx.seed, in_h, in_w, traffic)
    eng = DiPsEngine(program.props(cfg), in_h, in_w, batch=b,
                     device=ctx.device, ring_carry=bool(cfg["ring_carry"]),
                     input_layout=cfg["input_layout"], downscale=k)
    n_pool = len(pool)

    def frames_at(i0: int):
        return [pool[(i0 + j) % n_pool] for j in range(b)]

    cursor = 0
    for _ in range(int(traffic["warmup_batches"])):
        eng.process_batch(frames_at(cursor))
        cursor += b
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    first = cursor
    res.setup_s = time.perf_counter() - ctx.t0

    def step(i: int):
        i0 = first + i * b
        maps, stats = eng.process_batch(frames_at(i0))
        return i0, maps, stats

    def start_timers():
        eng.timers = StageTimers()

    def timers_of():
        t, eng.timers = eng.timers, None
        got = {"totals": dict(t.totals), "counts": dict(t.counts)}
        counts = getattr(eng, "pool_counts", None)
        if counts is not None:
            got["pool"] = counts.as_dict()
        return got

    kept = closedloop.run_window(res, step, ctx.seconds, traffic, ctx.seed,
                                 ctx.trace, timers_of, start_timers)
    closedloop.frames_done(res, b)
    if eng.device.type == "cuda":
        res.memory_peak_bytes = int(torch.cuda.max_memory_allocated(
            eng.device))
    n_frames = eng.frame_index
    heat = eng.heatmap().copy()
    base = program.baseline_hwc(eng.state_dict()["baseline"], h, w)
    del eng
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    pooled = pool_frames(pool, k, per_stream)
    del pool
    checks = Checks(ctx.cell["limits"])
    prm = params_from_config(cfg)
    replay = StreamReplay(pooled, 0, prm,
                          pool_planes(pooled, prm, per_stream))
    replay.baseline()
    for _, (i0, maps, stats) in kept:
        exp = per_stream(lambda i: replay.output(i)[:2], range(i0, i0 + b))
        exp_maps = np.stack([m for m, _ in exp])
        exp_stats = np.stack([s for _, s in exp])
        checks.add("maps_lsb", maps_lsb(maps, exp_maps))
        checks.add("stats_gap", stats_gap(stats, exp_stats))
    checks.add("heat_gap", heat_gap(heat, replay.heatmap(n_frames)))
    checks.add("base_gap", base_gap(base, replay.baseline()))
    res.checks = checks.items()
    return res
