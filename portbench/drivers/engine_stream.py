"""One stream, closed loop: ``DiPsEngine.process_batch`` of B host frames
after another, as fast as it returns; maps and stats land on the host.

Traffic parameters (the cell's ``traffic``): the frame pool's
(``pool_size``, ``objects``, ``object_px``, ``speed_px``,
``sensor_noise``); ``warmup_batches`` run in set-up; ``keep`` batches of
the window, drawn from the seed, and the last one are checked;
``trace_after_s`` and ``trace_calls`` place the traced stretch.
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


def run(ctx: Context) -> Run:
    import torch
    from dips_tpu_torch import DiPsEngine
    from dips_tpu_torch.utils.profiling import StageTimers

    cfg, traffic = ctx.config, ctx.cell["traffic"]
    h, w, b = int(cfg["height"]), int(cfg["width"]), int(cfg["batch"])
    res = Run(cell=ctx.cell, config=cfg)
    pool = make_pool(ctx.seed, h, w, traffic)
    eng = DiPsEngine(program.props(cfg), h, w, batch=b, device=ctx.device,
                     ring_carry=bool(cfg["ring_carry"]),
                     input_layout=cfg["input_layout"])
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

    def step(k: int):
        i0 = first + k * b
        maps, stats = eng.process_batch(frames_at(i0))
        return i0, maps, stats

    def start_timers():
        eng.timers = StageTimers()

    def timers_of():
        t = eng.timers
        eng.timers = None
        return {"totals": dict(t.totals), "counts": dict(t.counts)}

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

    checks = Checks(ctx.cell["limits"])
    prm = params_from_config(cfg)
    replay = StreamReplay(pool, 0, prm, pool_planes(pool, prm, per_stream))
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
