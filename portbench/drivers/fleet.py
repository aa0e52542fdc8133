"""A fleet of streams, closed loop: ``MultiStreamEngine.process_batch`` of
B host frames for each of S streams after another, as fast as it returns;
every stream's maps and stats land on the host.

Traffic parameters: those of ``engine_stream`` and ``streams`` (S) and
``stream_offset`` (stream k reads the pool from ``k * stream_offset``).
"""

from __future__ import annotations

import time

from .. import closedloop, program
from ..check import (Checks, base_gap, heat_gap, maps_lsb, per_stream,
                     stats_gap)
from ..frames import make_pool, stream_offsets
from ..record import Context, Run
from ..reference import StreamReplay, params_from_config


def run(ctx: Context) -> Run:
    import torch
    from dips_tpu_torch import MultiStreamEngine

    cfg, traffic = ctx.config, ctx.cell["traffic"]
    h, w, b = int(cfg["height"]), int(cfg["width"]), int(cfg["batch"])
    s = int(traffic["streams"])
    res = Run(cell=ctx.cell, config=cfg)
    pool = make_pool(ctx.seed, h, w, traffic)
    offs = stream_offsets(s, traffic)
    eng = MultiStreamEngine(program.props(cfg), h, w, n_streams=s, batch=b,
                            device=ctx.device,
                            ring_carry=bool(cfg["ring_carry"]),
                            input_layout=cfg["input_layout"])
    n_pool = len(pool)

    def feeds_at(i0: int):
        return [[pool[(i0 + o + j) % n_pool] for j in range(b)]
                for o in offs]

    cursor = 0
    for _ in range(int(traffic["warmup_batches"])):
        eng.process_batch(feeds_at(cursor))
        cursor += b
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    first = cursor
    res.setup_s = time.perf_counter() - ctx.t0

    def step(k: int):
        i0 = first + k * b
        maps, stats, _ = eng.process_batch(feeds_at(i0))
        return i0, maps, stats

    kept = closedloop.run_window(res, step, ctx.seconds, traffic, ctx.seed,
                                 ctx.trace)
    closedloop.frames_done(res, b * s)
    if eng.device.type == "cuda":
        res.memory_peak_bytes = int(torch.cuda.max_memory_allocated(
            eng.device))
    cursors = list(eng.frame_cursors)
    failed = sorted(eng.failed)
    heats = eng.heatmaps().copy()
    bases = eng.state_dict()["baseline"]
    del eng
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    checks = Checks(ctx.cell["limits"])
    checks.add("missing", len(failed))
    prm = params_from_config(cfg)

    def stream(si: int):
        replay = StreamReplay(pool, offs[si], prm)
        got = []
        for _, (i0, maps, stats) in kept:
            exp_maps, exp_stats = replay.outputs(range(i0, i0 + b))
            got += [("maps_lsb", maps_lsb(maps[si], exp_maps)),
                    ("stats_gap", stats_gap(stats[si], exp_stats))]
        return got + [
            ("heat_gap", heat_gap(heats[si], replay.heatmap(cursors[si]))),
            ("base_gap", base_gap(program.baseline_hwc(bases[si], h, w),
                                  replay.baseline()))]

    for got in per_stream(stream, range(s)):
        for name, value in got:
            checks.add(name, value)
    res.checks = checks.items()
    res.failed = len(failed) * len(res.batch_ms) * b
    return res
