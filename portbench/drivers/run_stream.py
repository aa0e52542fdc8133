"""One stream through the run path, closed loop: ``stream_dips`` (the
loop behind ``dips run``) over a reader of the seeded frame pool, with the
configuration's post-analysis: the FFT denoise of the maps and, at the
window's end, the temporal DFT of the per-frame mean-|diff| series
(``--denoise R --dft-json``).

The reader hands over RGB frames as a decoder would (``native_rgb``,
``iter_rgb_timed``), cycling the pool until the run closes it, so every
frame goes through the decode worker, the ``FrameRing``, the engine's
pinned buffer, the kernel and the denoise, as in ``dips run``.  A call of
the window pulls B frames from the generator; a frame counts once its
denoised maps and stats have reached the host.  Encoding is left out: the
maps are what ``stream_dips`` yields.

Traffic parameters: those of ``engine_stream`` and ``fps`` (the reader's
timestamps).  The check compares the denoised maps of ``frames_checked``
frames of each checked batch (its first and last, the rest drawn from the
seed), every channel, with the plain reference's denoise of the reference
maps (``maps_lsb``, and ``flip_share``, the share of bytes off by one, the
worst plane's), the batch's stats, the
heatmap and the baseline at the window's end, and the DFT of the
window's series with NumPy's float64 ``rfft`` of the same series
(``dft_gap``: the largest gap of a magnitude over the largest
magnitude).
"""

from __future__ import annotations

import time

import numpy as np

from .. import closedloop, program
from ..check import (Checks, base_gap, heat_gap, maps_lsb, per_stream,
                     stats_gap)
from ..frames import make_pool, rng_of
from ..record import Context, Run
from ..reference import StreamReplay, params_from_config, pool_planes
from ..reference.post import denoise_plane, rdft_magnitude


class PoolReader:
    """The frame pool as a decoder's reader: RGB frames from frame 0 on,
    cycling, with timestamps at ``fps``."""

    native_rgb = True
    frame_count = -1  # a live source: one decode worker

    def __init__(self, pool: np.ndarray, fps: float):
        self.pool, self.fps = pool, float(fps)
        self.height, self.width = pool.shape[1:3]

    def iter_rgb_timed(self):
        i = 0
        while True:
            yield self.pool[i % len(self.pool)], i / self.fps
            i += 1

    def close(self) -> None:
        pass


def flip_share(got: np.ndarray, exp: np.ndarray) -> float:
    """The share of bytes that differ (by any amount)."""
    if got.shape != exp.shape:
        return float("inf")
    return float(np.count_nonzero(got != exp)) / got.size


def dft_gap(got: np.ndarray, exp: np.ndarray) -> float:
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    if got.shape != exp.shape:
        return float("inf")
    return float(np.abs(got - exp).max() / max(np.abs(exp).max(), 1e-30))


def check_batch(checks: Checks, maps, stats: np.ndarray, exp: list,
                radius: int, pick, n_check: int) -> None:
    """One checked batch against the reference's ``exp``, the (map, stats)
    of each of its frames: the stats whole, and the denoised maps of
    ``n_check`` frames (the first and the last, the rest drawn by
    ``pick``), every channel, against the reference's denoise of its
    maps.  ``maps[j]`` is frame j's (H, W, C) uint8 map."""
    b = len(exp)
    checks.add("stats_gap", stats_gap(stats, np.stack([s for _, s in exp])))
    inner = pick.choice(np.arange(1, b - 1), max(n_check - 2, 0),
                        replace=False)
    frames = sorted({0, b - 1} | {int(j) for j in inner})
    planes = [(j, c) for j in frames for c in range(exp[j][0].shape[-1])]
    den = per_stream(lambda jc: denoise_plane(
        np.ascontiguousarray(exp[jc[0]][0][..., jc[1]]), radius), planes)
    for (j, c), ref in zip(planes, den):
        got = maps[j][..., c]
        checks.add("maps_lsb", maps_lsb(got, ref))
        checks.add("flip_share", flip_share(got, ref))


def check_dft(checks: Checks, mag: np.ndarray, series: np.ndarray) -> None:
    """The DFT magnitudes of ``series`` against NumPy's float64 ``rfft``
    of the same series."""
    checks.add("dft_gap", dft_gap(mag, rdft_magnitude(series)))


def run(ctx: Context) -> Run:
    import torch
    from dips_tpu_torch.app import DiPsJob, stream_dips
    from dips_tpu_torch.ops.analysis import temporal_dft
    from dips_tpu_torch.utils.profiling import StageTimers

    cfg, traffic = ctx.config, ctx.cell["traffic"]
    h, w, b = int(cfg["height"]), int(cfg["width"]), int(cfg["batch"])
    radius = int(cfg["post"]["denoise_radius"])
    res = Run(cell=ctx.cell, config=cfg)
    pool = make_pool(ctx.seed, h, w, traffic)
    job = DiPsJob(properties=program.props(cfg), video_path="portbench:pool",
                  batch=b, device=ctx.device, decode_workers=1,
                  pipeline_depth=1, input_layout=cfg["input_layout"],
                  denoise_radius=radius, yield_inputs=False,
                  reader=PoolReader(pool, float(traffic["fps"])))
    gen = stream_dips(job)
    series = []

    def pull():
        rows = [next(gen) for _ in range(b)]
        return (rows[0][0], [r[2] for r in rows],
                np.stack([r[3] for r in rows]))

    try:
        for _ in range(int(traffic["warmup_batches"])):
            pull()
        if ctx.device.startswith("cuda"):
            torch.cuda.synchronize()
        res.setup_s = time.perf_counter() - ctx.t0
        eng = job.engine

        def step(k: int):
            out = pull()
            series.append(out[2][:, 1])
            return out

        def start_timers():
            eng.timers = StageTimers()

        def timers_of():
            t, eng.timers = eng.timers, None
            got = {"totals": dict(t.totals), "counts": dict(t.counts)}
            counts = getattr(eng, "denoise_counts", None)
            if counts is not None:
                got["denoise"] = counts.as_dict()
            return got

        kept = closedloop.run_window(res, step, ctx.seconds, traffic,
                                     ctx.seed, ctx.trace, timers_of,
                                     start_timers)
    finally:
        gen.close()  # ends the decode worker
    closedloop.frames_done(res, b)
    if ctx.device.startswith("cuda"):
        res.memory_peak_bytes = int(torch.cuda.max_memory_allocated(
            eng.device))
    window_series = np.concatenate(series)
    mag, _ = temporal_dft(window_series, device=ctx.device)
    mag = mag.cpu().numpy()
    n_frames = eng.frame_index
    heat = eng.heatmap().copy()
    base = program.baseline_hwc(eng.state_dict()["baseline"], h, w)
    job.engine = eng = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    checks = Checks(ctx.cell["limits"])
    prm = params_from_config(cfg)
    replay = StreamReplay(pool, 0, prm, pool_planes(pool, prm, per_stream))
    replay.baseline()
    pick = rng_of(ctx.seed, 2)
    n_check = int(traffic["frames_checked"])
    for _, (i0, maps, stats) in kept:
        exp = per_stream(lambda i: replay.output(i)[:2], range(i0, i0 + b))
        check_batch(checks, maps, stats, exp, radius, pick, n_check)
    checks.add("heat_gap", heat_gap(heat, replay.heatmap(n_frames)))
    checks.add("base_gap", base_gap(base, replay.baseline()))
    check_dft(checks, mag, window_series)
    res.checks = checks.items()
    return res
