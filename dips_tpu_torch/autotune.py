"""On-card kernel-geometry autotuner: ``python -m dips_tpu_torch.autotune``.

Counterpart of ``dips_tpu/autotune.py``.  The CUDA kernels' block geometry
is a build parameter (``ops/_build.py``), fixed by default in the sources:
the median kernels' tile (8 rows x 4 adjacent pixels a thread, 3 frames
staged ahead) and the raw kernel's block (256 threads x 16 bytes of a row
a thread).  This tool measures other geometries on the attached card and
persists, per card name, the fastest that agrees with the default:

* **median kernels** (ring and tail, per window): tiles of ``rows`` a
  multiple of 8 dividing the padded height, up to 32 (``_bh_candidates``,
  as JAX's), ``px`` in (1, 2, 4) and ``stages`` in (2, 3, 4), less those
  whose shared memory cannot launch (``find_largest_fitting`` over the
  rows of each (px, stages): the port's counterpart of the VMEM edge);
* **raw kernel**: blocks of (128, 256, 512) threads x (16, 32) bytes;
* ``--stacked S``: the ring kernels at S streams stacked along the rows
  (the fleet and coalesced-serving shape), persisted under their own keys;
* ``--mesh SxR``: the band-form median ring kernel at the owned slab
  height (padded height / R) a row-sharded deployment launches;
* ``--mesh SxR --stacked S``: also that band form at S owned slabs stacked
  along the rows (a grid cell holding S streams: the grid fleet's
  launch), persisted under ``stacked_slab_ring_tiles``.

Each candidate is built for its kernel's compile unit alone (one ``nvcc``
each, all started together).  Before it is timed its outputs are held
against the default geometry's on the same inputs: maps and carried state
bit for bit, the statistics within 1e-5 (the number of per-warp partials
changes with the tile).  A candidate that disagrees is an error, never a
candidate.  Timing: device-resident loops of launches (the kernel alone,
no host work between launches) under CUDA events, the minimum of 3 runs,
fitted over two loop lengths (the longer one at least 8 ms of the default
geometry's launches); every candidate is timed so once a round in
:data:`ROUNDS` interleaved rounds, each round starting at another
candidate, and its time is the median of its rounds.  The fastest
candidate is kept only when its slowest round beats the default's fastest
round by more than 2% (a gain inside the spread between rounds is no
gain); else the default stays.  Every candidate's ms a stream-frame and
spread (max - min over median) are printed beside the card's name and
power limit.

Results persist through :mod:`dips_tpu_torch.ops.tuning`; the geometry
pickers consult that store before the defaults, so running this once per
card is enough and never required.  The tiles are measured in the exact
median, and only its launches use them (the approx and quirk modes keep
the default tile).  Without a card it exits 1: there is
nothing to measure on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Optional, Tuple

import numpy as np

from .ops import _build, tuning
from .ops._build import MedianTile, RawBlock
from .ops.reference import pad_geometry
from .properties import DiPsMethod, DiPsProperties, OutputMode

log = logging.getLogger("dips_tpu_torch.autotune")

#: candidate tile pixels a thread, frames staged ahead, and tile rows cap
TILE_PX = (1, 2, 4)
TILE_STAGES = (2, 3, 4)
MAX_TILE_ROWS = 32
#: candidate raw block threads and bytes a thread
BLOCK_THREADS = (128, 256, 512)
BLOCK_BYTES = (16, 32)
#: a candidate's slowest round must beat the default's fastest by more
#: than this share for it to be kept
MIN_GAIN = 0.02
#: interleaved timing rounds of every candidate
ROUNDS = 5
#: the longer loop of a fit lasts at least this long (seconds): a short
#: kernel (raw or a slab at s = 1) timed over a few ms has rounds that
#: spread more, and the margin rule reads the extreme rounds
FIT_SECONDS = 0.008
#: the spatial mode the tiles are measured in (exact median)
EXACT = 0
#: statistics tolerance of a candidate against the default (relative)
STATS_RTOL = 1e-5


class GeometryMismatch(AssertionError):
    """A candidate geometry's outputs differ from the default's: a fault in
    the kernel at that geometry, never a slower candidate."""


def _bh_candidates(hp: int) -> list:
    """Row-block candidates: multiples of 8 dividing hp, ascending."""
    return [8 * d for d in range(1, hp // 8 + 1) if hp % (8 * d) == 0]


def find_largest_fitting(candidates: Iterable[int], prior: int,
                         fits: Callable[[int], bool]) -> Optional[int]:
    """Largest candidate for which ``fits`` holds, assuming fit is monotone
    (smaller always fits if larger does).  Walks from the candidate nearest
    ``prior`` — one probe when the prior is already the edge — instead of
    bisecting blind (each probe is a ~30 s compile on real hardware).
    Returns None when nothing fits."""
    cands = sorted(set(candidates))
    if not cands:
        return None
    i = min(range(len(cands)), key=lambda k: abs(cands[k] - prior))
    if fits(cands[i]):
        while i + 1 < len(cands) and fits(cands[i + 1]):
            i += 1
        return cands[i]
    while i > 0:
        i -= 1
        if fits(cands[i]):
            return cands[i]
    return None


def _two_point_fit(run: Callable[[int], None], iters: Tuple[int, int],
                   repeats: int = 3) -> float:
    """Seconds a launch: ``run(n)`` enqueues n launches back to back, timed
    with CUDA events; the minimum of ``repeats`` runs at each of two loop
    lengths, and the slope between them (what a call costs outside the
    loop cancels).  A non-positive slope retries at 4x the lengths."""
    import torch
    n1, n2 = iters
    for _ in range(4):
        best = []
        for n in (n1, n2):
            times = []
            for _ in range(repeats):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run(n)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
            best.append(min(times))
        per = (best[1] - best[0]) / (n2 - n1)
        if per > 0:
            return per
        n1, n2 = 4 * n1, 4 * n2
        log.info("non-positive fit, escalating to iters=(%d, %d)", n1, n2)
    raise RuntimeError("the two-point fit found no positive time a launch")


def _fit_lengths(run: Callable[[int], None]) -> Tuple[int, int]:
    """The two loop lengths of :func:`_two_point_fit` for ``run`` (the
    default geometry's loop): (8k, 24k), k the least for which 24k
    launches last :data:`FIT_SECONDS`."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    run(24)  # warm
    start.record()
    run(24)
    end.record()
    end.synchronize()
    k = max(1, math.ceil(FIT_SECONDS / max(start.elapsed_time(end) / 1e3,
                                           1e-9)))
    return 8 * k, 24 * k


def tile_candidates(hp: int, window: int, t: int,
                    limit: int) -> list:
    """The tiles to measure for a median kernel at section height ``hp``:
    rows from :func:`_bh_candidates` up to :data:`MAX_TILE_ROWS`, every
    (px, stages), less the rows whose shared memory at this window and ring
    length exceeds ``limit`` bytes (found by :func:`find_largest_fitting`:
    shared memory grows with the rows)."""
    rows = [r for r in _bh_candidates(hp) if r <= MAX_TILE_ROWS]
    out = []
    for px in TILE_PX:
        for stages in TILE_STAGES:
            edge = find_largest_fitting(
                rows, _build.DEFAULT.tile.rows,
                lambda r, _p=px, _s=stages: MedianTile(r, _p, _s).smem_bytes(
                    window, EXACT, t) <= limit)
            if edge is not None:
                out += [MedianTile(r, px, stages) for r in rows if r <= edge]
    return out


def block_candidates(wp: int) -> list:
    """The raw blocks to measure for rows of ``wp`` bytes."""
    return [RawBlock(th, by) for th in BLOCK_THREADS for by in BLOCK_BYTES
            if wp % by == 0]


def _median(rounds: dict) -> dict:
    return {g: float(np.median(v)) for g, v in rounds.items()}


def choose(rounds: dict, default):
    """The fastest geometry of ``rounds`` ({geometry: [seconds a round]})
    by its median, kept only when its slowest round beats ``default``'s
    fastest by more than :data:`MIN_GAIN`; else ``default``."""
    med = _median(rounds)
    best = min(med, key=med.get)
    if max(rounds[best]) > min(rounds[default]) * (1 - MIN_GAIN):
        return default
    return best


def time_rounds(cands: list, time: Callable, rounds: int = ROUNDS) -> dict:
    """{candidate: [seconds of each round]}: ``time(c)`` of every candidate
    once a round, ``rounds`` rounds, round r starting at candidate r * n /
    rounds, so that drift of clocks or temperature along a round does not
    favour one position."""
    n = len(cands)
    out = {c: [] for c in cands}
    for r in range(rounds):
        k = r * n // rounds
        for c in cands[k:] + cands[:k]:
            out[c].append(time(c))
    return out


def _outcome(rounds: dict, default, key: str, frames: int) -> dict:
    """A probe's result from its rounds: {key: the chosen geometry, "ms"
    and "default_ms" (medians, a stream-frame), "times" and "spread" ({name:
    median ms, (max - min) / median}), "rival" (the fastest other than the
    default) and "margin" (by how much the rival's slowest round beat the
    default's fastest: the rule keeps it from :data:`MIN_GAIN` up)}."""
    med = _median(rounds)
    ms = lambda g: med[g] * 1e3 / frames  # noqa: E731
    best = choose(rounds, default)
    others = [g for g in med if g != default]
    rival = min(others, key=med.get) if others else None
    return {key: best, "ms": ms(best), "default_ms": ms(default),
            "times": {g.name(): ms(g) for g in med},
            "spread": {g.name(): (max(v) - min(v)) / med[g]
                       for g, v in rounds.items()},
            "rival": rival,
            "margin": (1 - max(rounds[rival]) / min(rounds[default])
                       if rival else None)}


def _build_all(specs) -> None:
    """Build the libraries of ``specs`` [(Geometry, units)] at once, one
    thread a library (each runs its own nvcc), up to one a core."""
    specs = list(dict.fromkeys(specs))
    if not specs:
        return
    workers = max(1, min(len(specs), len(os.sched_getaffinity(0))))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures = [pool.submit(_build.build, geometry=g, units=u)
                   if g != _build.DEFAULT else pool.submit(_build.build)
                   for g, u in specs]
        for f in futures:
            f.result()


def _stats_agree(got, exp, rtol: float = STATS_RTOL) -> bool:
    """Statistics (..., 4): maxima and counts equal; the two sums within
    ``rtol`` of their own magnitude or of the mean |diff| (which bounds
    the rounding of a sum that cancels)."""
    g = got.double().reshape(-1, 4).cpu().numpy()
    e = exp.double().reshape(-1, 4).cpu().numpy()
    if not np.array_equal(g[:, 2:], e[:, 2:]):
        return False
    scale = np.maximum(np.abs(e[:, :2]), np.abs(e[:, 1:2]))
    return bool((np.abs(g[:, :2] - e[:, :2]) <= rtol * scale + 1e-12).all())


def _hold(tag: str, got: list, exp: list, stats_exact: bool) -> None:
    """Two batches' results (out, stats, *state) of a candidate against
    the default's: maps and state bit for bit, stats as
    :func:`_stats_agree` (or bit for bit)."""
    import torch
    for b, (g, e) in enumerate(zip(got, exp)):
        for i, (x, y) in enumerate(zip(g, e)):
            if i == 1:
                ok = torch.equal(x, y) if stats_exact else _stats_agree(x, y)
            else:
                ok = torch.equal(x, y)
            if not ok:
                what = ("maps", "stats")[i] if i < 2 else f"state {i - 2}"
                raise GeometryMismatch(f"{tag}: {what} of batch {b} differ "
                                       f"from the default geometry's")


def _flags(s: int, b: int):
    flags = np.zeros((s, b), bool)
    flags[:, 0] = True
    flags[:, b // 3] = True
    return flags, np.ones((s, b), bool)


def _median_measure_factory(window: int, h: int, w: int, t: int, b: int,
                            s: int = 1, tail: bool = False,
                            rows_ax: int = 1, seed: int = 0):
    """(hold, time, section height, Wp) of the median ring (tail) kernel
    at s stacked sections of the padded height / ``rows_ax`` (the band
    form when ``rows_ax`` > 1, as ``parallel/grid2d`` launches it: raw
    (B, 3, s*Hs, Wp), the two bands (B, 3, s*8, Wp), the row window of a
    slab inside the image).  ``hold(tile)`` runs two batches and holds
    them against the default tile's (raises :class:`GeometryMismatch`);
    ``time(tile)`` -> seconds a launch (:func:`_two_point_fit`)."""
    import torch
    from .ops import cuda_fused
    from .ops.reference import BAND_ROWS

    dev = torch.device("cuda", torch.cuda.current_device())
    props = DiPsProperties(window_size=window, temporal_size=t,
                           method=DiPsMethod.OVERALL,
                           output=OutputMode.COLORIZE)
    hp, wp = pad_geometry(h, w)
    hs = hp // rows_ax
    frames = (t if tail else 0) + b
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def noise(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen)

    raw = noise(frames, 3, s * hs, wp)
    bands = ((noise(frames, 3, s * BAND_ROWS, wp),
              noise(frames, 3, s * BAND_ROWS, wp)) if rows_ax > 1 else None)
    row_bounds = (0, hs) if rows_ax > 1 else None
    flags, valid = _flags(s, b)

    def fresh():
        z = lambda *shape: torch.zeros(shape, device=dev)  # noqa: E731
        return {"ring": None if tail else z(t, s * hs, wp),
                "prev": None if tail else z(s * hs, wp),
                "baseline": z(s * hs, wp), "heatmap": z(s * hs, wp)}

    def run(tile, st, seeded, reps=1):
        res, _ = cuda_fused._launch_median(
            "autotune", props, h, w, s, raw, st["ring"], st["prev"],
            st["baseline"], flags, st["heatmap"], valid,
            None if tail else np.zeros(s, np.int64),
            None if tail else np.full(s, int(seeded)), row_bounds, bands,
            tile=tile, reps=reps)
        return res

    def two_batches(tile):
        st = fresh()
        out = [[x.clone() for x in run(tile, st, True)]]
        out.append([x.clone() for x in run(tile, st, False)])
        torch.cuda.synchronize()
        return out

    ref = two_batches(_build.DEFAULT.tile)
    kernel = "median_tail" if tail else "median_ring"
    timed = fresh()
    run(_build.DEFAULT.tile, timed, True)
    iters = _fit_lengths(
        lambda n: run(_build.DEFAULT.tile, timed, False, reps=n))

    def hold(tile: MedianTile) -> None:
        _hold(f"{kernel} w{window} s{s} {tile.name()}", two_batches(tile),
              ref, stats_exact=False)

    def time(tile: MedianTile) -> float:
        return _two_point_fit(lambda n: run(tile, timed, False, reps=n),
                              iters)

    return hold, time, hs, wp


def _raw_measure_factory(h: int, w: int, t: int, b: int, s: int = 1,
                         seed: int = 0):
    """(hold, time, Hp, Wp) of the raw ring kernel (ABSDIFF) at s stacked
    streams: ``hold(block)`` holds two batches against the default
    block's (everything bit for bit: the statistics are integer sums),
    ``time(block)`` -> seconds a launch."""
    import torch
    from .ops import cuda_fused

    dev = torch.device("cuda", torch.cuda.current_device())
    props = DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=t,
                           method=DiPsMethod.PER_FRAME)
    hp, wp = pad_geometry(h, w)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    raw = torch.randint(0, 256, (b, 3, s * hp, wp), dtype=torch.uint8,
                        device=dev, generator=gen)
    flags, valid = _flags(s, b)

    def fresh():
        z = lambda: torch.zeros((3, s * hp, wp), dtype=torch.uint8,  # noqa
                                device=dev)
        return {"prev": z(), "baseline": z(),
                "heatmap": torch.zeros((s * hp, wp), device=dev)}

    def run(block, st, seeded, reps=1):
        res, _ = cuda_fused._launch_raw(
            "autotune", props, h, w, s, raw, st["prev"], st["baseline"],
            flags, st["heatmap"], valid, np.full(s, int(seeded)),
            block=block, reps=reps)
        return res

    def two_batches(block):
        st = fresh()
        out = [[x.clone() for x in run(block, st, True)]]
        out.append([x.clone() for x in run(block, st, False)])
        torch.cuda.synchronize()
        return out

    ref = two_batches(_build.DEFAULT.block)
    timed = fresh()
    run(_build.DEFAULT.block, timed, True)
    iters = _fit_lengths(
        lambda n: run(_build.DEFAULT.block, timed, False, reps=n))

    def hold(block: RawBlock) -> None:
        _hold(f"raw s{s} {block.name()}", two_batches(block), ref,
              stats_exact=True)

    def time(block: RawBlock) -> float:
        return _two_point_fit(lambda n: run(block, timed, False, reps=n),
                              iters)

    return hold, time, hp, wp


def probe_tiles(windows=(3, 5, 7), h: int = 1080, w: int = 1920,
                t: int = 4, b: int = 16, s: int = 1, tail: bool = False,
                rows_ax: int = 1, limit: Optional[int] = None,
                measure_factory=None, build=_build_all) -> dict:
    """The median ring (``tail``: tail) kernel's tile per window on this
    card: {window: :func:`_outcome` with key "tile"}.  Every candidate is
    held against the default before any is timed.  Windows are clamped as
    the properties clamp them (the key the pickers consult); ``rows_ax`` >
    1 measures the band form at the owned height (windows > 1 only)."""
    factory = measure_factory or _median_measure_factory
    if limit is None:
        import torch
        from .ops.cuda_fused import _smem_limit
        limit = _smem_limit(torch.device("cuda",
                                         torch.cuda.current_device()))
    windows = sorted({DiPsProperties(window_size=win).window_size
                      for win in windows})
    if rows_ax > 1:
        windows = [win for win in windows if win > 1]
    results = {}
    for win in windows:
        hold, time, hs, wp = factory(win, h, w, t, b, s=s, tail=tail,
                                     rows_ax=rows_ax)
        cands = tile_candidates(hs, win, t, limit)
        unit = _build.median_unit(tail, win)
        build([(_build.Geometry(tile=c), (unit,)) for c in cands])
        for c in cands:
            hold(c)
        results[win] = _outcome(time_rounds(cands, time),
                                _build.DEFAULT.tile, "tile", s * b)
    return results


def probe_raw_block(h: int = 1080, w: int = 1920, t: int = 4, b: int = 16,
                    s: int = 1, measure_factory=None,
                    build=_build_all) -> dict:
    """The raw kernel's block on this card: :func:`_outcome` with key
    "block"; every candidate held before any is timed."""
    factory = measure_factory or _raw_measure_factory
    hold, time, hp, wp = factory(h, w, t, b, s=s)
    cands = block_candidates(wp)
    build([(_build.Geometry(block=c), (_build.RAW_UNIT,)) for c in cands])
    for c in cands:
        hold(c)
    return _outcome(time_rounds(cands, time), _build.DEFAULT.block, "block",
                    s * b)


def _report(label: str, res: dict, card: str, default_name: str,
            key: str) -> None:
    print(f"[autotune] {label} ({card}): ms a stream-frame, the median of "
          f"{ROUNDS} rounds (spread: max - min over the median)")
    for name, ms in res["times"].items():
        mark = " (default)" if name == default_name else ""
        print(f"[autotune]   {name}{mark}: {ms:.5f} "
              f"({100 * res['spread'][name]:.1f}%)")
    rival = (f"; fastest other {res['rival'].name()}, margin "
             f"{100 * res['margin']:.1f}%" if res["rival"] else "")
    print(f"[autotune] chosen {label}: {res[key].name()} ({res['ms']:.5f} "
          f"against {res['default_ms']:.5f}{rival})", flush=True)


def _card_line() -> str:
    from .doctor import _power_line
    import torch
    return _power_line() or torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dips-torch-autotune",
        description="Measure the CUDA kernels' block geometries on the "
                    "attached card and persist per-card overrides (one "
                    "nvcc build a candidate, all at once, then a few ms "
                    "of timing each)")
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--windows", type=int, nargs="+", default=[3, 5, 7])
    ap.add_argument("--temporal", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--skip-ring", action="store_true",
                    help="skip the median kernels (ring and tail)")
    ap.add_argument("--skip-raw", action="store_true")
    ap.add_argument("--stacked", type=int, metavar="S", default=None,
                    help="ALSO probe the median ring and raw kernels at S "
                         "streams stacked along the rows (the fleet and "
                         "coalesced-serving shape) and persist stacked_* "
                         "overrides the stacked launches consume; with "
                         "--mesh, also the band form at S owned slabs a "
                         "launch (stacked_slab_ring_tiles)")
    ap.add_argument("--mesh", metavar="SxR", default=None,
                    help="ALSO probe the band-form median ring kernel at "
                         "the owned height an SxR (stream x rows) grid "
                         "launches (padded height / R) and persist "
                         "per-(card, window, owned-height) tiles the grid "
                         "engines consume (window 1 skipped: no stencil); "
                         "with --stacked S, at S owned slabs a launch too")
    ap.add_argument("--dry-run", action="store_true",
                    help="measure and report, but do not write the store")
    from .utils.compilecache import (add_compile_cache_flag,
                                     apply_compile_cache_flag)
    add_compile_cache_flag(ap)
    args = ap.parse_args(argv)
    apply_compile_cache_flag(args)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(message)s")

    import torch
    if not torch.cuda.is_available():
        print("autotune needs a CUDA card (torch sees none: the CPU runs "
              "the plain twins, which have no block geometry to measure); "
              "the default geometry remains in use", file=sys.stderr)
        return 1
    hp = pad_geometry(args.height, args.width)[0]
    r_ax = 1
    if args.mesh:
        try:
            s_ax, r_ax = (int(v) for v in args.mesh.lower().split("x"))
        except ValueError:
            print(f"bad --mesh {args.mesh!r} (want SxR, e.g. 2x4)",
                  file=sys.stderr)
            return 2
        if s_ax < 1 or r_ax < 1:
            print(f"--mesh axes must be >= 1, got {args.mesh!r}",
                  file=sys.stderr)
            return 2
        if hp % (8 * r_ax):
            print(f"--mesh rows axis {r_ax} does not 8-row-align the "
                  f"padded height {hp} (pick a divisor of {hp // 8} "
                  f"tiles)", file=sys.stderr)
            return 2
    kind = torch.cuda.get_device_name(0)
    card = _card_line()
    geo = (args.height, args.width, args.temporal, args.batch)
    print(f"[autotune] {card}: {args.width}x{args.height} "
          f"(t={args.temporal}, b={args.batch})", flush=True)
    tile_name = _build.DEFAULT.tile.name()
    block_name = _build.DEFAULT.block.name()
    found = {}
    s_l = max(2, args.stacked) if args.stacked else 1
    probes = [] if args.skip_ring else [
        ("ring_tiles", "ring", {}), ("tail_tiles", "tail", {"tail": True})]
    if args.stacked and not args.skip_ring:
        probes.append(("stacked_ring_tiles", f"stacked[{s_l}] ring",
                       {"s": s_l}))
    if r_ax > 1 and not args.skip_ring:
        probes.append(("slab_ring_tiles", f"slab[{args.mesh}] ring",
                       {"rows_ax": r_ax}))
        if args.stacked:
            probes.append(("stacked_slab_ring_tiles",
                           f"stacked[{s_l}]-slab[{args.mesh}] ring",
                           {"s": s_l, "rows_ax": r_ax}))
    for key, name, kw in probes:
        for win, r in probe_tiles(tuple(args.windows), *geo, **kw).items():
            _report(f"{name} w{win}", r, card, tile_name, "tile")
            tile = {hp // r_ax: r["tile"]} if "rows_ax" in kw else r["tile"]
            found.setdefault(key, {})[win] = tile
    if not args.skip_raw:
        res = probe_raw_block(*geo)
        _report("raw", res, card, block_name, "block")
        found["raw_block"] = res["block"]
        if args.stacked:
            res = probe_raw_block(*geo, s=s_l)
            _report(f"stacked[{s_l}] raw", res, card, block_name, "block")
            found["stacked_raw_block"] = res["block"]

    if args.dry_run:
        print("[autotune] dry run: store not written", flush=True)
        return 0
    path = tuning.save(
        kind, **found,
        meta={"geometry": f"{args.width}x{args.height}",
              "temporal": args.temporal, "batch": args.batch,
              "card": card, "rounds": ROUNDS,
              **({"stacked": int(args.stacked)} if args.stacked else {}),
              **({"mesh": args.mesh} if args.mesh else {}),
              "tool": "dips_tpu_torch.autotune"})
    print(f"saved: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
