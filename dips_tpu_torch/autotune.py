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
  height (padded height / R) a row-sharded deployment launches.

Each candidate is built for its kernel's compile unit alone (one ``nvcc``
each, all started together).  Before it is timed its outputs are held
against the default geometry's on the same inputs: maps and carried state
bit for bit, the statistics within 1e-5 (the number of per-warp partials
changes with the tile).  A candidate that disagrees is an error, never a
candidate.  Timing: device-resident loops of launches (the kernel alone,
no host work between launches) under CUDA events, the minimum of 3 runs,
fitted over two loop lengths.  The fastest candidate is kept, unless it
is within 2% of the default, which then stays.  Every candidate's ms a
stream-frame is printed beside the card's name and power limit.

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
#: a candidate must beat the default by more than this share to be kept
MIN_GAIN = 0.02
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


def choose(seconds: dict, default):
    """The fastest geometry of ``seconds`` ({geometry: seconds}), unless
    it is within :data:`MIN_GAIN` of ``default``, which then stays."""
    best = min(seconds, key=seconds.get)
    if seconds[best] > seconds[default] * (1 - MIN_GAIN):
        return default
    return best


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
    """measure(tile) -> seconds a launch of the median ring (tail) kernel
    at s stacked sections of the padded height / ``rows_ax`` (the band
    form when ``rows_ax`` > 1), after its outputs over two batches were
    held against the default tile's; with the section height and Wp."""
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

    def measure(tile: MedianTile) -> float:
        _hold(f"{kernel} w{window} {tile.name()}", two_batches(tile), ref,
              stats_exact=False)
        st = fresh()
        run(tile, st, True)
        return _two_point_fit(lambda n: run(tile, st, False, reps=n),
                              (8, 24))

    return measure, hs, wp


def _raw_measure_factory(h: int, w: int, t: int, b: int, s: int = 1,
                         seed: int = 0):
    """measure(block) -> seconds a launch of the raw ring kernel (ABSDIFF)
    at s stacked streams, after its outputs over two batches were held
    against the default block's (everything bit for bit: the statistics
    are integer sums); with Hp and Wp."""
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

    def measure(block: RawBlock) -> float:
        _hold(f"raw {block.name()}", two_batches(block), ref,
              stats_exact=True)
        st = fresh()
        run(block, st, True)
        return _two_point_fit(lambda n: run(block, st, False, reps=n),
                              (8, 24))

    return measure, hp, wp


def probe_tiles(windows=(3, 5, 7), h: int = 1080, w: int = 1920,
                t: int = 4, b: int = 16, s: int = 1, tail: bool = False,
                rows_ax: int = 1, limit: Optional[int] = None,
                measure_factory=None, build=_build_all) -> dict:
    """The median ring (``tail``: tail) kernel's tile per window on this
    card: {window: {"tile", "ms" (a stream-frame), "default_ms", "times"
    ({tile name: ms})}}.  Windows are clamped as the properties clamp
    them (the key the pickers consult); ``rows_ax`` > 1 measures the band
    form at the owned height (windows > 1 only)."""
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
        measure, hs, wp = factory(win, h, w, t, b, s=s, tail=tail,
                                  rows_ax=rows_ax)
        cands = tile_candidates(hs, win, t, limit)
        unit = _build.median_unit(tail, win)
        build([(_build.Geometry(tile=c), (unit,)) for c in cands])
        seconds = {c: measure(c) for c in cands}
        best = choose(seconds, _build.DEFAULT.tile)
        ms = lambda c: seconds[c] * 1e3 / (s * b)  # noqa: E731
        results[win] = {"tile": best, "ms": ms(best),
                        "default_ms": ms(_build.DEFAULT.tile),
                        "times": {c.name(): ms(c) for c in cands}}
    return results


def probe_raw_block(h: int = 1080, w: int = 1920, t: int = 4, b: int = 16,
                    s: int = 1, measure_factory=None,
                    build=_build_all) -> dict:
    """The raw kernel's block on this card: {"block", "ms" (a
    stream-frame), "default_ms", "times" ({block name: ms})}."""
    factory = measure_factory or _raw_measure_factory
    measure, hp, wp = factory(h, w, t, b, s=s)
    cands = block_candidates(wp)
    build([(_build.Geometry(block=c), (_build.RAW_UNIT,)) for c in cands])
    seconds = {c: measure(c) for c in cands}
    best = choose(seconds, _build.DEFAULT.block)
    ms = lambda c: seconds[c] * 1e3 / (s * b)  # noqa: E731
    return {"block": best, "ms": ms(best),
            "default_ms": ms(_build.DEFAULT.block),
            "times": {c.name(): ms(c) for c in cands}}


def _report(label: str, res: dict, card: str, default_name: str,
            key: str) -> None:
    print(f"[autotune] {label} ({card}): ms a stream-frame")
    for name, ms in res["times"].items():
        mark = " (default)" if name == default_name else ""
        print(f"[autotune]   {name}{mark}: {ms:.5f}")
    print(f"[autotune]   chosen {res[key].name()}: {res['ms']:.5f} against "
          f"{res['default_ms']:.5f}", flush=True)


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
                         "overrides the stacked launches consume")
    ap.add_argument("--mesh", metavar="SxR", default=None,
                    help="ALSO probe the band-form median ring kernel at "
                         "the owned height an SxR (stream x rows) grid "
                         "launches (padded height / R) and persist "
                         "per-(card, window, owned-height) tiles the grid "
                         "engines consume (window 1 skipped: no stencil)")
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
    probes = [] if args.skip_ring else [
        ("ring_tiles", "ring", {}), ("tail_tiles", "tail", {"tail": True})]
    if args.stacked and not args.skip_ring:
        probes.append(("stacked_ring_tiles", f"stacked[{args.stacked}] ring",
                       {"s": max(2, args.stacked)}))
    if r_ax > 1 and not args.skip_ring:
        probes.append(("slab_ring_tiles", f"slab[{args.mesh}] ring",
                       {"rows_ax": r_ax}))
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
            s = max(2, args.stacked)
            res = probe_raw_block(*geo, s=s)
            _report(f"stacked[{s}] raw", res, card, block_name, "block")
            found["stacked_raw_block"] = res["block"]

    if args.dry_run:
        print("[autotune] dry run: store not written", flush=True)
        return 0
    path = tuning.save(
        kind, **found,
        meta={"geometry": f"{args.width}x{args.height}",
              "temporal": args.temporal, "batch": args.batch,
              "card": card,
              **({"stacked": int(args.stacked)} if args.stacked else {}),
              **({"mesh": args.mesh} if args.mesh else {}),
              "tool": "dips_tpu_torch.autotune"})
    print(f"saved: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
