"""Command line: the ``dips`` CLI on the port.

Counterpart of ``dips_tpu/cli.py``, with the same option names, defaults,
messages and exit codes (2 for usage errors, 1 for a failed run), its
``--backend`` read as ``--device`` (default cuda: without a card the run
fails unless ``--device cpu`` is given):

* file in, file out: --input --output --encoding --filter --sig_scalar
  --chroma --win_size --approx-median --quirk-compat --roi --colorize
  --method --output-mode --no-maps --sensitivity --temporal --threshold
  --batch --packed-wire --downscale --input-layout --video-backend
  (opencv or gstreamer) --decode-workers --pipeline-depth --retime-vfr
  --profile --trace-dir, bare integers as refresh markers;
  the artifacts --stats-json, --events-json (with the --event-* options),
  --heatmap-png, --record-events DIR (--pre-roll, --post-roll),
  --auto-refresh; the post-analysis flags --denoise R, --dft-json PATH
  and --flicker-hz F with --flicker-png and --flicker-tau
  (``ops/analysis.py``, on the run's device);
* the fleet: --inputs FILE... --output-dir DIR with the same pipeline and
  engine options (--packed-wire is accepted and, as in the JAX CLI, not
  used: the fleet writes unpacked maps), and --stats-json, --events-json,
  --auto-refresh, --mesh SxR / --slab-impl (the fleet over a stream x
  rows grid of cells: ``parallel/grid2d.py``) and --flicker-hz (one fleet
  flicker analyzer, a peak line and, with --flicker-png, one PNG per
  stream); exit code 1 when a stream failed and was isolated;
* the utility modes --thumbnail OUT.png, --subsample N, --dat-dir DIR
  (--dat-geometry WxH; raw ``Dat_N.d`` dumps) and the live preview
  --live (a display needed; ``live.py``).

--mesh and --output-dir are refused outside the fleet mode (the JAX CLI
ignores them there).  --compile-cache [DIR] keeps the built CUDA kernels
under DIR (``utils/compilecache.py``) where the JAX CLI keeps XLA's
executables.

    python -m dips_tpu_torch --input in.avi --output out.avi [--device cuda]
    python -m dips_tpu_torch --inputs a.avi b.avi --output-dir out/
    python -m dips_tpu_torch --inputs a.avi b.avi --output-dir out/ --mesh 2x3
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .errors import DiPsError
from .properties import (ChromaFilter, DiPsFilter, DiPsMethod, DiPsProperties,
                         Encoding, OutputMode)

_FILTERS = {"sigmoid": DiPsFilter.SIGMOID,
            "inv_sig": DiPsFilter.INVERSE_SIGMOID,
            "none": DiPsFilter.UNFILTERED, "": DiPsFilter.UNFILTERED}
_CHROMA = {"r": ChromaFilter.RED, "g": ChromaFilter.GREEN,
           "b": ChromaFilter.BLUE, "": ChromaFilter.ALL,
           "all": ChromaFilter.ALL}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dips-torch",
        description="video frame-difference pixels (DiPs) on PyTorch/CUDA")
    p.add_argument("markers", nargs="*", type=int, metavar="N",
                   help="bare integers: refresh-marker frame indices "
                        "(re-capture the baseline)")
    p.add_argument("--input", help="input video file")
    p.add_argument("--output", help="output video file")
    p.add_argument("--inputs", nargs="+", metavar="FILE",
                   help="multiple input videos: batched multi-stream mode, "
                        "one stacked kernel launch per batch (requires "
                        "--output-dir)")
    p.add_argument("--output-dir", help="output directory for --inputs mode")
    p.add_argument("--encoding", default="MJPG",
                   help="RGBA | HFYU | H264 | MJPG | mp4v")
    p.add_argument("--filter", default="sigmoid",
                   help="sigmoid | inv_sig | none")
    p.add_argument("--sig_scalar", type=float, default=5.0,
                   help="sigmoid horizontal scalar, clamped 1..10")
    p.add_argument("--chroma", default="",
                   help="r | g | b | '' (luminance)")
    p.add_argument("--win_size", type=int, default=3,
                   help="spatial median window, odd, clamped 1..7")
    p.add_argument("--approx-median", action="store_true",
                   help="separable spatial median (fast approximation "
                        "with documented rank bounds; default is exact)")
    p.add_argument("--quirk-compat", action="store_true",
                   help="replicate the reference's WGSL spatial-filter "
                        "bugs bit-for-bit (off-center window, structural "
                        "zeros, (n/2)+1 pick, u8 re-quantization) instead "
                        "of the clean median — for matching legacy output")
    p.add_argument("--roi", metavar="Y0,X0,Y1,X1",
                   help="analysis region (pixel bounds, end exclusive): "
                        "per-frame statistics, the heatmap and motion "
                        "events consider only this rectangle; output maps "
                        "stay full-frame")
    p.add_argument("--colorize", default="true",
                   help="true | false (false = grayscale diff)")
    p.add_argument("--method", default="overall",
                   choices=["overall", "per_frame"],
                   help="diff vs pinned snapshot or vs previous frame")
    p.add_argument("--output-mode", default=None,
                   choices=["colorize", "grayscale", "absdiff", "threshold",
                            "stats_only"],
                   help="overrides --colorize; stats_only writes no video")
    p.add_argument("--no-maps", action="store_true",
                   help="suppress diff-map output for ANY pipeline "
                        "(emit_maps=False): the full configured pipeline "
                        "(spatial/temporal medians, emphasis, colorize/"
                        "grayscale stats semantics) still runs, but no map "
                        "bytes are computed or transferred — median-"
                        "filtered statistics/events/heatmap at stats-only "
                        "egress cost.  --output-mode stats_only is the "
                        "raw-absdiff shorthand (skips the medians too)")
    p.add_argument("--sensitivity", type=float, default=5.0)
    p.add_argument("--temporal", type=int, default=4,
                   help="temporal median ring length, 1..16")
    p.add_argument("--threshold", type=int, default=10,
                   help="uint8 change threshold for stats / threshold mode")
    p.add_argument("--batch", type=int, default=8,
                   help="frames per kernel launch")
    p.add_argument("--packed-wire", action="store_true",
                   help="THRESHOLD output only: bit-pack masks on the "
                        "device before download (8x less D2H transfer)")
    p.add_argument("--downscale", type=int, default=1, metavar="K",
                   help="on-device input decimation: analyze (and write) "
                        "at 1/K scale — K x K box mean inside the device "
                        "layout prep, so a 4K feed costs ~1080p device "
                        "work with no host resize.  K must divide the "
                        "input dimensions")
    p.add_argument("--input-layout", choices=("planar", "hwc"),
                   default="hwc",
                   help="'hwc' (default): upload raw decoded frames and run "
                        "the layout transform (+BGR swap) on the device; "
                        "'planar': the host planarizes each frame before "
                        "the upload")
    p.add_argument("--video-backend", default="auto",
                   choices=["auto", "opencv", "gstreamer"],
                   help="media decode/encode backend (the reference's "
                        "primary ingest is GStreamer)")
    p.add_argument("--retime-vfr", action="store_true",
                   help="dup/drop frames onto the CFR writer schedule so "
                        "variable-frame-rate inputs do not drift")
    p.add_argument("--decode-workers", type=int, default=1, metavar="N",
                   help="parallel chunked decode threads (order-preserving; "
                        "needs a seekable container)")
    p.add_argument("--pipeline-depth", type=int, default=1,
                   choices=[1, 2],
                   help="2 = keep one device batch in flight (overlap "
                        "transfers with compute; helps on PCIe hosts, "
                        "hurts on serialized links)")
    p.add_argument("--profile", action="store_true",
                   help="print per-stage timings after the run")
    p.add_argument("--trace-dir", metavar="DIR",
                   help="capture a torch.profiler trace of the run (CPU "
                        "and CUDA activity) into DIR as Chrome trace JSON")
    p.add_argument("--denoise", type=int, metavar="R",
                   help="FFT low-pass denoise radius applied to diff maps "
                        "(post-analysis, see ops/analysis.fft_denoise): "
                        "it runs on the engine's device maps before their "
                        "one download; ignored with --inputs")
    p.add_argument("--dft-json", metavar="PATH",
                   help="write the temporal DFT of the per-frame "
                        "mean-|diff| series to a JSON file")
    p.add_argument("--flicker-hz", type=float, metavar="F",
                   help="per-PIXEL temporal-frequency analysis: stream a "
                        "single-bin demodulator at F Hz over the input "
                        "(ops/analysis.FlickerAnalyzer) and print the "
                        "peak oscillation amplitude + location; F must be "
                        "below the input's Nyquist rate (fps/2). Costs "
                        "one extra host pass + device stream per frame")
    p.add_argument("--flicker-png", metavar="PATH",
                   help="save the --flicker-hz amplitude map as a PNG "
                        "(sequential rendering; --inputs mode writes one "
                        "per stream, PATH's stem + .<stream>)")
    p.add_argument("--flicker-tau", type=float, metavar="N",
                   help="averaging time constant in frames for "
                        "--flicker-hz (default: max(16, 4*fps/F))")
    p.add_argument("--device", default="cuda",
                   help="cuda | cuda:N | cpu (default: cuda; without a card "
                        "the run fails unless --device cpu is given)")
    p.add_argument("--mesh", metavar="SxR",
                   help="--inputs mode: run the fleet over a 2-D "
                        "(stream x rows) grid of S*R cells, each one "
                        "launch per batch on a horizontal slab of a "
                        "subset of the streams.  With --device cuda the "
                        "cells are the visible cards (S*R of them are "
                        "needed); with --device cuda:N or cpu every cell "
                        "runs on that one device")
    p.add_argument("--slab-impl", choices=("bands", "extended"),
                   default="bands",
                   help="--mesh: how a slab kernel gets its neighbours' "
                        "rows: 'bands' (default) = two thin 8-row band "
                        "inputs, slabs stay in owned coordinates; "
                        "'extended' = bands concatenated around each slab")
    p.add_argument("--stats-json", metavar="PATH",
                   help="write per-frame statistics to a JSON file; with "
                        "--inputs, one row list per stream keyed by "
                        "input path")
    p.add_argument("--events-json", metavar="PATH",
                   help="segment the per-frame stats into motion events "
                        "(hysteresis + debounce, ops/events.py) and write "
                        "them to a JSON file; with --inputs, one event "
                        "list per stream keyed by input path")
    p.add_argument("--event-on", default=0.01, metavar="X|auto",
                   type=lambda s: s if s == "auto" else float(s),
                   help="metric level that OPENS an event (default 0.01 "
                        "= 1%% of pixels changed with the default "
                        "metric); 'auto' estimates each stream's noise "
                        "floor online")
    p.add_argument("--event-off", type=float, default=None, metavar="X",
                   help="level that closes it (default: half of "
                        "--event-on; invalid with --event-on auto)")
    p.add_argument("--event-metric", default="changed_frac",
                   choices=("mean_abs_diff", "max_abs_diff",
                            "changed_count", "changed_frac"),
                   help="which per-frame statistic drives segmentation "
                        "(changed_frac = changed pixels / frame pixels)")
    p.add_argument("--event-min-frames", type=int, default=2, metavar="N",
                   help="discard events shorter than N frames (default 2)")
    p.add_argument("--heatmap-png", metavar="PATH",
                   help="save the run's accumulated |diff| heatmap as a "
                        "PNG (single-hue sequential rendering; embeddable "
                        "via dips-torch-report --heatmap)")
    p.add_argument("--record-events", metavar="DIR",
                   help="event-triggered recording: additionally write "
                        "one clip per motion burst into DIR (pre/post-"
                        "roll included, bursts during post-roll merge); "
                        "the --event-* flags configure its detector and "
                        "DIR/segments.json records the spans")
    p.add_argument("--pre-roll", type=int, default=30, metavar="N",
                   help="frames kept before each recorded event "
                        "(default 30)")
    p.add_argument("--post-roll", type=int, default=30, metavar="N",
                   help="frames kept after each recorded event "
                        "(default 30)")
    p.add_argument("--auto-refresh", metavar="FRAC[:PERSIST[:COOLDOWN]]",
                   help="adaptive baseline refresh (overall method): "
                        "re-capture the snapshot when at least FRAC of "
                        "the analysis pixels stay changed for PERSIST "
                        "consecutive frames (default 3), then hold off "
                        "COOLDOWN frames (default covers the snapshot "
                        "latency); fired frame indices are printed after "
                        "the run.  In --inputs mode each stream gets its "
                        "own policy; with --live it arms the preview's "
                        "'a' toggle")
    p.add_argument("--event-cooldown", type=int, default=0, metavar="N",
                   help="sub-threshold frames tolerated inside one event "
                        "before it closes (default 0)")
    p.add_argument("--live", action="store_true",
                   help="live preview window (requires a display). "
                        "Default source is the webcam; add --input "
                        "FILE-or-URI to preview that instead")
    # utility modes
    p.add_argument("--thumbnail", metavar="OUT.png",
                   help="extract a 240px-high thumbnail of --input and exit")
    p.add_argument("--subsample", type=int, metavar="N",
                   help="keep every Nth frame of --input into --output and "
                        "exit")
    p.add_argument("--dat-dir", metavar="DIR",
                   help="process a directory of raw Dat_N.d dumps instead "
                        "of a video file")
    p.add_argument("--dat-geometry", default="273x640",
                   help="WIDTHxHEIGHT of raw dumps (default 273x640)")
    from .utils.compilecache import add_compile_cache_flag
    add_compile_cache_flag(p)
    return p


def _parse_roi(spec: Optional[str]):
    if not spec:
        return None
    try:
        parts = tuple(int(v) for v in spec.split(","))
    except ValueError:
        parts = ()
    if len(parts) != 4:
        # ValueError: the props_from_args caller turns it into rc 2
        raise ValueError(f"--roi wants Y0,X0,Y1,X1 integers, got {spec!r}")
    return parts


def props_from_args(args: argparse.Namespace) -> DiPsProperties:
    if args.output_mode:
        output = OutputMode[args.output_mode.upper()]
    else:
        output = (OutputMode.COLORIZE if args.colorize.lower() != "false"
                  else OutputMode.GRAYSCALE)
    try:
        filt = _FILTERS[args.filter.lower()]
    except KeyError:
        raise SystemExit(f"unknown --filter {args.filter!r} "
                         f"(sigmoid | inv_sig | none)")
    try:
        chroma = _CHROMA[args.chroma.lower()]
    except KeyError:
        raise SystemExit(f"unknown --chroma {args.chroma!r} (r | g | b | '')")
    return DiPsProperties(
        method=DiPsMethod[args.method.upper()], output=output, filter=filt,
        chroma=chroma, window_size=args.win_size,
        temporal_size=args.temporal, sensitivity=args.sensitivity,
        sigmoid_horizontal_scalar=args.sig_scalar,
        refresh_markers=tuple(args.markers),
        change_threshold=args.threshold, approx_median=args.approx_median,
        quirk_compat=args.quirk_compat, roi=_parse_roi(args.roi),
        emit_maps=not args.no_maps)


def _parse_encoding(name: str) -> Optional[Encoding]:
    up = name.upper()
    if up in Encoding.__members__:
        return Encoding[up]
    try:
        return Encoding(name)
    except ValueError:
        print(f"unknown --encoding {name!r} "
              f"(RGBA | HFYU | H264 | MJPG | mp4v)", file=sys.stderr)
        return None


def _save_map_png(amp, path: str) -> None:
    """One amplitude map as a PNG (sequential colour map, one hue)."""
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 6 * amp.shape[0] / amp.shape[1]))
    im = ax.imshow(amp, cmap="Blues")
    ax.set_axis_off()
    fig.colorbar(im, ax=ax, shrink=0.8)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def _png_ready() -> bool:
    """matplotlib is importable; else its message on stderr."""
    from .report import _require_matplotlib
    try:
        _require_matplotlib()
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return False
    return True


def _detector_cfg(args) -> dict:
    """The --event-* flags as MotionDetector kwargs."""
    return dict(on_threshold=args.event_on, off_threshold=args.event_off,
                metric=args.event_metric,
                min_frames=args.event_min_frames,
                cooldown=args.event_cooldown)


def _run_inputs(args, props: DiPsProperties, auto_refresh) -> int:
    """The --inputs mode: one fleet run, then the JSON artifacts."""
    stats_only = props.out_channels == 0
    if not args.output_dir and not stats_only:
        print("--inputs requires --output-dir (or --output-mode "
              "stats_only for a no-video fleet run)", file=sys.stderr)
        return 2
    enc = _parse_encoding(args.encoding)
    if enc is None:
        return 2
    from .app import run_dips_on_files
    mesh = None
    if args.mesh:
        from .models.pipeline import resolve_device
        from .parallel import grid_mesh
        try:
            s_ax, r_ax = (int(v) for v in args.mesh.lower().split("x"))
        except ValueError:
            print(f"bad --mesh {args.mesh!r} (want SxR, e.g. 2x4)",
                  file=sys.stderr)
            return 2
        try:
            # "cuda": the visible cards; a named device: every cell on it
            dev = resolve_device(args.device)
            one = args.device != "cuda"
            mesh = grid_mesh(s_ax, r_ax,
                             devices=[dev] * (s_ax * r_ax) if one else None)
        except (DiPsError, ValueError) as e:  # e.g. too few cards
            print(f"error: {e}", file=sys.stderr)
            return 1
    ev_cfg = _detector_cfg(args) if args.events_json else None
    want_stats = bool(args.stats_json)
    flicker_cfg = (dict(freq_hz=args.flicker_hz, tau_frames=args.flicker_tau)
                   if args.flicker_hz is not None else None)
    try:
        result = run_dips_on_files(args.inputs, args.output_dir or ".", enc,
                                   props, batch=args.batch,
                                   device=args.device,
                                   input_layout=args.input_layout,
                                   video_backend=args.video_backend,
                                   events=ev_cfg,
                                   collect_stats=want_stats,
                                   downscale=args.downscale,
                                   auto_refresh=auto_refresh,
                                   flicker=flicker_cfg,
                                   slab_impl=args.slab_impl, mesh=mesh)
    except (DiPsError, NotImplementedError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    # counts, [events,] [stats,] [refreshes,] [flicker maps]
    res = list(result) if isinstance(result, tuple) else [result]
    counts = res.pop(0)
    per_stream = res.pop(0) if ev_cfg is not None else None
    per_stats = res.pop(0) if want_stats else None
    per_refresh = res.pop(0) if auto_refresh is not None else None
    per_flicker = res.pop(0) if flicker_cfg is not None else None
    # duplicate input paths must not collapse to one JSON key
    dup = {p for p in args.inputs if args.inputs.count(p) > 1}
    keys = [f"{p}#{si}" if p in dup else p
            for si, p in enumerate(args.inputs)]
    if per_stream is not None:
        with open(args.events_json, "w") as f:
            json.dump({k: [e.to_dict() for e in evs]
                       for k, evs in zip(keys, per_stream)}, f)
        n_ev = sum(len(evs) for evs in per_stream)
        print(f"{n_ev} motion event(s) across {len(per_stream)} "
              f"streams written: {args.events_json}")
    if per_stats is not None:
        from .ops.reference import STAT_NAMES
        with open(args.stats_json, "w") as f:
            json.dump({k: [dict(zip(STAT_NAMES, map(float, row)))
                           for row in rows]
                       for k, rows in zip(keys, per_stats)}, f)
        print(f"per-stream stats written: {args.stats_json}")
    if per_refresh is not None:
        hot = {k: idxs for k, idxs in zip(keys, per_refresh) if idxs}
        if hot:
            for k, idxs in hot.items():
                print(f"auto-refresh fired on {k} at frame(s): "
                      + ", ".join(map(str, idxs)))
        else:
            print("auto-refresh: no scene change detected")
    if per_flicker is not None:
        import numpy as np
        for k, amp in zip(keys, per_flicker):
            py, px = np.unravel_index(int(np.argmax(amp)), amp.shape)
            print(f"flicker @ {args.flicker_hz:g} Hz [{k}]: peak "
                  f"amplitude {float(amp[py, px]):.1f} at x={px} "
                  f"y={py}, mean {float(amp.mean()):.2f}")
        if args.flicker_png:
            if not _png_ready():
                return 1
            import os
            root, ext = os.path.splitext(args.flicker_png)
            for si, amp in enumerate(per_flicker):
                path = f"{root}.{si}{ext or '.png'}"
                _save_map_png(amp, path)
                print(f"flicker map written: {path}")
    failed = [i for i, c in enumerate(counts) if c < 0]
    ok_total = int(sum(c for c in counts if c >= 0))
    print(f"processed {len(counts)} streams ({ok_total} frames) -> "
          + (args.output_dir if not stats_only else "stats only"))
    if failed:
        print(f"WARNING: {len(failed)} stream(s) failed and were "
              f"isolated (outputs truncated): "
              f"{', '.join(args.inputs[i] for i in failed)}",
              file=sys.stderr)
        return 1
    return 0


def _refused(args, stats_only: bool) -> Optional[str]:
    """The message of the first flag combination the JAX CLI refuses with
    exit code 2 before any mode runs, or None."""
    if args.event_on == "auto" and args.event_off is not None:
        return ("--event-off is computed in auto mode (estimated floor + "
                "margin/2) — drop it or use a fixed --event-on")
    if stats_only:
        why = ("--output-mode stats_only" if args.output_mode == "stats_only"
               else "--no-maps")
        if args.output or args.output_dir:
            return (f"{why} writes no diff video — drop "
                    "--output/--output-dir (stats/events/heatmap artifacts "
                    "are the products)")
        for flag, val in (("--record-events", args.record_events),
                          ("--denoise", args.denoise),
                          ("--packed-wire", args.packed_wire),
                          ("--live", args.live),
                          ("--dat-dir", args.dat_dir),
                          ("--thumbnail", args.thumbnail),
                          ("--subsample", args.subsample is not None),
                          ("--retime-vfr", args.retime_vfr)):
            if val:
                return f"{flag} needs diff maps; {why} suppresses them"
    if (args.flicker_png or args.flicker_tau is not None) \
            and args.flicker_hz is None:
        return "--flicker-png/--flicker-tau need --flicker-hz"
    if args.downscale < 1:
        return f"--downscale must be >= 1, got {args.downscale}"
    utility = (args.dat_dir or args.live or args.thumbnail
               or args.subsample is not None)
    if args.downscale > 1 and utility:
        # decimation is an engine feature of the run modes
        return "--downscale needs the --input/--output or --inputs modes"
    return None


def _refused_artifacts(args) -> Optional[str]:
    """The JAX CLI's refusals of flags a mode would silently not honour
    (checked after --auto-refresh parses), or None."""
    if args.auto_refresh and (args.dat_dir or args.thumbnail
                              or args.subsample is not None):
        return ("--auto-refresh needs the --input/--output, --inputs or "
                "--live modes")
    for flag, val in (("--heatmap-png", args.heatmap_png),
                      ("--record-events", args.record_events),
                      ("--flicker-hz", args.flicker_hz is not None)):
        inputs_ok = flag == "--flicker-hz" and args.inputs
        if val and not inputs_ok and (
                args.inputs or args.dat_dir or args.live
                or args.thumbnail or args.subsample is not None):
            return f"{flag} needs the --input/--output or --inputs modes"
    for flag, val in (("--stats-json", args.stats_json),
                      ("--events-json", args.events_json),
                      ("--dft-json", args.dft_json)):
        live_only = args.live and not args.dat_dir
        if val and (live_only or args.thumbnail
                    or args.subsample is not None
                    or (args.inputs and flag == "--dft-json")):
            return (f"{flag} is not written in this mode — use the "
                    f"--input/--output (or --dat-dir) run modes")
    return None


def _run_live(args, props: DiPsProperties, auto_refresh) -> int:
    """--live: preview the webcam, or --input (a file or stream URI)."""
    from .live import run_live
    reader = None
    if args.input:
        from .io.gstreamer import open_video
        try:
            reader = open_video(args.input, args.video_backend)
        except (DiPsError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    try:
        return run_live(props, device=args.device, reader=reader,
                        auto_refresh=auto_refresh)
    except DiPsError as e:  # e.g. no card
        print(f"error: {e}", file=sys.stderr)
        return 1


def _run_file(args, props: DiPsProperties, auto_refresh):
    """The --input run: (exit code, None) on failure, else (None, (stats,
    job, flicker analyzer or None))."""
    enc = _parse_encoding(args.encoding)
    if enc is None:
        return 2, None
    from .app import DiPsJob, perform_dips
    from .utils.profiling import trace
    record = None
    if args.record_events:
        record = dict(dir=args.record_events, pre_roll=args.pre_roll,
                      post_roll=args.post_roll, detector=_detector_cfg(args))
    flicker = flicker_cb = probed_reader = None
    if args.flicker_hz is not None:
        # the analyzer needs the input's frame rate up front (Nyquist
        # validation + demodulation angle); the probed reader is handed to
        # the job, which decodes from it instead of opening the file again
        from .io.gstreamer import open_video
        from .ops.analysis import FlickerAnalyzer
        try:
            probed_reader = open_video(args.input, args.video_backend)
            flicker = FlickerAnalyzer(args.flicker_hz, probed_reader.fps,
                                      tau_frames=args.flicker_tau,
                                      chroma=props.chroma, batch=args.batch,
                                      device=args.device)
        except (DiPsError, ValueError) as e:
            if probed_reader is not None:
                probed_reader.close()
            print(f"error: {e}", file=sys.stderr)
            return 1, None

        def flicker_cb(idx, inp, out, stat, _fl=flicker):
            _fl.update(inp)
            return None  # observe-only: the diff map passes through
    job = DiPsJob(properties=props, video_path=args.input,
                  output_path=args.output, encoding=enc, batch=args.batch,
                  device=args.device, video_backend=args.video_backend,
                  retime_vfr=args.retime_vfr,
                  decode_workers=args.decode_workers,
                  pipeline_depth=args.pipeline_depth,
                  packed_wire=args.packed_wire,
                  input_layout=args.input_layout, downscale=args.downscale,
                  profile=args.profile, denoise_radius=args.denoise,
                  reader=probed_reader, frame_callback=flicker_cb,
                  record_events=record, auto_refresh=auto_refresh)
    try:
        with trace(args.trace_dir):
            stats = perform_dips(job)
    except (DiPsError, ValueError) as e:
        if probed_reader is not None:
            probed_reader.close()
        print(f"error: {e}", file=sys.stderr)
        return 1, None
    if args.profile and job.timers:
        print(job.timers)
        down = job.engine.downloads
        if down.reuse_share is not None:  # on a card
            print(f"downloads: {down.batches} batches, {down.nbytes} bytes "
                  f"into page-locked memory, {down.new_blocks} page-locked "
                  f"a new block (reuse share {down.reuse_share:.3f})")
        staged = job.engine.staging
        if staged.batches:
            gbps = staged.gbps(job.timers)
            print(staged if gbps is None else f"{staged}, {gbps:.2f} GB/s")
        if job.engine.denoise_radius is not None:
            print(job.engine.denoise_counts)
        if job.engine.downscale > 1:
            print(job.engine.pool_counts)
    if auto_refresh is not None and job.baseline_refreshes is not None:
        if job.baseline_refreshes:
            print("auto-refresh fired at frame(s): "
                  + ", ".join(map(str, job.baseline_refreshes)))
        else:
            print("auto-refresh: no scene change detected")
    if args.record_events and job.event_segments is not None:
        import os
        with open(os.path.join(args.record_events, "segments.json"),
                  "w") as f:
            json.dump(job.event_segments, f)
        print(f"{len(job.event_segments)} event segment(s) "
              f"recorded -> {args.record_events}")
    return None, (stats, job, flicker)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from .utils.compilecache import apply_compile_cache_flag
    apply_compile_cache_flag(args)
    stats_only = args.output_mode == "stats_only" or args.no_maps
    msg = _refused(args, stats_only)
    if msg:
        print(msg, file=sys.stderr)
        return 2
    auto_refresh = None
    if args.auto_refresh:
        from .ops.refresh import parse_auto_refresh_arg
        try:
            auto_refresh = parse_auto_refresh_arg(args.auto_refresh)
        except ValueError:
            print(f"bad --auto-refresh {args.auto_refresh!r} "
                  "(want FRAC[:PERSIST[:COOLDOWN]], e.g. 0.6:3:64)",
                  file=sys.stderr)
            return 2
    msg = _refused_artifacts(args)
    if msg:
        print(msg, file=sys.stderr)
        return 2

    if args.thumbnail:
        if not args.input:
            print("--thumbnail requires --input", file=sys.stderr)
            return 2
        from .io.thumbnail import extract_thumbnail
        extract_thumbnail(args.input, args.thumbnail)
        print(f"thumbnail written: {args.thumbnail}")
        return 0
    if args.subsample is not None:
        if args.subsample < 1:
            print(f"--subsample must be >= 1, got {args.subsample}",
                  file=sys.stderr)
            return 2
        if not (args.input and args.output):
            print("--subsample requires --input and --output",
                  file=sys.stderr)
            return 2
        from .io.subsample import subsample_video
        n = subsample_video(args.input, args.output, args.subsample)
        print(f"wrote {n} frames to {args.output}")
        return 0

    try:
        props = props_from_args(args)
    except ValueError as e:  # e.g. --approx-median with --quirk-compat
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.inputs:
        return _run_inputs(args, props, auto_refresh)
    for flag, val in (("--mesh", args.mesh),
                      ("--output-dir", args.output_dir)):
        if val:  # the JAX CLI ignores these outside the fleet mode
            print(f"{flag} needs the --inputs mode in this port",
                  file=sys.stderr)
            return 2

    job = flicker = None  # the --input mode's; dat mode has no job
    if args.dat_dir:
        if not args.output:
            print("--dat-dir requires --output", file=sys.stderr)
            return 2
        from .app import custom_dips_on_files
        try:
            w, h = (int(v) for v in args.dat_geometry.lower().split("x"))
        except ValueError:
            print(f"bad --dat-geometry {args.dat_geometry!r} "
                  f"(want WIDTHxHEIGHT, e.g. 273x640)", file=sys.stderr)
            return 2
        enc = _parse_encoding(args.encoding)
        if enc is None:
            return 2
        try:
            stats = custom_dips_on_files(
                args.dat_dir, args.output, width=w, height=h,
                properties=props, encoding=enc, batch=args.batch,
                device=args.device,
                show=args.live)  # --live + --dat-dir previews the batch
        except (DiPsError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        frame_geometry = (h, w)
    elif args.live:
        return _run_live(args, props, auto_refresh)
    else:
        if not args.input or (not args.output and not stats_only):
            print("need --input and --output (see --help; --output-mode "
                  "stats_only runs without --output)", file=sys.stderr)
            return 2
        rc, run = _run_file(args, props, auto_refresh)
        if rc is not None:
            return rc
        stats, job, flicker = run
        frame_geometry = job.frame_geometry

    print(f"processed {stats.shape[0]} frames -> "
          + (args.output if args.output else "stats only"))
    if args.stats_json:
        from .ops.reference import STAT_NAMES
        rows = [dict(zip(STAT_NAMES, map(float, row))) for row in stats]
        with open(args.stats_json, "w") as f:
            json.dump(rows, f)
        print(f"stats written: {args.stats_json}")
    if args.heatmap_png:
        if job is None or job.engine is None:
            print("--heatmap-png needs the --input/--output mode",
                  file=sys.stderr)
            return 2
        if not _png_ready():
            return 1
        _save_map_png(job.engine.heatmap(), args.heatmap_png)
        print(f"heatmap written: {args.heatmap_png}")
    if flicker is not None:
        import numpy as np
        flicker.flush()
        if flicker.frames_seen == 0:
            print("flicker: no frames streamed", file=sys.stderr)
        else:
            amp = flicker.amplitude()
            py, px = np.unravel_index(int(np.argmax(amp)), amp.shape)
            print(f"flicker @ {args.flicker_hz:g} Hz over "
                  f"{flicker.frames_seen} frames: peak amplitude "
                  f"{float(amp[py, px]):.1f} (intensity units, 0-510) at "
                  f"x={px} y={py}, mean {float(amp.mean()):.2f}")
            if args.flicker_png:
                if not _png_ready():
                    return 1
                _save_map_png(amp, args.flicker_png)
                print(f"flicker map written: {args.flicker_png}")
    if args.events_json:
        from .ops.events import detect_events
        events = detect_events(
            [stats], **_detector_cfg(args),
            pixels=(props.analysis_pixels(*frame_geometry)
                    if args.event_metric == "changed_frac" and
                    frame_geometry else None))
        with open(args.events_json, "w") as f:
            json.dump([e.to_dict() for e in events], f)
        print(f"{len(events)} motion event(s) written: {args.events_json}")
    if args.dft_json:
        from .ops.analysis import temporal_dft
        mag, phase = temporal_dft(stats[:, 1], device=args.device)
        with open(args.dft_json, "w") as f:
            json.dump({"magnitude": mag.cpu().tolist(),
                       "phase": phase.cpu().tolist()}, f)
        print(f"temporal DFT written: {args.dft_json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
