"""Command line: the run command of the ``dips`` CLI on the port.

Counterpart of the file-in, file-out mode of ``dips_tpu/cli.py``: the same
option names and defaults for --input --output --encoding --filter
--sig_scalar --chroma --win_size --colorize --method --output-mode --batch,
bare integers as refresh markers, plus --device.

    python -m dips_tpu_torch --input in.avi --output out.avi [--device cuda]
"""

from __future__ import annotations

import argparse
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
    p.add_argument("--colorize", default="true",
                   help="true | false (false = grayscale diff)")
    p.add_argument("--method", default="overall",
                   choices=["overall", "per_frame"],
                   help="diff vs pinned snapshot or vs previous frame")
    p.add_argument("--output-mode", default=None,
                   choices=["colorize", "grayscale", "absdiff", "threshold",
                            "stats_only"],
                   help="overrides --colorize; stats_only writes no video")
    p.add_argument("--batch", type=int, default=8,
                   help="frames per kernel launch")
    p.add_argument("--device", default=None,
                   help="cuda | cpu (default: the card when present)")
    return p


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
        sigmoid_horizontal_scalar=args.sig_scalar,
        refresh_markers=tuple(args.markers))


def _parse_encoding(name: str) -> Optional[Encoding]:
    up = name.upper()
    if up in Encoding.__members__:
        return Encoding[up]
    try:
        return Encoding(name)
    except ValueError:
        return None


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    props = props_from_args(args)
    stats_only = props.out_channels == 0
    if not args.input or (not args.output and not stats_only):
        print("need --input and --output (--output-mode stats_only runs "
              "without --output)", file=sys.stderr)
        return 2
    if stats_only and args.output:
        print("--output-mode stats_only writes no diff video: drop --output",
              file=sys.stderr)
        return 2
    enc = _parse_encoding(args.encoding)
    if enc is None:
        print(f"unknown --encoding {args.encoding!r} "
              f"(RGBA | HFYU | H264 | MJPG | mp4v)", file=sys.stderr)
        return 2
    from .app import DiPsJob, perform_dips
    job = DiPsJob(properties=props, video_path=args.input,
                  output_path=args.output, encoding=enc, batch=args.batch,
                  device=args.device)
    try:
        stats = perform_dips(job)
    except (DiPsError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"processed {stats.shape[0]} frames -> "
          + (args.output if args.output else "stats only"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
