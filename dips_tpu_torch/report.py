"""Run report: one self-contained HTML page from a run's artifacts.

``dips-torch-report`` consumes what the CLI already writes — ``--stats-json``
(per-frame statistics) and optionally ``--events-json`` (motion events,
single-stream list or the --inputs per-path dict) and a heatmap PNG —
and renders a shareable post-run report: headline numbers, per-frame
metric timelines with motion spans shaded, the event table, and the
accumulated |diff| heatmap.  Everything is embedded (base64 PNGs), so
the single file travels.

    python -m dips_tpu_torch.cli --input cam.avi --output out.avi \
        --stats-json s.json --events-json e.json
    dips-torch-report --stats-json s.json --events-json e.json -o report.html

Chart conventions (kept deliberately boring and readable): one unit per
axis — the changed-pixel fraction gets its own panel, the two
normalized-intensity series share one; motion spans are neutral-gray
annotation bands, not a series color; every chart's data is also in the
page as a table.  Colors are the first categorical slots of a
CVD-validated reference palette.
"""

from __future__ import annotations

import argparse
import base64
import html
import io
import json
import os
import sys
from typing import List, Optional

import numpy as np

# CVD-validated reference palette (dataviz reference instance, light
# surface #fcfcfb): categorical slots in fixed order.
_BLUE, _ORANGE, _AQUA = "#2a78d6", "#eb6834", "#1baf7a"
_SURFACE, _INK, _INK2 = "#fcfcfb", "#0b0b0b", "#52514e"
_BAND = (0.32, 0.32, 0.31, 0.12)  # neutral annotation band (gray @ 12%)


def _require_matplotlib():
    try:
        import matplotlib
    except ImportError:
        raise RuntimeError(
            "chart rendering needs matplotlib — install the extra: "
            "pip install 'dips-tpu[report]'") from None
    matplotlib.use("Agg")
    return matplotlib


def _load_stats(path: str) -> np.ndarray:
    """stats JSON (list of per-frame dicts, the --stats-json format) ->
    (N, 4) array in STAT_NAMES order."""
    from .ops.reference import STAT_NAMES
    with open(path) as f:
        rows = json.load(f)
    if not rows:  # a zero-frame run is a legitimate artifact
        return np.zeros((0, len(STAT_NAMES)), np.float64)
    return np.asarray([[float(r[k]) for k in STAT_NAMES] for r in rows],
                      np.float64)


def _load_events(path: Optional[str]) -> dict:
    """events JSON -> {stream_name: [event dicts]} (a bare list becomes
    one unnamed stream)."""
    if path is None:
        return {}
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, list):
        return {"": data}
    return {str(k): list(v) for k, v in data.items()}


def _fig_to_b64(fig) -> str:
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=110, bbox_inches="tight",
                facecolor=_SURFACE)
    import matplotlib.pyplot as plt
    plt.close(fig)
    return base64.b64encode(buf.getvalue()).decode()


def _style_axes(ax):
    ax.set_facecolor(_SURFACE)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(_INK2)
    ax.tick_params(colors=_INK2, labelsize=8)
    ax.grid(True, axis="y", color=_INK2, alpha=0.15, linewidth=0.6)
    ax.set_axisbelow(True)


def _shade_events(ax, events: List[dict]) -> None:
    for i, e in enumerate(events):
        ax.axvspan(e["start_frame"], e["end_frame"], color=_BAND[:3],
                   alpha=_BAND[3], linewidth=0)
        if i == 0:  # one direct label names the bands; the rest repeat
            ax.text(e["start_frame"], ax.get_ylim()[1], " motion",
                    color=_INK2, fontsize=7, va="top", ha="left")


def _charts(stats: np.ndarray, events: List[dict], pixels: Optional[int]
            ) -> List[str]:
    """Two stacked panels (one unit each) -> base64 PNGs."""
    _require_matplotlib()
    import matplotlib.pyplot as plt

    n = stats.shape[0]
    x = np.arange(n)
    imgs = []

    # Panel 1: changed pixels over time (a fraction when the geometry is
    # known, else the raw count — its own axis either way)
    fig, ax = plt.subplots(figsize=(8.4, 2.4))
    fig.patch.set_facecolor(_SURFACE)
    y = stats[:, 3] / pixels if pixels else stats[:, 3]
    ax.plot(x, y, color=_BLUE, linewidth=2, solid_capstyle="round")
    ax.set_title("Changed pixels per frame"
                 + (" (fraction)" if pixels else " (count)"),
                 color=_INK, fontsize=10, loc="left")
    ax.set_xlabel("frame", color=_INK2, fontsize=8)
    ax.margins(x=0)
    _style_axes(ax)
    _shade_events(ax, events)
    imgs.append(_fig_to_b64(fig))

    # Panel 2: normalized-intensity series (same unit -> one axis)
    fig, ax = plt.subplots(figsize=(8.4, 2.4))
    fig.patch.set_facecolor(_SURFACE)
    ax.plot(x, stats[:, 1], color=_ORANGE, linewidth=2, label="mean |diff|",
            solid_capstyle="round")
    ax.plot(x, stats[:, 2], color=_AQUA, linewidth=2, label="max |diff|",
            solid_capstyle="round")
    spanv = float(stats[:, 1:3].max() - stats[:, 1:3].min()) or 1.0
    if n and abs(float(stats[-1, 2] - stats[-1, 1])) > 0.08 * spanv:
        # direct labels only when the endpoints are visually separate;
        # otherwise they collide and the legend alone carries identity
        ax.text(x[-1], stats[-1, 1], " mean", color=_ORANGE, fontsize=8,
                va="center")
        ax.text(x[-1], stats[-1, 2], " max", color=_AQUA, fontsize=8,
                va="center")
    ax.legend(loc="upper right", fontsize=8, frameon=False,
              labelcolor=_INK2)
    ax.set_title("Frame difference intensity (normalized)", color=_INK,
                 fontsize=10, loc="left")
    ax.set_xlabel("frame", color=_INK2, fontsize=8)
    ax.margins(x=0)
    _style_axes(ax)
    _shade_events(ax, events)
    imgs.append(_fig_to_b64(fig))
    return imgs


def _tile(label: str, value: str) -> str:
    return (f'<div class="tile"><div class="v">{html.escape(value)}</div>'
            f'<div class="l">{html.escape(label)}</div></div>')


def _events_table(events: List[dict]) -> str:
    if not events:
        return "<p class='muted'>No motion events.</p>"
    # int()/float() double as validation and injection-proofing (same
    # contract as _segments_table): a corrupt events JSON fails cleanly
    # instead of smuggling markup into the page
    rows = "".join(
        f"<tr><td>{int(e['start_frame'])}</td><td>{int(e['end_frame'])}</td>"
        f"<td>{int(e['frames'])}</td><td>{float(e['peak']):.4g}</td>"
        f"<td>{int(e['peak_frame'])}</td><td>{float(e['mean']):.4g}</td></tr>"
        for e in events)
    return ("<table><thead><tr><th>start</th><th>end</th><th>frames</th>"
            "<th>peak</th><th>peak frame</th><th>mean</th></tr></thead>"
            f"<tbody>{rows}</tbody></table>")


def _stats_table(stats: np.ndarray) -> str:
    """Accessibility/table view of the charted data (collapsed)."""
    from .ops.reference import STAT_NAMES
    head = "".join(f"<th>{html.escape(k)}</th>" for k in STAT_NAMES)
    body = "".join(
        "<tr><td>{}</td>{}</tr>".format(
            i, "".join(f"<td>{v:.5g}</td>" for v in row))
        for i, row in enumerate(stats))
    return ("<details><summary>Per-frame data table</summary>"
            f"<table><thead><tr><th>frame</th>{head}</tr></thead>"
            f"<tbody>{body}</tbody></table></details>")


def _segments_table(segments) -> str:
    if not isinstance(segments, list) or not all(
            isinstance(s, dict) for s in segments):
        raise ValueError(
            "segments JSON must be a LIST of segment objects — the "
            "--record-events DIR/segments.json manifest")
    if not segments:
        return "<p class='muted'>No recorded segments.</p>"
    # int() doubles as validation and as injection-proofing: a corrupt
    # manifest fails cleanly instead of smuggling markup into the page
    rows = "".join(
        "<tr><td style='text-align:left'>{}</td><td>{}</td><td>{}</td>"
        "<td>{}</td><td>{}</td></tr>".format(
            html.escape(os.path.basename(str(s.get("path") or "?"))),
            int(s["start_frame"]), int(s["end_frame"]), int(s["frames"]),
            len(s.get("events", [])))
        for s in segments)
    return ("<table><thead><tr><th>clip</th><th>start</th><th>end</th>"
            "<th>frames</th><th>events</th></tr></thead>"
            f"<tbody>{rows}</tbody></table>")


def render_report(stats_path: str, events_path: Optional[str] = None,
                  heatmap_path: Optional[str] = None,
                  title: str = "DiPs run report",
                  pixels: Optional[int] = None,
                  segments_path: Optional[str] = None,
                  flicker_path: Optional[str] = None) -> str:
    """Build the report; returns the HTML string."""
    stats = _load_stats(stats_path)
    streams = _load_events(events_path)
    multi = len(streams) > 1
    # single-stream stats pair with the single (or sole) event list; a
    # multi-stream events dict cannot be attributed to THIS stats series,
    # so the charts shade nothing and the tiles aggregate all streams
    events = next(iter(streams.values())) if len(streams) == 1 else []
    n = stats.shape[0]
    motion = sum(e["frames"] for v in streams.values() for e in v)
    n_events = sum(len(v) for v in streams.values())

    tiles = [_tile("frames", str(n)),
             _tile("motion events", str(n_events)),
             _tile("motion frames" + (" (all streams)" if multi else ""),
                   f"{motion}"
                   + (f" ({100 * motion / n:.1f}%)"
                      if n and not multi else ""))]
    if n:
        tiles.append(_tile("peak mean |diff|", f"{stats[:, 1].max():.4g}"))

    imgs = _charts(stats, events, pixels) if n else []
    sections = [
        f'<div class="tiles">{"".join(tiles)}</div>',
        *(f'<img alt="chart" src="data:image/png;base64,{b}">'
          for b in imgs),
    ]
    if not n:
        sections.append("<p class='muted'>No frames processed — nothing "
                        "to chart.</p>")
    elif multi:
        sections.append("<p class='muted'>Events span multiple streams; "
                        "spans are not shaded on this (single-stream) "
                        "stats timeline.</p>")
    if len(streams) > 1:  # multi-input run: one event table per stream
        for name, evs in streams.items():
            sections.append(f"<h2>{html.escape(name or 'events')}</h2>"
                            + _events_table(evs))
    else:
        sections.append("<h2>Motion events</h2>" + _events_table(events))
    if segments_path:
        with open(segments_path) as f:
            segments = json.load(f)
        sections.append("<h2>Recorded segments</h2>"
                        + _segments_table(segments))
        total = sum(int(s["frames"]) for s in segments)
        if n:
            sections.append(
                f"<p class='muted'>{total} of {n} frames stored "
                f"({100 * total / n:.1f}%).</p>")
    if heatmap_path:
        with open(heatmap_path, "rb") as f:
            hm = base64.b64encode(f.read()).decode()
        sections.append(
            "<h2>Accumulated |diff| heatmap</h2>"
            f'<img alt="heatmap" src="data:image/png;base64,{hm}">')
    if flicker_path:
        with open(flicker_path, "rb") as f:
            fl = base64.b64encode(f.read()).decode()
        sections.append(
            "<h2>Flicker amplitude map</h2>"
            f'<img alt="flicker map" src="data:image/png;base64,{fl}">')
    sections.append(_stats_table(stats))

    return f"""<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<title>{html.escape(title)}</title>
<style>
 body {{ background:{_SURFACE}; color:{_INK};
        font:14px/1.5 system-ui, sans-serif; max-width: 880px;
        margin: 2rem auto; padding: 0 1rem; }}
 h1 {{ font-size: 1.3rem; }} h2 {{ font-size: 1rem; margin-top: 1.5rem; }}
 .muted {{ color:{_INK2}; }}
 .tiles {{ display:flex; gap:12px; flex-wrap:wrap; margin: 1rem 0; }}
 .tile {{ border:1px solid #e4e3df; border-radius:8px;
          padding:10px 16px; min-width:120px; }}
 .tile .v {{ font-size:1.4rem; font-weight:600; }}
 .tile .l {{ color:{_INK2}; font-size:.8rem; }}
 img {{ max-width:100%; margin:.5rem 0; }}
 table {{ border-collapse:collapse; font-size:.85rem; }}
 th, td {{ border-bottom:1px solid #e4e3df; padding:4px 10px;
           text-align:right; }}
 th {{ color:{_INK2}; font-weight:500; }}
 details summary {{ color:{_INK2}; cursor:pointer; margin-top:1rem; }}
</style></head><body>
<h1>{html.escape(title)}</h1>
{"".join(sections)}
</body></html>
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dips-torch-report",
        description="Render a self-contained HTML report from a run's "
                    "--stats-json / --events-json artifacts")
    ap.add_argument("--stats-json", required=True,
                    help="per-frame statistics from the CLI run")
    ap.add_argument("--events-json", default=None,
                    help="motion events (single list or --inputs dict)")
    ap.add_argument("--heatmap", default=None, metavar="PNG",
                    help="heatmap image to embed (e.g. saved via the "
                         "serve 'heatmap' command or engine.heatmap())")
    ap.add_argument("--flicker", default=None, metavar="PNG",
                    help="flicker amplitude map to embed (the CLI's "
                         "--flicker-png artifact)")
    ap.add_argument("--segments-json", default=None,
                    help="recorded-segment manifest from --record-events "
                         "(DIR/segments.json): adds a clip table + "
                         "storage share")
    ap.add_argument("--pixels", type=int, default=None,
                    help="frame pixel count (H*W): charts the changed-"
                         "pixel series as a fraction instead of a count")
    ap.add_argument("--title", default="DiPs run report")
    ap.add_argument("-o", "--output", default="report.html")
    args = ap.parse_args(argv)
    try:
        doc = render_report(args.stats_json, args.events_json,
                            args.heatmap, args.title, args.pixels,
                            segments_path=args.segments_json,
                            flicker_path=args.flicker)
    except (OSError, KeyError, TypeError, ValueError, RuntimeError,
            json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    with open(args.output, "w") as f:
        f.write(doc)
    print(f"report written: {args.output} "
          f"({os.path.getsize(args.output) // 1024} KB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
