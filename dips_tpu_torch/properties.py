"""Configuration surface for dips_tpu.

Mirrors the reference's three config mechanisms (SURVEY.md §5 "Config / flag
system") with one TPU-native one:

* the builder struct ``DiPsProperties`` (ref: ``dips/src/lib.rs:63-170`` and
  ``dips_alt/src/dips_compute/mod.rs:151-234``) including its validation
  clamps (sigmoid scalar clamped to 1..=10 at mod.rs:220, window clamped to
  odd 1..=7 at mod.rs:225-228);
* enums ``DiPsFilter`` (dips/src/lib.rs:26-30), ``ChromaFilter``
  (dips/src/lib.rs:43-49) and ``Encoding`` (dips_alt/src/lib.rs:38-55);
* shader-specialisation semantics: in the reference, properties become WGSL
  ``override`` constants and changing one rebuilds the pipeline
  (dips/src/gpu/mod.rs:101-109).  Here the frozen :class:`DiPsProperties` is
  hashable and is passed as a *static* argument to ``jax.jit``, so changing a
  property triggers exactly one recompile and is cached afterwards — the same
  specialise/cache/rebuild contract, expressed the XLA way.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence, Tuple


class DiPsFilter(enum.Enum):
    """Nonlinear emphasis applied to the mapped diff (ref: dips/src/lib.rs:26-30;
    FILTER_TYPE switch in dips/src/gpu/shaders/dips_shader.wgsl:219-227)."""

    SIGMOID = 0
    INVERSE_SIGMOID = 1
    #: No emphasis.  In the reference ``Unfiltered`` maps to 255 and falls into
    #: the shader's ``default:`` no-op branch (dips/src/lib.rs:36) — here it is
    #: a first-class identity.
    UNFILTERED = 255


class ChromaFilter(enum.Enum):
    """Which channel feeds the intensity plane (ref: dips/src/lib.rs:43-49;
    get_intensity in dips_shader.wgsl:64-82).  ALL is HSL lightness
    ``(max(r,g,b)+min(r,g,b))/2``."""

    ALL = 0
    RED = 1
    GREEN = 2
    BLUE = 3


class DiPsMethod(enum.Enum):
    """The two advertised diff methods (ref README.md:7-11).

    ``OVERALL`` (diff vs. a pinned snapshot baseline) is the one the reference
    implements; ``PER_FRAME`` (diff vs. the previous frame) is advertised there
    but unimplemented — here both are first-class.
    """

    OVERALL = 0
    PER_FRAME = 1


class OutputMode(enum.Enum):
    """What the pipeline emits per frame."""

    #: HSL-colorized diff map: red = negative, green = positive
    #: (ref diff_to_color, dips_shader.wgsl:30-36).
    COLORIZE = 0
    #: Grayscale ``0.5 - diff`` (ref dips_shader.wgsl:236).
    GRAYSCALE = 1
    #: Bit-exact uint8 ``|cur - baseline|`` per channel — the cv2.absdiff
    #: parity mode (BASELINE.json metric).
    ABSDIFF = 2
    #: Binary mask ``255 * (|cur - baseline| >= threshold)`` on uint8.
    THRESHOLD = 3
    #: No diff map at all: the raw integer absdiff pipeline (same baseline
    #: capture/refresh semantics and the same statistics + heatmap as
    #: ABSDIFF) with the map output suppressed END TO END — the kernel
    #: writes no output planes and the D2H transfer carries only the
    #: ~128 B of per-frame statistics.  The shape an events/stats-only
    #: camera fleet runs: the absdiff kernel is output-DMA-bound, so
    #: dropping the map raises chip throughput well past the parity
    #: mode's DMA ceiling (BASELINE.md "stats-only").  ``out_channels``
    #: is 0; engines return (n, H, W, 0) output arrays.
    STATS_ONLY = 4


class Encoding(enum.Enum):
    """Output video fourcc (ref: dips_alt/src/lib.rs:38-55).  H264 encode is
    unavailable in this image's OpenCV build; MJPG added as a pragmatic
    default."""

    RGBA = "RGBA"
    HFYU = "HFYU"
    H264 = "H264"
    MJPG = "MJPG"
    MP4V = "mp4v"

    @property
    def fourcc(self) -> str:
        return self.value


SIGMOID_SCALAR_MIN = 1.0   # ref clamp: dips_alt/src/dips_compute/mod.rs:220
SIGMOID_SCALAR_MAX = 10.0
WINDOW_MIN = 1             # ref clamp: dips_alt/src/dips_compute/mod.rs:225-228
WINDOW_MAX = 7
TEMPORAL_MIN = 1
TEMPORAL_MAX = 16          # ref MAX_TEMPORAL_ARRAY_SIZE:
                           # dips_alt/.../pre_compute_shader.wgsl:12
DEFAULT_TEMPORAL = 4       # ref TEMPORAL_BUFFER_SIZE: dips/src/gpu/bind_groups.rs:18
DEFAULT_SENSITIVITY = 5.0  # ref SENSITIVITY const: dips_shader.wgsl:25
DEFAULT_SIGMOID_SCALAR = 5.0  # ref default override: dips_shader.wgsl:17
DEFAULT_CHANGE_THRESHOLD = 10  # uint8 threshold for "changed pixel" stats


def clamp_window(w: int) -> int:
    """Clamp to odd 1..=7 the way the reference setter does
    (dips_alt/src/dips_compute/mod.rs:225-228: even values round down)."""
    w = int(w)
    w = max(WINDOW_MIN, min(WINDOW_MAX, w))
    if w % 2 == 0:
        w -= 1
    return w


def clamp_sigmoid_scalar(s: float) -> float:
    """Clamp to 1..=10 (ref: dips_alt/src/dips_compute/mod.rs:220)."""
    return float(max(SIGMOID_SCALAR_MIN, min(SIGMOID_SCALAR_MAX, float(s))))


def clamp_temporal(t: int) -> int:
    return int(max(TEMPORAL_MIN, min(TEMPORAL_MAX, int(t))))


@dataclasses.dataclass(frozen=True)
class DiPsProperties:
    """Frozen, hashable pipeline configuration.

    Field-for-field parity with the reference builder
    (``dips/src/lib.rs:63-170``): video_path ↔ input, frame callback ↔ the
    streaming runner's per-frame hook, output_path, colorize, spatial window,
    sensitivity, filter type, chroma filter — plus dips_alt extras
    (refresh markers, encoding: dips_alt/src/lib.rs:554-690) and the rebuild's
    new first-class knobs (method, temporal window, stats threshold).

    Being frozen/hashable lets the engine pass it as a static jit argument —
    the TPU analogue of WGSL override-constant pipeline specialisation.
    """

    method: DiPsMethod = DiPsMethod.OVERALL
    output: OutputMode = OutputMode.COLORIZE
    filter: DiPsFilter = DiPsFilter.SIGMOID
    chroma: ChromaFilter = ChromaFilter.ALL
    window_size: int = 3
    temporal_size: int = DEFAULT_TEMPORAL
    sensitivity: float = DEFAULT_SENSITIVITY
    sigmoid_horizontal_scalar: float = DEFAULT_SIGMOID_SCALAR
    #: Frame indices at which the overall-mode baseline is re-captured
    #: (ref refresh markers: dips_alt/src/lib.rs:668-670; SnapShot button
    #: dips_alt/src/lib.rs:296-298).  Frame 0 is always a capture.
    refresh_markers: Tuple[int, ...] = ()
    #: uint8 |diff| threshold for the changed-pixel count statistic and the
    #: THRESHOLD output mode.
    change_threshold: int = DEFAULT_CHANGE_THRESHOLD
    #: Opt-in separable spatial median (median of column medians): ~10x
    #: fewer comparators at window 7 than the exact 49-tap median, at the
    #: cost of an approximation (the result is always one of the window's
    #: own order statistics near the median; see docs/DESIGN.md for
    #: measured deviation).  The exact median remains the default.
    approx_median: bool = False
    #: Bug-for-bug compatibility with the reference ``dips`` crate's WGSL
    #: spatial filter (SURVEY.md §7 "Reference quirks"): the off-center
    #: ``(w-1)x(w-1)`` window (``for i in [-w/2, w/2)``,
    #: dips_shader.wgsl:132-133), the ``2w`` structural zeros its
    #: zero-initialised ``median_array`` contributes to the sort (the
    #: ``2w - 1`` never-written slots plus the in-bounds slot ``w*w`` the
    #: bubble sort's ``j + 1`` read touches, dips_shader.wgsl:151-166),
    #: the ``(w*w/2)+1`` pick (dips_shader.wgsl:168), and the rgba8unorm
    #: re-quantization of the filtered plane before the temporal median
    #: (the store-back at dips_shader.wgsl:187).  Net effect at w=3: the
    #: reference's "median filter" is constantly zero (six structural
    #: zeros occupy the sorted array through index 5), so the diff map
    #: degenerates to the baseline itself — replicated faithfully here
    #: and pinned against a WGSL replica in tests/test_reference_quirks.py.
    #: Default False = the documented clean semantics (true centered
    #: odd-window median).  Median/emphasis modes only (the raw
    #: ABSDIFF/THRESHOLD parity modes have no reference analogue and
    #: ignore it); engine warm-up/capture scheduling is not emulated.
    quirk_compat: bool = False
    #: Optional analysis region ``(y0, x0, y1, x1)`` (array order, end
    #: exclusive): per-frame STATISTICS, the changed-pixel count, the
    #: accumulated heatmap and therefore motion events consider only this
    #: rectangle — a camera ignores the busy road at the frame's edge.
    #: Output maps stay full-frame (filtering context is unaffected; ROI
    #: restricts the reductions, not the pixel math).  ``None`` = whole
    #: frame.  Engines validate the bounds against their geometry.
    roi: "Tuple[int, int, int, int] | None" = None
    #: Map suppression, ORTHOGONAL to the pipeline choice: ``False`` keeps
    #: the full configured pipeline — spatial/temporal medians, emphasis
    #: domain, COLORIZE vs GRAYSCALE stats semantics — but emits NO diff
    #: maps at all (``out_channels`` = 0; kernels drop their output blocks
    #: and the D2H transfer carries ~128 B/frame of statistics).  This is
    #: how a fleet gets *median-filtered, emphasis-domain* statistics and
    #: events (the robust-to-noise signal of the reference's median
    #: stages, dips_shader.wgsl:172-240) without paying map egress.
    #: ``OutputMode.STATS_ONLY`` remains the RAW-domain shorthand: it is
    #: exactly ``ABSDIFF`` + ``emit_maps=False`` (integer absdiff stats,
    #: no filtering) and ignores window/temporal/filter by design.
    emit_maps: bool = True

    def __post_init__(self):
        object.__setattr__(self, "window_size", clamp_window(self.window_size))
        object.__setattr__(
            self, "temporal_size", clamp_temporal(self.temporal_size))
        object.__setattr__(
            self, "sigmoid_horizontal_scalar",
            clamp_sigmoid_scalar(self.sigmoid_horizontal_scalar))
        object.__setattr__(self, "sensitivity", float(self.sensitivity))
        object.__setattr__(
            self, "refresh_markers",
            tuple(sorted(set(int(m) for m in self.refresh_markers))))
        # >= 1 so the "changed pixel" predicate |d| >= thr/255 is never
        # vacuously true (keeps padded-tile pixels out of the count).
        object.__setattr__(
            self, "change_threshold",
            int(max(1, min(255, self.change_threshold))))
        object.__setattr__(self, "emit_maps", bool(self.emit_maps))
        if self.quirk_compat and self.approx_median:
            raise ValueError(
                "quirk_compat replicates the reference's exact filter; it "
                "cannot combine with approx_median")
        if self.roi is not None:
            roi = tuple(int(v) for v in self.roi)
            if len(roi) != 4:
                raise ValueError(f"roi must be (y0, x0, y1, x1), got "
                                 f"{self.roi!r}")
            y0, x0, y1, x1 = roi
            if y0 < 0 or x0 < 0 or y1 <= y0 or x1 <= x0:
                raise ValueError(
                    f"roi needs 0 <= y0 < y1 and 0 <= x0 < x1, got {roi}")
            object.__setattr__(self, "roi", roi)

    # -- builder-style API (parity with DiPsProperties::new()...build(),
    #    dips/src/lib.rs:75-169) ------------------------------------------
    def with_method(self, m: DiPsMethod | str) -> "DiPsProperties":
        m = DiPsMethod[m.upper()] if isinstance(m, str) else m
        return dataclasses.replace(self, method=m)

    def with_output(self, o: OutputMode | str) -> "DiPsProperties":
        o = OutputMode[o.upper()] if isinstance(o, str) else o
        return dataclasses.replace(self, output=o)

    def with_filter(self, f: DiPsFilter | str) -> "DiPsProperties":
        f = DiPsFilter[f.upper()] if isinstance(f, str) else f
        return dataclasses.replace(self, filter=f)

    def with_chroma(self, c: ChromaFilter | str) -> "DiPsProperties":
        c = ChromaFilter[c.upper()] if isinstance(c, str) else c
        return dataclasses.replace(self, chroma=c)

    def with_window_size(self, w: int) -> "DiPsProperties":
        return dataclasses.replace(self, window_size=w)

    # reference-name aliases (dips/src/lib.rs builder method names)
    def with_spatial_window_size(self, w: int) -> "DiPsProperties":
        return self.with_window_size(w)

    def with_filter_type(self, f: "DiPsFilter | str") -> "DiPsProperties":
        return self.with_filter(f)

    def with_chroma_filter(self, c: "ChromaFilter | str") -> "DiPsProperties":
        return self.with_chroma(c)

    def with_colorize(self, colorize: bool) -> "DiPsProperties":
        return self.with_output(OutputMode.COLORIZE if colorize
                                else OutputMode.GRAYSCALE)

    def with_temporal_size(self, t: int) -> "DiPsProperties":
        return dataclasses.replace(self, temporal_size=t)

    def with_sensitivity(self, s: float) -> "DiPsProperties":
        return dataclasses.replace(self, sensitivity=s)

    def with_sigmoid_horizontal_scalar(self, s: float) -> "DiPsProperties":
        return dataclasses.replace(self, sigmoid_horizontal_scalar=s)

    def with_refresh_markers(self, markers: Sequence[int]) -> "DiPsProperties":
        return dataclasses.replace(self, refresh_markers=tuple(markers))

    def with_change_threshold(self, t: int) -> "DiPsProperties":
        return dataclasses.replace(self, change_threshold=t)

    def with_approx_median(self, a: bool = True) -> "DiPsProperties":
        return dataclasses.replace(self, approx_median=bool(a))

    def with_quirk_compat(self, q: bool = True) -> "DiPsProperties":
        return dataclasses.replace(self, quirk_compat=bool(q))

    def with_roi(self, roi: "Sequence[int] | None") -> "DiPsProperties":
        return dataclasses.replace(
            self, roi=None if roi is None else tuple(roi))

    def with_emit_maps(self, e: bool = True) -> "DiPsProperties":
        return dataclasses.replace(self, emit_maps=bool(e))

    def roi_bounds(self, h: int, w: int) -> Tuple[int, int, int, int]:
        """The analysis rectangle validated against a concrete geometry:
        ``(y0, x0, y1, x1)`` (the full frame when ``roi`` is None), or
        ``ValueError`` when the configured roi does not fit in h x w."""
        if self.roi is None:
            return (0, 0, h, w)
        y0, x0, y1, x1 = self.roi
        if y1 > h or x1 > w:
            raise ValueError(f"roi {self.roi} exceeds the {h}x{w} frame")
        return self.roi

    def analysis_pixels(self, h: int, w: int) -> int:
        """Pixels the statistics reduce over: the roi area (or h*w)."""
        y0, x0, y1, x1 = self.roi_bounds(h, w)
        return (y1 - y0) * (x1 - x0)

    @property
    def colorize(self) -> bool:
        return self.output == OutputMode.COLORIZE

    @property
    def out_channels(self) -> int:
        # ABSDIFF is per-channel on the raw frames (3 for RGB input, matching
        # cv2.absdiff); THRESHOLD and GRAYSCALE are single-plane;
        # STATS_ONLY and emit_maps=False emit no map at all.
        if self.output == OutputMode.STATS_ONLY or not self.emit_maps:
            return 0
        if self.output == OutputMode.COLORIZE:
            return 3
        if self.output == OutputMode.ABSDIFF:
            return 3
        return 1


#: named geometry shorthand shared by the serving daemon (--warm), the
#: load generator and deployment docs
GEOMETRY_NAMES = {"480p": (480, 854), "720p": (720, 1280),
                  "1080p": (1080, 1920), "4k": (2160, 3840)}


def parse_geometry(g: str) -> Tuple[int, int]:
    """``"HxW"`` or a name from :data:`GEOMETRY_NAMES` -> (height, width)."""
    key = str(g).strip().lower()
    if key in GEOMETRY_NAMES:
        return GEOMETRY_NAMES[key]
    try:
        h, w = (int(v) for v in key.split("x"))
        return h, w
    except ValueError:
        raise ValueError(f"bad geometry {g!r}: use HxW or one of "
                         f"{sorted(GEOMETRY_NAMES)}")
