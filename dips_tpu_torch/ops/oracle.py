"""Pure-numpy oracle: the executable specification of DiPs pixel math.

The reference ships no tests (SURVEY.md §4), so this module *is* the spec.
Every device implementation (the jnp/XLA path in ``ops/reference.py`` and the
fused Pallas kernel in ``ops/pallas_fused.py``) is asserted against this
oracle.  The math follows the reference kernels' *intent* with the WGSL
quirks fixed (SURVEY.md §7 "Hard parts"):

* true centered odd window (the reference iterates ``i < win/2``, an
  off-center even window: dips_shader.wgsl:132-133) — here taps span
  ``[-w//2, w//2]`` inclusive;
* true median index ``n // 2`` of the sorted taps (the reference picks
  ``(n/2)+1`` and its bubble sort reads one past the end:
  dips_shader.wgsl:151-168) — for odd n this is the exact median, for even
  temporal windows it is the upper median, matching the reference's
  ``MEDIAN_ARRAY_SIZE / 2`` pick (dips_shader.wgsl:214);
* zero-valued out-of-bounds taps, as in the reference
  (dips_shader.wgsl:135-137).

Value domain: uint8 channels are mapped to f32 in [0, 1] (``x / 255``), all
math is f32, final quantization is ``rint(clamp(x, 0, 1) * 255)`` — the
round-to-nearest-even of an ``rgba8unorm`` store.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..properties import (ChromaFilter, DiPsFilter, DiPsMethod, DiPsProperties,
                          OutputMode)

# Statistic channel order for the per-frame reduction vector.
STAT_NAMES = ("mean_diff", "mean_abs_diff", "max_abs_diff", "changed_count")
NUM_STATS = len(STAT_NAMES)

# inv_sigmoid's domain is (-0.5, 0.5); clamp its input this far inside the
# open interval so log() stays finite (the reference lets it reach inf).
INV_SIGMOID_EPS = 1e-6


#: The filtering pipeline works on the INTEGER intensity scale: ALL-chroma
#: intensity is the exact integer cmax+cmin in [0, 510] (HSL lightness x
#: 510), single channels are 2*c on the same scale.  Medians are selections
#: (monotone-invariant), so filtering on integers is exact, and the diff
#: gets ONE rounding — `(int_a - int_b) * INTENSITY_SCALE` — instead of
#: accumulating per-channel /255 roundings.  This is also what lets the TPU
#: kernel run its median networks in packed int16 bit-identically.
INTENSITY_SCALE = np.float32(1.0 / 510.0)


def intensity_int(frame_u8: np.ndarray, chroma: ChromaFilter) -> np.ndarray:
    """uint8 (H, W, 3) RGB -> f32 (H, W) INTEGER-valued intensity in
    [0, 510] (ALL = cmax+cmin, ref get_intensity dips_shader.wgsl:64-82;
    single channels = 2*c on the same scale)."""
    f = frame_u8.astype(np.int32)
    if chroma == ChromaFilter.RED:
        v = 2 * f[..., 0]
    elif chroma == ChromaFilter.GREEN:
        v = 2 * f[..., 1]
    elif chroma == ChromaFilter.BLUE:
        v = 2 * f[..., 2]
    else:
        v = np.max(f, axis=-1) + np.min(f, axis=-1)
    return v.astype(np.float32)


def intensity(frame_u8: np.ndarray, chroma: ChromaFilter) -> np.ndarray:
    """uint8 (H, W, 3) RGB -> f32 (H, W) intensity in [0, 1] (the display
    scale: :func:`intensity_int` x INTENSITY_SCALE)."""
    return intensity_int(frame_u8, chroma) * INTENSITY_SCALE


def spatial_median(plane: np.ndarray, window: int,
                   approx: bool = False, quirk: bool = False) -> np.ndarray:
    """Centered odd-window median with zero padding outside the image.

    ``window == 1`` is the identity (ref dips_shader.wgsl:123-126).
    Median = sorted taps at index ``(w*w) // 2`` (exact median, w odd).
    ``approx`` selects the separable approximation (median of column
    medians, then median across horizontal offsets — the same zero-padded
    boundary semantics), matching ``DiPsProperties.approx_median``.
    ``quirk`` replicates the reference shader bug-for-bug instead
    (``DiPsProperties.quirk_compat``): the off-center ``(w-1)x(w-1)``
    window sorted together with the 2w structural zeros of the WGSL's
    zero-initialised ``median_array`` (2w-1 never-written slots + the
    in-bounds slot ``w*w`` the bubble sort's ``j+1`` read drags in,
    dips_shader.wgsl:129-168), picked at ``(w*w)/2 + 1`` — with
    non-negative taps that is rank ``(w*w)//2 + 1 - 2w`` of the taps,
    negative (= constant zero) at w == 3.
    """
    if window <= 1:
        return plane.astype(np.float32)
    h, w = plane.shape
    p = window // 2
    padded = np.zeros((h + 2 * p, w + 2 * p), np.float32)
    padded[p:p + h, p:p + w] = plane
    if quirk:
        n2 = window * window
        rank = n2 // 2 + 1 - 2 * window
        if rank < 0:  # w == 3: the zeros cover the picked index
            return np.zeros_like(plane, np.float32)
        # taps at offsets [-p, p) in both axes; padded[dy:dy+h] has
        # vertical offset dy - p, so dy, dx range over [0, w-1)
        taps = np.stack([padded[dy:dy + h, dx:dx + w]
                         for dy in range(window - 1)
                         for dx in range(window - 1)])
        return np.partition(taps, rank, axis=0)[rank]
    if approx:
        vtaps = np.stack([padded[dy:dy + h, p:p + w]
                          for dy in range(window)])
        vtaps.sort(axis=0)
        colmed = vtaps[window // 2]
        cpad = np.zeros((h, w + 2 * p), np.float32)
        cpad[:, p:p + w] = colmed
        htaps = np.stack([cpad[:, dx:dx + w] for dx in range(window)])
        htaps.sort(axis=0)
        return htaps[window // 2]
    taps = np.empty((window * window, h, w), np.float32)
    k = 0
    for dy in range(window):
        for dx in range(window):
            taps[k] = padded[dy:dy + h, dx:dx + w]
            k += 1
    taps.sort(axis=0)
    return taps[(window * window) // 2]


def temporal_median(planes: np.ndarray) -> np.ndarray:
    """(T, H, W) -> (H, W): per-pixel median across the frame ring.

    Index ``T // 2`` of the sorted values: the exact median for odd T and the
    upper median for even T (the reference's ``MEDIAN_ARRAY_SIZE / 2`` pick,
    dips_shader.wgsl:214).
    """
    t = planes.shape[0]
    if t == 1:
        return planes[0].astype(np.float32)
    s = np.sort(planes.astype(np.float32), axis=0)
    return s[t // 2]


def emphasize(diff: np.ndarray, filt: DiPsFilter, sigmoid_scalar: float,
              sensitivity: float) -> np.ndarray:
    """Map raw diff [-1,1] -> [-0.5,0.5], apply the nonlinear filter, scale.

    ref: map() dips_shader.wgsl:97-105 (×0.5), sigmoid :108-112
    ``1/(1+exp(-k·d)) - 0.5``, inv_sigmoid :114-118
    ``-log(1/(d+0.5) - 1)/k``, then ×SENSITIVITY :229.
    """
    d = diff.astype(np.float32) * np.float32(0.5)
    k = np.float32(sigmoid_scalar)
    if filt == DiPsFilter.SIGMOID:
        d = np.float32(1.0) / (np.float32(1.0) + np.exp(-k * d)) - np.float32(0.5)
    elif filt == DiPsFilter.INVERSE_SIGMOID:
        dc = np.clip(d, -0.5 + INV_SIGMOID_EPS, 0.5 - INV_SIGMOID_EPS)
        d = -np.log(np.float32(1.0) / (dc + np.float32(0.5)) - np.float32(1.0)) / k
    return d * np.float32(sensitivity)


def hsl_to_rgb(h: np.ndarray, s: np.ndarray, l: np.ndarray) -> np.ndarray:
    """Vectorized HSL -> RGB, h in [0, 360) (ref dips_shader.wgsl:40-62)."""
    h = np.asarray(h, np.float32)
    s = np.asarray(s, np.float32)
    l = np.asarray(l, np.float32)
    c = s * (1.0 - np.abs(2.0 * l - 1.0))
    hp = h / np.float32(60.0)
    x = c * (1.0 - np.abs(np.mod(hp, 2.0) - 1.0))
    m = l - c / 2.0
    z = np.zeros_like(c)
    sector = np.floor(hp).astype(np.int32)
    r = np.select([sector == 0, sector == 1, sector == 2,
                   sector == 3, sector == 4, sector >= 5],
                  [c, x, z, z, x, c], default=z)
    g = np.select([sector == 0, sector == 1, sector == 2,
                   sector == 3, sector == 4, sector >= 5],
                  [x, c, c, x, z, z], default=z)
    b = np.select([sector == 0, sector == 1, sector == 2,
                   sector == 3, sector == 4, sector >= 5],
                  [z, z, x, c, c, x], default=z)
    return np.stack([r + m, g + m, b + m], axis=-1)


def diff_to_color(diff: np.ndarray) -> np.ndarray:
    """(H, W) signed diff -> (H, W, 3) f32: red negative, green positive.

    With l = 0.5 the reference's HSL call (dips_shader.wgsl:30-36) reduces to
    a closed form: s = |diff|, negative -> (0.5+s/2, 0.5-s/2, 0.5-s/2),
    positive -> (0.5-s/2, 0.5+s/2, 0.5-s/2).  Verified against
    :func:`hsl_to_rgb` in tests.
    """
    d = diff.astype(np.float32)
    s = np.abs(d)
    hi = np.float32(0.5) + s * np.float32(0.5)
    lo = np.float32(0.5) - s * np.float32(0.5)
    neg = d < 0
    r = np.where(neg, hi, lo)
    g = np.where(neg, lo, hi)
    b = lo
    return np.stack([r, g, b], axis=-1)


def quantize_u8(x: np.ndarray) -> np.ndarray:
    """f32 [0,1] -> uint8, round-half-even (rgba8unorm store semantics)."""
    return np.rint(np.clip(x, 0.0, 1.0) * np.float32(255.0)).astype(np.uint8)


def absdiff_u8(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Bit-exact uint8 |a - b| per channel (== cv2.absdiff)."""
    return np.abs(a.astype(np.int16) - b.astype(np.int16)).astype(np.uint8)


def threshold_mask_u8(a: np.ndarray, b: np.ndarray, threshold: int) -> np.ndarray:
    """255 where max-over-channels |a-b| >= threshold, else 0; (H, W) uint8."""
    d = absdiff_u8(a, b)
    if d.ndim == 3:
        d = d.max(axis=-1)
    return np.where(d >= np.uint8(threshold), np.uint8(255), np.uint8(0))


def frame_stats(raw_diff: np.ndarray, change_threshold: int) -> np.ndarray:
    """Per-frame intensity-change reductions on the raw signed diff [-1, 1].

    Returns f32 [mean_diff, mean_abs_diff, max_abs_diff, changed_count]
    (``STAT_NAMES``).  ``changed`` means |diff| >= change_threshold/255.
    """
    d = raw_diff.astype(np.float32)
    a = np.abs(d)
    thr = np.float32(change_threshold) / np.float32(255.0)
    return np.array([d.mean(), a.mean(), a.max(),
                     np.count_nonzero(a >= thr)], np.float32)


class DiPsOracle:
    """Stateful streaming oracle: the spec for the whole pipeline.

    Feed uint8 RGB frames with :meth:`process`; get the uint8 output map and
    the stats vector back.  Semantics:

    * The temporal ring (length ``temporal_size``) is pre-filled with the
      first frame, so output begins at frame 0 (clean warm-up; the reference
      either waits 4 frames — dips — or diffs against uninitialised memory —
      dips_alt).
    * OVERALL: the baseline is the temporal median captured at frame 0 and at
      every refresh marker (ref refresh markers dips_alt/src/lib.rs:668-670).
      On a capture frame the output is the baseline itself rendered gray and
      the diff is zero (ref snapshot branch,
      dips_alt/.../pre_compute_shader.wgsl:231-235).
    * PER_FRAME: the baseline is the previous frame's temporal median; the
      first frame diffs to zero.
    * diff = baseline - current (ref orientation, dips_shader.wgsl:213-214).
    * ABSDIFF / THRESHOLD output modes skip the median/emphasis path and
      operate bit-exactly on raw uint8 frames vs. the (raw) baseline frame —
      the cv2.absdiff parity surface.  Stats still use the f32 convention.
    """

    def __init__(self, props: DiPsProperties):
        self.props = props
        self.frame_index = 0
        self._ring: Optional[np.ndarray] = None       # (T, H, W) f32 filtered
        self._baseline: Optional[np.ndarray] = None   # (H, W) f32
        self._raw_baseline: Optional[np.ndarray] = None  # uint8 frame
        self._prev_raw: Optional[np.ndarray] = None
        self._prev_filtered: Optional[np.ndarray] = None  # (H, W) f32
        #: accumulated per-pixel sum of |raw_diff| (the intensity-change
        #: heatmap, BASELINE configs[2])
        self.heatmap: Optional[np.ndarray] = None

    def _roi_slices(self, h: int, w: int) -> Tuple[slice, slice]:
        """Row/col slices of the analysis region (whole frame sans roi)."""
        y0, x0, y1, x1 = self.props.roi_bounds(h, w)
        return slice(y0, y1), slice(x0, x1)

    def _accumulate(self, raw_diff: np.ndarray) -> None:
        a = np.abs(raw_diff.astype(np.float32))
        if self.props.roi is not None:
            sl = self._roi_slices(*a.shape)
            masked = np.zeros_like(a)
            masked[sl] = a[sl]
            a = masked
        self.heatmap = a if self.heatmap is None else self.heatmap + a

    # -- helpers ----------------------------------------------------------
    def _is_capture(self, idx: int) -> bool:
        return idx == 0 or idx in self.props.refresh_markers

    def _filtered(self, frame_u8: np.ndarray) -> np.ndarray:
        """Integer-scale filtered plane (values in [0, 510]; medians are
        selections, so integerness is preserved).

        ``quirk_compat`` additionally re-quantizes the plane to the uint8
        grid (even integers on the [0, 510] scale, round-half-even): the
        reference stores the filtered frame back through an rgba8unorm
        texture before the temporal median reads it
        (dips_shader.wgsl:187).  Its baseline path quantizes only after
        its temporal median (pre_compute_shader.wgsl:131), but selection
        commutes with the monotone rounding, so quantize-then-select is
        identical."""
        plane = intensity_int(frame_u8, self.props.chroma)
        phi = spatial_median(plane, self.props.window_size,
                             self.props.approx_median,
                             self.props.quirk_compat)
        if self.props.quirk_compat:
            phi = np.float32(2.0) * np.rint(phi * np.float32(0.5))
        return phi

    # -- streaming API ----------------------------------------------------
    def process(self, frame_u8: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        p = self.props
        idx = self.frame_index
        self.frame_index += 1

        if p.output in (OutputMode.ABSDIFF, OutputMode.THRESHOLD,
                        OutputMode.STATS_ONLY):
            return self._process_raw(frame_u8, idx)

        filt = self._filtered(frame_u8)
        if self._ring is None:
            self._ring = np.broadcast_to(
                filt, (p.temporal_size,) + filt.shape).copy()
        else:
            self._ring = np.concatenate(
                [self._ring[1:], filt[None]], axis=0)
        cur = temporal_median(self._ring)

        if p.method == DiPsMethod.OVERALL:
            if self._is_capture(idx) or self._baseline is None:
                self._baseline = cur
                self._prev_filtered = cur
                self._accumulate(np.zeros_like(cur))
                stats0 = frame_stats(np.zeros_like(cur), p.change_threshold)
                if p.out_channels == 0:  # emit_maps=False: stats only
                    return np.zeros(cur.shape + (0,), np.uint8), stats0
                disp = cur * INTENSITY_SCALE
                out = quantize_u8(np.broadcast_to(
                    disp[..., None], disp.shape + (p.out_channels,)))
                if p.out_channels == 1:
                    out = out[..., 0]
                return out, stats0
            baseline = self._baseline
        else:  # PER_FRAME
            baseline = self._prev_filtered if idx > 0 else cur
        self._prev_filtered = cur

        # one rounding: exact integer difference scaled once to [-1, 1]
        raw_diff = (baseline - cur) * INTENSITY_SCALE
        self._accumulate(raw_diff)
        sl = self._roi_slices(*raw_diff.shape)
        stats = frame_stats(raw_diff[sl], p.change_threshold)
        if p.out_channels == 0:
            # emit_maps=False: full median pipeline, no map — stats and
            # heatmap are identical to the map-emitting run
            return np.zeros(raw_diff.shape + (0,), np.uint8), stats
        d = emphasize(raw_diff, p.filter, p.sigmoid_horizontal_scalar,
                      p.sensitivity)
        if p.output == OutputMode.COLORIZE:
            out = quantize_u8(diff_to_color(d))
        else:  # GRAYSCALE: 0.5 - diff (ref dips_shader.wgsl:236)
            out = quantize_u8(np.float32(0.5) - d)
        return out, stats

    def _process_raw(self, frame_u8: np.ndarray, idx: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        p = self.props
        if p.method == DiPsMethod.OVERALL:
            if self._is_capture(idx) or self._raw_baseline is None:
                self._raw_baseline = frame_u8.copy()
            baseline = self._raw_baseline
        else:
            baseline = self._prev_raw if self._prev_raw is not None else frame_u8
        self._prev_raw = frame_u8.copy()

        d_u8 = absdiff_u8(frame_u8, baseline)
        # Raw modes stay entirely in the integer domain (the parity/fast
        # path): statistics are channel-mean reductions of the uint8 diff,
        # normalised to the same [0,1] scale as the f32 modes.
        #   mean_diff     = sum(baseline - frame) / (3*H*W*255)
        #   mean_abs_diff = sum(d_u8)            / (3*H*W*255)
        #   max_abs_diff  = max(d_u8) / 255
        #   changed_count = #pixels with max-channel d_u8 >= threshold
        h, w = frame_u8.shape[:2]
        sl = self._roi_slices(h, w)  # reductions over the analysis region
        d_roi = d_u8[sl]
        sum_signed = (int(baseline[sl].astype(np.int64).sum())
                      - int(frame_u8[sl].astype(np.int64).sum()))
        sum_abs = int(d_roi.astype(np.int64).sum())
        dmax = d_roi.max(axis=-1)
        inv = np.float32(1.0) / np.float32(
            3 * p.analysis_pixels(h, w) * 255)
        stats = np.array([
            np.float32(sum_signed) * inv,
            np.float32(sum_abs) * inv,
            np.float32(int(d_roi.max())) * np.float32(1 / 255.0),
            np.count_nonzero(dmax >= np.uint8(p.change_threshold)),
        ], np.float32)
        # heatmap in the same channel-mean units
        self._accumulate(d_u8.astype(np.float32).sum(axis=-1)
                         * np.float32(1.0 / (3 * 255.0)))
        if p.out_channels == 0:
            # STATS_ONLY (or raw + emit_maps=False): stats/heatmap identical
            # to ABSDIFF, output is the zero-channel (H, W, 0) array
            # (engines return the same shape)
            return np.zeros(frame_u8.shape[:2] + (0,), np.uint8), stats
        if p.output == OutputMode.ABSDIFF:
            return d_u8, stats
        return (threshold_mask_u8(frame_u8, baseline, p.change_threshold),
                stats)

    def run(self, frames_u8: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Process (N, H, W, 3) frames; returns (outputs, stats (N, 4))."""
        outs, stats = [], []
        for f in frames_u8:
            o, s = self.process(f)
            outs.append(o)
            stats.append(s)
        return np.stack(outs), np.stack(stats)
