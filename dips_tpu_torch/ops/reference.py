"""Plain PyTorch stage functions of the DiPs pipeline.

Counterpart of ``dips_tpu/ops/reference.py``: the same padded geometry,
layouts and op order, written as plain functions on tensors.  The plain
twins of the CUDA kernels (``ops/cuda_fused.py``) are built from these
stages, and the CPU tests hold each stage against its JAX original.

Filtering runs on the integer intensity scale [0, 510] carried in float32:
medians are selections, so they stay integer-exact, and the diff gets one
rounding (``diff_i * INTENSITY_SCALE``).

:func:`batch_step` and :func:`absdiff_step` are the whole tail-protocol
steps, as the JAX package's portable backend runs them: the input is the T
raw tail frames followed by the B new ones, and every step is a pure
function of its arguments (new tensors out, nothing updated in place).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..properties import (ChromaFilter, DiPsFilter, DiPsMethod,
                          DiPsProperties, OutputMode)
from . import networks

#: Per-frame statistic order: mean_diff, mean_abs_diff, max_abs_diff,
#: changed_count (``ops/oracle.py`` STAT_NAMES).
STAT_NAMES = ("mean_diff", "mean_abs_diff", "max_abs_diff", "changed_count")
NUM_STATS = len(STAT_NAMES)
#: inverse sigmoid input is clipped this far inside (-0.5, 0.5)
INV_SIGMOID_EPS = 1e-6
#: integer intensity [0, 510] -> diff in [-1, 1], one rounding
INTENSITY_SCALE = float(np.float32(1.0 / 510.0))


def pad_geometry(h: int, w: int) -> Tuple[int, int]:
    """(H, W) -> padded (Hp, Wp): rows to a multiple of 8, columns to a
    multiple of 128 with at least 4 zero columns (the JAX package's padded
    shapes, kept so that state and checkpoints compare directly)."""
    hp = -(-h // 8) * 8
    wp = -(-w // 128) * 128
    if wp - w < 4:
        wp += 128
    return hp, wp


def planarize_host(frame: np.ndarray, hp: int, wp: int,
                   swap_rb: bool = False) -> np.ndarray:
    """Host (H, W, 3) uint8 -> zero-padded planar (3, Hp, Wp) uint8."""
    h, w, _ = frame.shape
    rgb = frame[..., :3]
    if swap_rb:
        rgb = rgb[..., ::-1]
    out = np.zeros((3, hp, wp), np.uint8)
    out[:, :h, :w] = np.moveaxis(rgb, -1, 0)
    return out


def pool_frame_host(frame_u8: np.ndarray, k: int) -> np.ndarray:
    """Host twin of the device decimation in :func:`make_layout_prep`:
    uint8 (H, W, C) -> (H//k, W//k, C) by k x k box mean, rounded
    half-to-even.  Bit-identical to the device path (exact integer sums,
    the same f32 ``* 1/k**2`` multiply, the same ``rint``) — the engines
    use it only for the <= T checkpoint-tail frames per batch."""
    h, w, c = frame_u8.shape
    s = frame_u8.astype(np.int32).reshape(h // k, k, w // k, k, c)
    s = s.sum(axis=(1, 3), dtype=np.int32)
    v = np.rint(s.astype(np.float32) * np.float32(1.0 / (k * k)))
    return v.astype(np.int32).astype(np.uint8)


def make_layout_prep(layout: str, height: int, width: int, hp: int, wp: int,
                     downscale: int = 1):
    """Input-layout contract: returns ``(swap_rb, prep)`` where ``prep``
    maps uint8 (..., H, W, 3) frames to padded planar (..., 3, Hp, Wp) on
    the frames' device (permute + optional BGR flip + zero pad).  Layouts:
    "hwc" (RGB), "hwc_bgr" (cv2's BGR order, swapped in the same copy) and
    "planar" (frames arrive padded planar: no prep, ``prep`` is None).

    ``downscale = k > 1`` (hwc layouts only): ``prep`` takes the full input
    frames (..., height*k, width*k, 3) and first takes their k x k box mean
    on the integer scale, times float32(1/k**2), rounded half to even
    (:func:`pool_frame_host` is its bit-identical host twin).
    ``height`` / ``width`` are the analysis dims."""
    if layout not in ("planar", "hwc", "hwc_bgr"):
        raise ValueError(f"unknown input_layout {layout!r}")
    k = int(downscale)
    if k < 1:
        raise ValueError(f"downscale must be >= 1, got {downscale}")
    swap = layout == "hwc_bgr"
    if layout == "planar":
        if k > 1:
            raise ValueError(
                "downscale runs on the device and needs the hwc upload "
                "path (input_layout='hwc'/'hwc_bgr')")
        return swap, None
    inv_k2 = _f32(1.0 / (k * k))

    def prep(x: torch.Tensor, out: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        if k > 1:
            lead = x.shape[:-3]
            s = x.reshape(lead + (height, k, width, k, 3)).sum(
                dim=(-4, -2), dtype=torch.int32)
            x = torch.round(s.to(torch.float32) * inv_k2).to(torch.uint8)
        planar = x.movedim(-1, -3)
        if swap:
            planar = planar.flip(-3)
        if out is None:
            out = x.new_zeros(x.shape[:-3] + (3, hp, wp))
        # the padding of ``out`` is zero and is never written
        out[..., :height, :width] = planar
        return out

    return swap, prep


def intensity_planar(rgb_u8: torch.Tensor, chroma: ChromaFilter
                     ) -> torch.Tensor:
    """uint8 planar (..., 3, H, W) -> float32 (..., H, W) integer-valued
    intensity in [0, 510]: cmax + cmin, or 2 * channel."""
    f = rgb_u8.to(torch.int32)
    if chroma == ChromaFilter.RED:
        v = 2 * f[..., 0, :, :]
    elif chroma == ChromaFilter.GREEN:
        v = 2 * f[..., 1, :, :]
    elif chroma == ChromaFilter.BLUE:
        v = 2 * f[..., 2, :, :]
    else:
        r, g, b = f[..., 0, :, :], f[..., 1, :, :], f[..., 2, :, :]
        v = (torch.maximum(torch.maximum(r, g), b)
             + torch.minimum(torch.minimum(r, g), b))
    return v.to(torch.float32)


def spatial_median(planes: torch.Tensor, window: int, approx: bool = False,
                   quirk: bool = False, top: Optional[torch.Tensor] = None,
                   bottom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., H, W) centered window filter with zero out-of-bounds taps: the
    exact median through the column-factored plan of
    ``networks.window_median``; ``approx`` the separable approximation
    (``networks.separable_median``, DiPsProperties.approx_median);
    ``quirk`` the reference's off-center rank pick
    (``networks.quirk_window_select``, DiPsProperties.quirk_compat).

    ``top`` / ``bottom`` (..., window // 2, W): the rows just above and
    just below the planes, read by the taps that would otherwise read the
    zero fill there (a row slab's neighbour rows); the columns outside
    [0, W) stay zero."""
    if window <= 1:
        return planes
    p = window // 2
    h, w = planes.shape[-2], planes.shape[-1]
    padded = F.pad(planes, (p, p, p, p))
    if top is not None:
        padded[..., :p, p:p + w] = top
        padded[..., p + h:, p:p + w] = bottom

    def shift(x, dx):
        return x[..., p + dx:p + dx + w]

    if quirk:
        vtaps = [padded[..., dy:dy + h, :] for dy in range(window - 1)]
        return networks.quirk_window_select(vtaps, shift, torch.minimum,
                                            torch.maximum)
    vtaps = [padded[..., dy:dy + h, :] for dy in range(window)]
    fn = networks.separable_median if approx else networks.window_median
    return fn(vtaps, shift, torch.minimum, torch.maximum)


#: rows of a slab band: one 8-row block covers the widest halo (window 7)
BAND_ROWS = 8


def filtered_planes(raw_u8: torch.Tensor, props: DiPsProperties,
                    bands=None) -> torch.Tensor:
    """uint8 planar (..., 3, H, W) -> the spatially filtered (..., H, W)
    planes that enter the temporal ring: intensity, then the window filter
    of ``props``; with ``quirk_compat`` rounded back to the u8 grid (even
    integers on the [0, 510] scale, half to even), as the reference's
    rgba8unorm store does before its temporal median.

    ``bands`` = (top, bottom) u8 (..., 3, 8, W): the 8 rows above and the
    8 rows below the planes (a row slab's neighbour bands); the window's
    taps outside the planes read the last window // 2 rows of ``top`` and
    the first of ``bottom`` instead of zeros."""
    p = props.window_size // 2
    fill = {}
    if bands is not None and p:
        top, bottom = bands
        fill = dict(
            top=intensity_planar(top[..., BAND_ROWS - p:, :], props.chroma),
            bottom=intensity_planar(bottom[..., :p, :], props.chroma))
    phi = spatial_median(intensity_planar(raw_u8, props.chroma),
                         props.window_size, props.approx_median,
                         props.quirk_compat, **fill)
    if props.quirk_compat:
        phi = 2.0 * torch.round(phi * 0.5)
    return phi


def temporal_median(slots) -> torch.Tensor:
    """Exact elementwise median (index n // 2, the upper median for even n)
    of a list of planes."""
    return networks.median_of(list(slots), torch.minimum, torch.maximum)


def _f32(x: float) -> float:
    """A Python float holding the float32 rounding of ``x`` (a scalar
    operand of a float32 tensor op then rounds exactly as the JAX
    package's ``jnp.float32(x)``)."""
    return float(np.float32(x))


def emphasize(diff: torch.Tensor, filt: DiPsFilter, sigmoid_scalar: float,
              sensitivity: float) -> torch.Tensor:
    """Map x0.5 -> sigmoid / inverse sigmoid / identity -> x sensitivity,
    op for op as the JAX package computes it in float32."""
    d = diff * 0.5
    k = _f32(sigmoid_scalar)
    if filt == DiPsFilter.SIGMOID:
        d = 1.0 / (1.0 + torch.exp(d * -k)) - 0.5
    elif filt == DiPsFilter.INVERSE_SIGMOID:
        dc = torch.clamp(d, _f32(-0.5 + INV_SIGMOID_EPS),
                         _f32(0.5 - INV_SIGMOID_EPS))
        d = -torch.log(1.0 / (dc + 0.5) - 1.0) / k
    return d * _f32(sensitivity)


def diff_to_color_planes(d: torch.Tensor):
    """Signed diff -> (r, g, b) float32 planes: red negative, green
    positive."""
    s = torch.abs(d)
    hi = 0.5 + s * 0.5
    lo = 0.5 - s * 0.5
    neg = d < 0
    return torch.where(neg, hi, lo), torch.where(neg, lo, hi), lo


def quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """float32 [0, 1] -> uint8, rounding half to even (``torch.round``)."""
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


def valid_mask(hp: int, wp: int, h: int, w: int, roi=None,
               device=None) -> torch.Tensor:
    """(Hp, Wp) float32 mask: 1 on the true pixels (or on the ``roi``
    rectangle (y0, x0, y1, x1) when given), 0 elsewhere."""
    y0, x0, y1, x1 = (0, 0, h, w) if roi is None else roi
    m = torch.zeros((hp, wp), dtype=torch.float32, device=device)
    m[y0:y1, x0:x1] = 1.0
    return m


def temporal_median_windows(filtered: torch.Tensor, t: int) -> torch.Tensor:
    """(N, H, W) -> (N - t + 1, H, W): the median of each length-t window
    of consecutive planes."""
    m = filtered.shape[0] - t + 1
    return temporal_median([filtered[k:k + m] for k in range(t)])


def masked_stats(raw_diff: torch.Tensor, n_valid: int,
                 change_threshold: int) -> torch.Tensor:
    """(B, H, W) masked raw diff -> (B, NUM_STATS) float32 reductions."""
    a = raw_diff.abs()
    thr = _f32(np.float32(change_threshold) / np.float32(255.0))
    inv_n = _f32(1.0 / n_valid)
    return torch.stack([
        raw_diff.sum(dim=(-2, -1)) * inv_n,
        a.sum(dim=(-2, -1)) * inv_n,
        a.amax(dim=(-2, -1)),
        (a >= thr).to(torch.float32).sum(dim=(-2, -1)),
    ], dim=-1)


def capture_scan(baseline: torch.Tensor, cur: torch.Tensor, flags
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """OVERALL baseline pinning, frame by frame in order: returns (the
    carried baseline, the baseline each frame diffs against).  A flagged
    frame pins itself before it is diffed."""
    pinned = []
    bl = baseline
    for c, flag in zip(cur, np.asarray(torch.as_tensor(flags).cpu())):
        if flag:
            bl = c
        pinned.append(bl)
    return bl, torch.stack(pinned)


def render_output(props: DiPsProperties, d: torch.Tensor, cur: torch.Tensor,
                  flags) -> torch.Tensor:
    """Emphasised diff (B, H, W) -> quantized u8 maps (B, C, H, W);
    OVERALL capture frames render the freshly pinned baseline as gray."""
    if props.output == OutputMode.COLORIZE:
        out = torch.stack(diff_to_color_planes(d), dim=1)
    else:  # GRAYSCALE: 0.5 - diff
        out = (0.5 - d)[:, None]
    if props.method == DiPsMethod.OVERALL:
        flags = torch.as_tensor(flags, device=d.device).to(torch.bool)
        out = torch.where(flags[:, None, None, None],
                          (cur * INTENSITY_SCALE)[:, None], out)
    return quantize_u8(out)


def batch_step(props: DiPsProperties, h: int, w: int, raw: torch.Tensor,
               baseline: torch.Tensor, snap_flags, heatmap: torch.Tensor,
               valid) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """One tail-protocol step of the median pipeline.

    raw u8 (T+B, 3, Hp, Wp), tail first; baseline / heatmap f32 (Hp, Wp);
    snap_flags / valid bool (B,) -> (out u8 (B, C, Hp, Wp), stats f32
    (B, 4), new baseline, new heatmap).  Padding frames (valid False) add
    nothing to the heatmap."""
    t = props.temporal_size
    hp, wp = raw.shape[-2], raw.shape[-1]
    dev = raw.device
    mask = valid_mask(hp, wp, h, w, device=dev)
    filtered = filtered_planes(raw, props)
    cur_all = temporal_median_windows(filtered, t)        # (B+1, Hp, Wp)
    prev, cur = cur_all[:-1], cur_all[1:]
    if props.method == DiPsMethod.OVERALL:
        new_baseline, baselines = capture_scan(baseline, cur, snap_flags)
        raw_diff = (baselines - cur) * INTENSITY_SCALE
    else:  # PER_FRAME: diff against the previous window's median
        new_baseline = baseline
        raw_diff = (prev - cur) * INTENSITY_SCALE
    raw_diff = raw_diff * mask
    # statistics and heatmap reduce over the analysis region; the maps keep
    # the full-frame diff
    dm = raw_diff if props.roi is None else raw_diff * valid_mask(
        hp, wp, h, w, props.roi_bounds(h, w), device=dev)
    stats = masked_stats(dm, props.analysis_pixels(h, w),
                         props.change_threshold)
    vw = torch.as_tensor(valid, device=dev).to(torch.float32)[:, None, None]
    heatmap = heatmap + (dm.abs() * vw).sum(dim=0)
    if props.out_channels == 0:
        out = torch.zeros((cur.shape[0], 0, hp, wp), dtype=torch.uint8,
                          device=dev)
        return out, stats, new_baseline, heatmap
    d = emphasize(raw_diff, props.filter, props.sigmoid_horizontal_scalar,
                  props.sensitivity)
    return (render_output(props, d, cur, snap_flags), stats, new_baseline,
            heatmap)


def absdiff_step(props: DiPsProperties, h: int, w: int, raw: torch.Tensor,
                 baseline_raw: torch.Tensor, snap_flags,
                 heatmap: torch.Tensor, valid
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """One tail-protocol step of the raw path: integer ``|ref - cur|`` per
    channel, byte-equal to ``cv2.absdiff``.

    raw u8 (T+B, 3, Hp, Wp), tail first; baseline_raw u8 (3, Hp, Wp);
    heatmap f32 (Hp, Wp); snap_flags / valid bool (B,) -> (out u8
    (B, C, Hp, Wp) with C = 3 (ABSDIFF), 1 (THRESHOLD) or 0 (STATS_ONLY),
    stats f32 (B, 4), new baseline, new heatmap).  OVERALL diffs against the
    pinned baseline; PER_FRAME against the frame before, the tail's last
    frame for the first new one."""
    t = props.temporal_size
    new = raw[t:]
    if props.method == DiPsMethod.OVERALL:
        new_baseline, baselines = capture_scan(baseline_raw, new, snap_flags)
    else:
        new_baseline, baselines = baseline_raw, raw[t - 1:-1]
    # zero padding is zero in both operands, so it adds to no reduction
    signed = baselines.to(torch.int16) - new.to(torch.int16)
    d16 = signed.abs()
    d_u8 = d16.to(torch.uint8)
    dmax = d_u8.amax(dim=1, keepdim=True)
    hp, wp = raw.shape[-2], raw.shape[-1]
    inv = _f32(1.0 / (3 * props.analysis_pixels(h, w) * 255))
    sf = signed.to(torch.float32)
    af = d16.to(torch.float32)
    changed = (dmax[:, 0] >= props.change_threshold).to(torch.float32)
    if props.roi is not None:
        rm = valid_mask(hp, wp, h, w, props.roi_bounds(h, w),
                        device=raw.device)
        sf, af, changed = sf * rm, af * rm, changed * rm
    stats = torch.stack([
        sf.sum(dim=(1, 2, 3)) * inv,
        af.sum(dim=(1, 2, 3)) * inv,
        af.amax(dim=(1, 2, 3)) * _f32(1 / 255.0),
        changed.sum(dim=(1, 2)),
    ], dim=-1)
    vw = torch.as_tensor(valid, device=raw.device).to(
        torch.float32)[:, None, None]
    heatmap = heatmap + (af.sum(dim=1) * _f32(1.0 / (3 * 255.0))
                         * vw).sum(dim=0)
    if props.out_channels == 0:
        out = d_u8[:, :0]
    elif props.output == OutputMode.THRESHOLD:
        out = torch.where(dmax >= props.change_threshold, 255, 0).to(
            torch.uint8)
    else:
        out = d_u8
    return out, stats, new_baseline, heatmap
