"""The ring-carry device steps: CUDA kernels and their plain twins.

Counterpart of the ring-carry half of ``dips_tpu/ops/pallas_fused.py``:

* :func:`absdiff_step_ring` (raw ABSDIFF / THRESHOLD / STATS_ONLY), kernel
  ``csrc/raw_ring.cu``;
* :func:`batch_step_ring` (median pipeline: COLORIZE / GRAYSCALE / no
  maps), kernel ``csrc/median_ring.cu``.

Both take the JAX functions' arguments in the same order and return the
same tuples.  A wrapper given CUDA tensors launches its kernel (or raises);
given CPU tensors it runs the plain PyTorch twin (``*_plain``), which
mirrors the Pallas body frame by frame.  Nothing falls back from the card
to the plain version.

Carried state is updated in place: the kernels read ring / prev / baseline
/ heatmap once, keep them in registers for the batch, and write them back
into the same tensors, which the functions also return (the JAX functions
donate the same buffers).  The plain twins update in place too.

Statistics leave the kernels as per-(frame, tile) partials; the final
reduction over tiles (the counterpart of ``_reduce_stats``) runs here in
plain torch.  The raw path keeps its partials in integers and sums them in
int64 before the one float conversion.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ..properties import (ChromaFilter, DiPsFilter, DiPsMethod,
                          DiPsProperties, OutputMode)
from . import reference as ref

_CHROMA_CODE = {ChromaFilter.ALL: 0, ChromaFilter.RED: 1,
                ChromaFilter.GREEN: 2, ChromaFilter.BLUE: 3}
_FILTER_CODE = {DiPsFilter.SIGMOID: 0, DiPsFilter.INVERSE_SIGMOID: 1,
                DiPsFilter.UNFILTERED: 2}


def _f32(x: float) -> float:
    return float(np.float32(x))


def _change_thr(props: DiPsProperties) -> float:
    """float32 ``change_threshold * (1/255)`` (a multiply, as the Pallas
    body computes it)."""
    return _f32(_f32(props.change_threshold) * _f32(1 / 255.))


def _stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _flag_list(x) -> list:
    if isinstance(x, torch.Tensor):
        return [bool(v) for v in x.tolist()]
    return [bool(v) for v in np.asarray(x).tolist()]


def _check_cuda(name: str, device: torch.device, **tensors) -> None:
    """Every tensor on ``device``, contiguous and 16-byte aligned."""
    for key, (t, dtype, shape) in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {key} must be a tensor")
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, raw on "
                             f"{device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} dtype {t.dtype} != {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {key} shape {tuple(t.shape)} != "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")


def _flags_i32(x, b: int, device: torch.device, name: str, key: str
               ) -> torch.Tensor:
    t = torch.as_tensor(x)
    if tuple(t.shape) != (b,):
        raise ValueError(f"{name}: {key} shape {tuple(t.shape)} != ({b},)")
    return t.to(device=device, dtype=torch.int32).contiguous()


def _route(name: str, raw: torch.Tensor) -> bool:
    """True: launch the kernel (CUDA tensors); False: the plain twin (CPU
    tensors).  Any other device raises."""
    if raw.is_cuda:
        return True
    if raw.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain path for {raw.device}")


# ---------------------------------------------------------------------------
# Final reduction of the statistic partials (counterpart of _reduce_stats)
# ---------------------------------------------------------------------------

def reduce_raw_stats(parts: torch.Tensor, props: DiPsProperties, h: int,
                     w: int) -> torch.Tensor:
    """Integer partials (B, n_tiles, 4) -> (B, 4) float32 stats: channel-
    mean signed and abs diff on [-1, 1], max |diff| / 255, changed count.
    Sums are taken in int64 and converted to float32 once."""
    p = parts.to(torch.int64)
    inv = _f32(1.0 / (3 * props.analysis_pixels(h, w) * 255))
    return torch.stack([
        p[..., 0].sum(1).to(torch.float32) * inv,
        p[..., 1].sum(1).to(torch.float32) * inv,
        p[..., 2].amax(1).to(torch.float32) * _f32(1 / 255.0),
        p[..., 3].sum(1).to(torch.float32),
    ], dim=-1)


def reduce_median_stats(parts: torch.Tensor, props: DiPsProperties, h: int,
                        w: int) -> torch.Tensor:
    """float32 partials (B, n_tiles, 4) -> (B, 4) stats: mean diff, mean
    |diff|, max |diff|, changed count."""
    inv = _f32(1.0 / props.analysis_pixels(h, w))
    return torch.stack([
        parts[..., 0].sum(1) * inv,
        parts[..., 1].sum(1) * inv,
        parts[..., 2].amax(1),
        parts[..., 3].sum(1),
    ], dim=-1)


# ---------------------------------------------------------------------------
# Kernel 1: raw ring step
# ---------------------------------------------------------------------------

def _raw_out_mode(props: DiPsProperties) -> Tuple[int, int]:
    """(kernel out_mode, channels): 0 = no map, 1 = ABSDIFF, 2 =
    THRESHOLD."""
    if props.out_channels == 0:
        return 0, 0
    if props.output == OutputMode.THRESHOLD:
        return 2, 1
    return 1, 3


def absdiff_step_ring_plain(props: DiPsProperties, h: int, w: int,
                            raw: torch.Tensor, prev: torch.Tensor,
                            baseline_raw: torch.Tensor, snap_flags,
                            heatmap: torch.Tensor, valid, seed):
    """Plain twin of :func:`absdiff_step_ring`, frame by frame as the
    Pallas body runs it."""
    overall = props.method == DiPsMethod.OVERALL
    b = raw.shape[0]
    hp, wp = raw.shape[-2], raw.shape[-1]
    mode, c = _raw_out_mode(props)
    thr = props.change_threshold
    flags, vals = _flag_list(snap_flags), _flag_list(valid)
    rm = None
    if props.roi is not None:
        rm = ref.valid_mask(hp, wp, h, w, props.roi_bounds(h, w),
                            device=raw.device).to(torch.int32)
    refi = (baseline_raw if overall else prev).to(torch.int32)
    if not overall and int(seed):
        refi = raw[0].to(torch.int32)
    out = torch.empty((b, c, hp, wp), dtype=torch.uint8, device=raw.device)
    parts = torch.empty((b, 1, 4), dtype=torch.int64, device=raw.device)
    heat = heatmap.clone()
    scale = _f32(1.0 / (3 * 255.0))
    for m in range(b):
        cur = raw[m].to(torch.int32)
        if overall and flags[m] and vals[m]:
            refi = cur
        sg = refi - cur
        ad = sg.abs()
        dmax = ad.amax(0)
        if not overall and vals[m]:
            refi = cur
        if rm is None:
            sg_m, ad_m, dmax_m = sg, ad, dmax
        else:
            sg_m, ad_m, dmax_m = sg * rm, ad * rm, dmax * rm
        parts[m, 0, 0] = sg_m.sum(dtype=torch.int64)
        parts[m, 0, 1] = ad_m.sum(dtype=torch.int64)
        parts[m, 0, 2] = dmax_m.amax()
        parts[m, 0, 3] = (dmax_m >= thr).sum(dtype=torch.int64)
        heat = heat + (ad_m.sum(0).to(torch.float32) * scale) \
            * float(vals[m])
        if mode == 1:
            out[m] = ad.to(torch.uint8)
        elif mode == 2:
            out[m, 0] = torch.where(dmax >= thr, 255, 0).to(torch.uint8)
    if overall:
        baseline_raw.copy_(refi.to(torch.uint8))
    else:
        prev.copy_(refi.to(torch.uint8))
    heatmap.copy_(heat)
    return (out, reduce_raw_stats(parts, props, h, w), prev, baseline_raw,
            heatmap)


def absdiff_step_ring(props: DiPsProperties, h: int, w: int,
                      raw: torch.Tensor, prev: torch.Tensor,
                      baseline_raw: torch.Tensor, snap_flags,
                      heatmap: torch.Tensor, valid, seed):
    """Raw ring-carry step.

    raw u8 (B, 3, Hp, Wp), prev / baseline_raw u8 (3, Hp, Wp), heatmap f32
    (Hp, Wp), snap_flags / valid (B,), seed int ->
    (out u8 (B, C, Hp, Wp), stats f32 (B, 4), prev, baseline, heatmap),
    C = 3 (ABSDIFF), 1 (THRESHOLD) or 0 (no map).  State is updated in
    place and returned."""
    name = "absdiff_step_ring"
    if not _route(name, raw):
        return absdiff_step_ring_plain(props, h, w, raw, prev, baseline_raw,
                                       snap_flags, heatmap, valid, seed)
    from . import _build
    b, _, hp, wp = raw.shape
    dev = raw.device
    _check_cuda(name, dev, raw=(raw, torch.uint8, (b, 3, hp, wp)),
                prev=(prev, torch.uint8, (3, hp, wp)),
                baseline_raw=(baseline_raw, torch.uint8, (3, hp, wp)),
                heatmap=(heatmap, torch.float32, (hp, wp)))
    if wp % 16:
        raise ValueError(f"{name}: Wp={wp} is not a multiple of 16")
    flags = _flags_i32(snap_flags, b, dev, name, "snap_flags")
    vals = _flags_i32(valid, b, dev, name, "valid")
    mode, c = _raw_out_mode(props)
    n_tiles = -(-(hp * wp // 16) // 256)
    out = torch.empty((b, c, hp, wp), dtype=torch.uint8, device=dev)
    parts = torch.empty((b, n_tiles, 4), dtype=torch.int32, device=dev)
    y0, x0, y1, x1 = ((0, 0, hp, wp) if props.roi is None
                      else props.roi_bounds(h, w))
    rc = _build.lib().dips_raw_ring(
        _ptr(raw), _ptr(prev), _ptr(baseline_raw), _ptr(heatmap),
        _ptr(out), _ptr(parts), _ptr(flags), _ptr(vals), b, hp, wp,
        int(props.method == DiPsMethod.OVERALL), mode,
        props.change_threshold, int(seed != 0), y0, x0, y1, x1,
        _f32(1.0 / (3 * 255.0)), _stream_ptr(dev))
    _build.check(rc, name)
    absdiff_step_ring.launches += 1
    return (out, reduce_raw_stats(parts, props, h, w), prev, baseline_raw,
            heatmap)


absdiff_step_ring.launches = 0


# ---------------------------------------------------------------------------
# Kernel 2: median ring step
# ---------------------------------------------------------------------------

def _median_out_mode(props: DiPsProperties) -> Tuple[int, int]:
    """(kernel out_mode, channels): 0 = no map, 1 = COLORIZE, 2 =
    GRAYSCALE."""
    if props.out_channels == 0:
        return 0, 0
    if props.output == OutputMode.COLORIZE:
        return 1, 3
    return 2, 1


def _check_median_props(name: str, props: DiPsProperties) -> None:
    if props.output not in (OutputMode.COLORIZE, OutputMode.GRAYSCALE):
        raise ValueError(f"{name}: {props.output} is a raw mode "
                         f"(absdiff_step_ring)")


def batch_step_ring_plain(props: DiPsProperties, h: int, w: int,
                          raw: torch.Tensor, ring: torch.Tensor,
                          prev: torch.Tensor, baseline: torch.Tensor,
                          snap_flags, heatmap: torch.Tensor, valid, offset,
                          seed):
    """Plain twin of :func:`batch_step_ring`, frame by frame as the Pallas
    body runs it (``approx_median`` and ``quirk_compat`` are not part of
    this slice and raise)."""
    name = "batch_step_ring"
    _check_median_props(name, props)
    if props.approx_median or props.quirk_compat:
        raise NotImplementedError(
            f"{name}: approx_median and quirk_compat are not ported yet")
    overall = props.method == DiPsMethod.OVERALL
    t = props.temporal_size
    b = raw.shape[0]
    hp, wp = raw.shape[-2], raw.shape[-1]
    mode, c = _median_out_mode(props)
    flags, vals = _flag_list(snap_flags), _flag_list(valid)
    off, seed = int(offset) % t, int(seed)
    mask = ref.valid_mask(hp, wp, h, w, props.roi_bounds(h, w),
                          device=raw.device)
    thr = _change_thr(props)
    phis = ref.spatial_median(ref.intensity_planar(raw, props.chroma),
                              props.window_size)
    slots = [ring[k].clone() for k in range(t)]
    pv, base, heat = prev.clone(), baseline.clone(), heatmap.clone()
    out = torch.empty((b, c, hp, wp), dtype=torch.uint8, device=raw.device)
    parts = torch.empty((b, 1, 4), dtype=torch.float32, device=raw.device)
    for m in range(b):
        phi = phis[m]
        if vals[m]:
            slots[(off + m) % t] = phi
        if m == 0 and seed:
            slots = [phi] * t
            if not overall:
                pv = phi
        cur = ref.temporal_median(slots)
        capture = overall and flags[m] and vals[m]
        if overall:
            if capture:
                base = cur
            diff_i = base - cur
        else:
            diff_i = pv - cur
            if vals[m]:
                pv = cur
        rd = diff_i * ref.INTENSITY_SCALE
        dm = rd * mask
        am = dm.abs()
        parts[m, 0, 0] = dm.sum()
        parts[m, 0, 1] = am.sum()
        parts[m, 0, 2] = am.amax()
        parts[m, 0, 3] = (am >= thr).to(torch.float32).sum()
        heat = heat + am * float(vals[m])
        if mode == 0:
            continue
        if capture:
            out[m] = ref.quantize_u8(cur * ref.INTENSITY_SCALE)
            continue
        d = ref.emphasize(rd, props.filter, props.sigmoid_horizontal_scalar,
                          props.sensitivity)
        if mode == 1:
            sa = d.abs()
            hi8 = ref.quantize_u8(0.5 + sa * 0.5)
            lo8 = ref.quantize_u8(0.5 - sa * 0.5)
            neg = d < 0
            out[m, 0] = torch.where(neg, hi8, lo8)
            out[m, 1] = torch.where(neg, lo8, hi8)
            out[m, 2] = lo8
        else:
            out[m, 0] = ref.quantize_u8(0.5 - d)
    for k in range(t):
        ring[k].copy_(slots[k])
    if overall:
        baseline.copy_(base)
    else:
        prev.copy_(pv)
    heatmap.copy_(heat)
    return (out, reduce_median_stats(parts, props, h, w), ring, prev,
            baseline, heatmap)


def batch_step_ring(props: DiPsProperties, h: int, w: int,
                    raw: torch.Tensor, ring: torch.Tensor,
                    prev: torch.Tensor, baseline: torch.Tensor, snap_flags,
                    heatmap: torch.Tensor, valid, offset, seed):
    """Median ring-carry step.

    raw u8 (B, 3, Hp, Wp), ring f32 (T, Hp, Wp), prev / baseline / heatmap
    f32 (Hp, Wp), snap_flags / valid (B,), offset / seed int ->
    (out u8 (B, C, Hp, Wp), stats f32 (B, 4), ring, prev, baseline,
    heatmap), C = 3 (COLORIZE), 1 (GRAYSCALE) or 0 (``emit_maps=False``).
    State is updated in place and returned."""
    name = "batch_step_ring"
    if not _route(name, raw):
        return batch_step_ring_plain(props, h, w, raw, ring, prev, baseline,
                                     snap_flags, heatmap, valid, offset,
                                     seed)
    _check_median_props(name, props)
    if props.approx_median or props.quirk_compat:
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no approx_median or quirk_compat "
            f"mode yet")
    from . import _build
    t = props.temporal_size
    b, _, hp, wp = raw.shape
    dev = raw.device
    _check_cuda(name, dev, raw=(raw, torch.uint8, (b, 3, hp, wp)),
                ring=(ring, torch.float32, (t, hp, wp)),
                prev=(prev, torch.float32, (hp, wp)),
                baseline=(baseline, torch.float32, (hp, wp)),
                heatmap=(heatmap, torch.float32, (hp, wp)))
    if hp % 8 or wp % 32:
        raise ValueError(f"{name}: padded geometry {hp}x{wp} must be a "
                         f"multiple of 8 x 32")
    flags = _flags_i32(snap_flags, b, dev, name, "snap_flags")
    vals = _flags_i32(valid, b, dev, name, "valid")
    mode, c = _median_out_mode(props)
    n_tiles = (hp // 8) * (wp // 32)
    out = torch.empty((b, c, hp, wp), dtype=torch.uint8, device=dev)
    parts = torch.empty((b, n_tiles, 4), dtype=torch.float32, device=dev)
    y0, x0, y1, x1 = props.roi_bounds(h, w)
    rc = _build.lib().dips_median_ring(
        _ptr(raw), _ptr(ring), _ptr(prev), _ptr(baseline), _ptr(heatmap),
        _ptr(out), _ptr(parts), _ptr(flags), _ptr(vals), b, hp, wp, t,
        props.window_size, int(offset) % t, int(seed != 0),
        int(props.method == DiPsMethod.OVERALL), mode,
        _CHROMA_CODE[props.chroma], _FILTER_CODE[props.filter],
        _f32(props.sigmoid_horizontal_scalar), _f32(props.sensitivity),
        _f32(-0.5 + ref.INV_SIGMOID_EPS), _f32(0.5 - ref.INV_SIGMOID_EPS),
        ref.INTENSITY_SCALE, _change_thr(props), y0, x0, y1, x1, _stream_ptr(dev))
    _build.check(rc, name)
    batch_step_ring.launches += 1
    return (out, reduce_median_stats(parts, props, h, w), ring, prev,
            baseline, heatmap)


batch_step_ring.launches = 0


def reset_launch_counts() -> None:
    """Set both kernels' launch counts to 0."""
    absdiff_step_ring.launches = 0
    batch_step_ring.launches = 0


def launch_counts() -> dict:
    return {"absdiff_step_ring": absdiff_step_ring.launches,
            "batch_step_ring": batch_step_ring.launches}
