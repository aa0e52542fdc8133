"""Plain PyTorch stage functions of the DiPs pipeline.

Counterpart of ``dips_tpu/ops/reference.py``: the same padded geometry,
layouts and op order, written as plain functions on tensors.  The plain
twins of the two CUDA kernels (``ops/cuda_fused.py``) are built from these
stages, and the CPU tests hold each stage against its JAX original.

Filtering runs on the integer intensity scale [0, 510] carried in float32:
medians are selections, so they stay integer-exact, and the diff gets one
rounding (``diff_i * INTENSITY_SCALE``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..properties import ChromaFilter, DiPsFilter
from . import networks

#: Per-frame statistic order: mean_diff, mean_abs_diff, max_abs_diff,
#: changed_count (``dips_tpu/ops/oracle.py`` STAT_NAMES).
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


def make_layout_prep(layout: str, height: int, width: int, hp: int, wp: int):
    """Input-layout contract: returns ``(swap_rb, prep)`` where ``prep``
    maps uint8 (..., H, W, 3) frames to padded planar (..., 3, Hp, Wp) on
    the frames' device (permute + optional BGR flip + zero pad).  Layouts:
    "hwc" (RGB) and "hwc_bgr" (cv2's BGR order, swapped in the same copy).
    """
    if layout not in ("hwc", "hwc_bgr"):
        raise NotImplementedError(
            f"input_layout {layout!r}: the port takes 'hwc' or 'hwc_bgr'")
    swap = layout == "hwc_bgr"

    def prep(x: torch.Tensor, out: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
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


def spatial_median(planes: torch.Tensor, window: int) -> torch.Tensor:
    """(..., H, W) exact centered window median with zero out-of-bounds
    taps, through the column-factored plan of ``networks.window_median``."""
    if window <= 1:
        return planes
    p = window // 2
    h, w = planes.shape[-2], planes.shape[-1]
    padded = F.pad(planes, (p, p, p, p))

    def shift(x, dx):
        return x[..., p + dx:p + dx + w]

    vtaps = [padded[..., dy:dy + h, :] for dy in range(window)]
    return networks.window_median(vtaps, shift, torch.minimum, torch.maximum)


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
