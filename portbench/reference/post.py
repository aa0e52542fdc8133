"""The post-analysis in plain NumPy: the FFT denoise of a map and the real
DFT of a series.

A frozen copy of the port's plain reference of the post-analysis, the
recipe of upstream DiPs ``test_scripts/image_denoise.py:13-30``: each
uint8 map plane in float32, ``fft2``, ``fftshift``, keep the centred
2r x 2r square (shifted rows and columns c - r .. c + r - 1, r = 75 at
``:22``), ``ifftshift``, ``ifft2``, the magnitude, rounded half to even
and clamped to uint8.  The transforms' results are held in complex64
(what NumPy 2 computes for float32 input; an older NumPy's complex128
results are rounded to it).  The DFT is the CLI's ``--dft-json``: the
real DFT of the per-frame mean-|diff| series, here in float64.

``precision="bf16"`` is the control: the forward spectrum's real and
imaginary parts are rounded to bfloat16.  It imports nothing of the
program under test.
"""

from __future__ import annotations

import numpy as np

from .dips import _bf16


def _spectrum(plane: np.ndarray, precision: str) -> np.ndarray:
    spec = np.fft.fft2(plane.astype(np.float32)).astype(np.complex64)
    if precision == "bf16":
        spec = (_bf16(spec.real) + 1j * _bf16(spec.imag)).astype(
            np.complex64)
    return spec


def denoise_plane(plane: np.ndarray, radius: int, precision: str = "full"
                  ) -> np.ndarray:
    """One uint8 (H, W) plane -> the denoised uint8 plane."""
    if precision not in ("full", "bf16"):
        raise ValueError(f"no denoise reference at {precision!r}")
    h, w = plane.shape
    shifted = np.fft.fftshift(_spectrum(plane, precision))
    ch, cw = h // 2, w // 2
    r0, c0 = max(ch - radius, 0), max(cw - radius, 0)
    shifted[:r0] = 0
    shifted[ch + radius:] = 0
    shifted[:, :c0] = 0
    shifted[:, cw + radius:] = 0
    back = np.fft.ifft2(np.fft.ifftshift(shifted)).astype(np.complex64)
    return np.clip(np.rint(np.abs(back)), 0, 255).astype(np.uint8)


def rdft_magnitude(series) -> np.ndarray:
    """|rfft| of a series (N,), float64: (N//2 + 1,)."""
    return np.abs(np.fft.rfft(np.asarray(series, np.float64)))
