"""The plain reference of the post-analysis (the FFT denoise of
``image_denoise.py`` and the real DFT of a series) and of the on-card
decimation (the k x k box mean of ``--downscale K``), in plain PyTorch
on the CPU.

Written from the recipe, not from the port: it imports nothing of
``dips_tpu_torch`` (and no JAX), so tests hold the port's
``ops/analysis.py``, ``DiPsEngine(denoise_radius=)`` and the engines'
``downscale`` against it.  The maps it denoises come from the
repository's oracle of the pipeline (``ops/oracle.py``), as do the maps of
the frames it pools.

* :func:`denoise`: each uint8 map plane in float32: ``fft2``,
  ``fftshift``, keep the centred 2r x 2r square (shifted rows and
  columns c - r .. c + r - 1), ``ifftshift``, ``ifft2``, the magnitude,
  rounded half to even and clamped to uint8 (upstream DiPs
  ``test_scripts/image_denoise.py:13-30``; r = 75 at ``:22``).
* :func:`rdft`: the real DFT of a series (the CLI's ``--dft-json`` of the
  per-frame mean-|diff| statistic), magnitude and phase, in float64.
* :func:`pool_frames`: the k x k box mean of uint8 frames, as
  ``docs/OPERATIONS.md`` states ``--downscale K``: each channel's exact
  integer sum over the block, times float32(1/k^2), rounded half to even.

``precision="bf16"`` is the control: the forward spectrum is rounded to
bfloat16 (real and imaginary parts, ties to even), the next precision
below the float32 the configuration states.  TF32 is turned off where a
function runs, as a float32 reference on a card would need.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

PRECISIONS = ("full", "bf16")


def _float32_exact() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _check(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")


def bf16_complex(z: torch.Tensor) -> torch.Tensor:
    """complex64 -> the nearest bfloat16 real and imaginary parts, as
    complex64."""
    def r(x):
        return x.to(torch.bfloat16).to(torch.float32)
    return torch.complex(r(z.real), r(z.imag))


def denoise_plane(plane: torch.Tensor, radius: int,
                  precision: str = "full") -> torch.Tensor:
    """One (H, W) plane, any real dtype -> the float32 magnitude of the
    low-passed plane (before rounding)."""
    _check(precision)
    _float32_exact()
    x = plane.to(device="cpu", dtype=torch.float32)
    h, w = x.shape
    spec = torch.fft.fft2(x)
    if precision == "bf16":
        spec = bf16_complex(spec)
    shifted = torch.fft.fftshift(spec)
    keep = torch.zeros((h, w), dtype=torch.bool)
    ch, cw = h // 2, w // 2
    keep[max(ch - radius, 0):ch + radius, max(cw - radius, 0):cw + radius] \
        = True
    shifted = torch.where(keep, shifted, torch.zeros_like(shifted))
    return torch.fft.ifft2(torch.fft.ifftshift(shifted)).abs()


def denoise(maps, radius: int, precision: str = "full") -> np.ndarray:
    """uint8 maps (..., H, W, C) -> uint8 (..., H, W, C), each plane
    through :func:`denoise_plane`, rounded half to even, clamped."""
    m = np.asarray(maps)
    if m.dtype != np.uint8:
        raise TypeError(f"maps must be uint8, got {m.dtype}")
    out = np.empty_like(m)
    flat_in = m.reshape((-1,) + m.shape[-3:])
    flat_out = out.reshape(flat_in.shape)
    for i in range(flat_in.shape[0]):
        for c in range(m.shape[-1]):
            mag = denoise_plane(torch.from_numpy(
                np.ascontiguousarray(flat_in[i, :, :, c])), radius, precision)
            flat_out[i, :, :, c] = torch.round(mag).clamp(0, 255).to(
                torch.uint8).numpy()
    return out


def rdft(series, precision: str = "full") -> Tuple[np.ndarray, np.ndarray]:
    """Real DFT of a series (N,) -> (magnitude, phase), (N//2 + 1,)
    float64."""
    _check(precision)
    _float32_exact()
    x = torch.as_tensor(np.asarray(series, np.float64))
    spec = torch.fft.rfft(x)
    if precision == "bf16":
        spec = bf16_complex(spec.to(torch.complex64)).to(torch.complex128)
    return spec.abs().numpy(), spec.angle().numpy()


def pool_frames(frames, k: int) -> np.ndarray:
    """uint8 frames (..., H*k, W*k, C) -> (..., H, W, C): each k x k
    block's exact integer sum a channel (int32), times float32(1/k^2),
    rounded half to even, in float32 on the CPU."""
    _float32_exact()
    x = torch.from_numpy(np.ascontiguousarray(frames))
    if x.dtype != torch.uint8:
        raise TypeError(f"frames must be uint8, got {x.dtype}")
    *lead, hk, wk, c = x.shape
    if k < 1 or hk % k or wk % k:
        raise ValueError(f"k={k} does not divide {hk}x{wk}")
    blocks = x.to(torch.int32).reshape(*lead, hk // k, k, wk // k, k, c)
    sums = blocks.sum(dim=(-4, -2), dtype=torch.int32)
    inv = torch.tensor(1.0 / (k * k), dtype=torch.float32)
    return torch.round(sums.to(torch.float32) * inv).to(torch.uint8).numpy()
