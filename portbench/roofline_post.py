"""The least time of the post-analysis transforms on one NVIDIA H100,
from the shapes alone.

The FFT denoise takes a forward and an inverse transform of each map
plane over the true H x W region.  Counted as the least each transform
must move, per pixel of a plane: the forward transform of the real
float32 plane reads it (4 bytes) and writes the Hermitian half of its
complex64 spectrum (W/2 + 1 of W columns: 4 bytes); the inverse reads the
whole masked spectrum (8) and writes a complex64 image (8), since the kept
square [-r, r) is one bin off symmetric, so the masked spectrum is not
Hermitian and its image not real: 24 bytes.  The mask, the magnitude and
the rounding are elementwise work outside the transforms, not counted
here.  The float32 operations (about 5 N log2 N a complex transform, 2 x
1.9 G a 4K plane, 92 G for a 4K batch of 48 planes, 1.4 ms at 67
TFLOP/s) stay below the bytes' time, so the transforms are bound by
bytes (``roofline.HBM_BYTES_PER_S``).
"""

from __future__ import annotations

from .roofline import HBM_BYTES_PER_S

#: forward real-to-complex: 4 read + 4 written (the half spectrum);
#: inverse complex-to-complex: 8 read + 8 written
FFT_BYTES_PER_PIXEL = 4 + 4 + 8 + 8


def denoise_transforms(height: int, width: int, planes: int) -> dict:
    """The transforms of ``planes`` H x W planes: bytes and least time."""
    nbytes = FFT_BYTES_PER_PIXEL * height * width * planes
    return {"bytes": nbytes, "least_s": nbytes / HBM_BYTES_PER_S,
            "bound": "bytes"}
