"""The least time of a launch of the on-card decimation (the k x k box
mean of a downscaled engine's layout prep) on one NVIDIA H100, from the
shapes alone.

Per output pixel of a frame (H x W, the analysis size): the launch reads
the k x k input pixels, 3 bytes each, and writes the planar output,
3 bytes; per channel it does k^2 - 1 adds, a multiply and a rounding.
The count is the same whatever implements it.  The peaks are
``roofline.py``'s; at k = 2 the bytes bound it by far (15 bytes and 15
operations a pixel against a rate of operations five times that of the
bytes).
"""

from __future__ import annotations

from .roofline import HBM_BYTES_PER_S, INT32_OPS_PER_S


def pool_launch(height: int, width: int, k: int, frames: int) -> dict:
    """One launch over ``frames`` frames of (height*k, width*k, 3):
    bytes, operations and least time."""
    px = frames * height * width
    nbytes = 3 * k * k * px + 3 * px
    ops = 3 * (k * k - 1 + 2) * px
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return {"bytes": nbytes, "ops": ops, "least_s": max(by_bytes, by_ops),
            "bound": "bytes" if by_bytes >= by_ops else "operations"}
