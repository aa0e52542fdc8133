"""The least time a kernel launch could take on one NVIDIA H100, from the
shapes alone.

The least time is the larger of the bytes the launch must move over the
memory rate and the integer operations it must do over the INT32 rate.
Each input byte is read once and each output byte written once; the
carried state is read once and written once a launch.  The counts are over
the true frame region (H x W), not the padded planes the kernels keep, and
they are the same whatever implements the kernel.

Peaks (NVIDIA's H100 SXM data sheet, at the 700 W power limit):

* HBM3: 3.35 TB/s;
* INT32: 64 integer, compare, min or max results a clock on each SM
  (compute capability 9.0) x 132 SMs x 1.98 GHz boost = 16.73 Tops/s.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9

#: min / max / add operations a pixel, counted from the algorithm:
#: the intensity max(r, g, b) + min(r, g, b) is 2 + 2 + 1;
INTENSITY_OPS = 5
#: the exact 3 x 3 median from column-sorted taps: the column's 3-input
#: sort (3 compare-exchanges, 6 min/max, done once a pixel and shared by
#: the 3 windows that hold the column) and a 16-op merge of the three
#: sorted columns down to the median;
MEDIAN3X3_OPS = 6 + 16
#: the upper median of 4 (rank 2 of 4): 7 min/max;
TEMPORAL4_OPS = 7
#: the raw difference: 3 subtractions, 3 absolute values, 2 max and 1
#: compare a pixel.
RAW_OPS = 9


def raw_ring_launch(height: int, width: int, streams: int, batch: int,
                    channels: int = 3) -> dict:
    """ABSDIFF, OVERALL, ring-carry: one launch over ``streams`` streams of
    ``batch`` frames.  Bytes: the frames (3 a pixel), the uint8 baseline
    and previous frame in and out (2 x 3), the float32 heatmap in and out
    (2 x 4), the maps (``channels`` a pixel)."""
    px = streams * height * width
    nbytes = 3 * px * batch + 2 * 3 * px + 2 * 4 * px + channels * px * batch
    ops = RAW_OPS * px * batch
    return _least(nbytes, ops)


def median_ring_launch(height: int, width: int, streams: int, batch: int,
                       window: int, temporal: int, channels: int = 3
                       ) -> dict:
    """COLORIZE, OVERALL, ring-carry, exact 3 x 3 median, T = 4: one
    launch.  Bytes: the frames, the float32 state in and out (the heatmap
    and the baseline, 2 x 2 x 4, and the ring of T filtered planes,
    2 x T x 4), the maps."""
    if (window, temporal) != (3, 4):
        raise ValueError("operations are counted for w = 3, T = 4 only")
    px = streams * height * width
    nbytes = (3 * px * batch + 4 * px * (2 + 2 + 2 * temporal)
              + channels * px * batch)
    ops = px * batch * (INTENSITY_OPS + MEDIAN3X3_OPS + TEMPORAL4_OPS)
    return _least(nbytes, ops)


def _least(nbytes: int, ops: int) -> dict:
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return {"bytes": nbytes, "ops": ops, "least_s": max(by_bytes, by_ops),
            "bound": "bytes" if by_bytes >= by_ops else "operations"}
