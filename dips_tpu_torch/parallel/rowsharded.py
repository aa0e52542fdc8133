"""Row-sharded single-stream processing: spatial parallelism over a mesh.

Counterpart of ``dips_tpu/parallel/rowsharded.py``.  One enormous stream
(an 8K-class capture) is split spatially: each cell of a "rows" mesh owns a
horizontal slab of every frame, and the spatial median's halo rows come
from the neighbouring cells before filtering.  Everything else (temporal
median, baseline capture, diff, emphasis, statistics) is row-local, and the
per-frame statistics are summed over the cells.

The steps here are the grid steps of ``grid2d.py`` with one stream and no
stream axis; see there for how a step loops over the cells and for the two
backends (``"kernel"``: the slab kernels, CUDA on a card and the plain twins
on the CPU, slabs 8-row aligned; ``"plain"``: the plain twins on slabs of
any height, CPU tensors and the tail protocol only).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import reference
from ..properties import DiPsProperties, OutputMode
from .mesh import Mesh

_RAW_MODES = (OutputMode.ABSDIFF, OutputMode.THRESHOLD,
              OutputMode.STATS_ONLY)


def _raw_slab_bounds(props: DiPsProperties, h: int, w: int, hs: int,
                     row_index: int):
    """Slab-local roi row window [lo, hi) of row shard ``row_index`` for a
    raw slab (no halo extension, so no offset: contrast
    ``grid2d._slab_row_bounds``)."""
    row0 = row_index * hs
    y0, _, y1, _ = props.roi_bounds(h, w)
    return min(max(y0 - row0, 0), hs), min(max(y1 - row0, 0), hs)


def _rows_mesh(mesh: Mesh, axis: str) -> Mesh:
    """The cells of ``mesh`` along ``axis`` as a (1, R) grid."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
    if len(mesh.axis_names) != 1:
        raise ValueError("row sharding takes a 1-D mesh over its rows axis")
    return Mesh(mesh.devices.reshape(1, -1), ("stream", "rows"))


def _check_aligned(h: int, w: int, n: int) -> None:
    from .grid2d import slab_rows_ok
    hp = reference.pad_geometry(h, w)[0]
    if not slab_rows_ok(hp, n):
        raise ValueError(
            f"kernel row sharding needs 8-row-aligned slabs: padded "
            f"height {hp} / {n} shards")


def make_rowsharded_step(props: DiPsProperties, h: int, w: int, mesh: Mesh,
                         axis: str = "rows", backend=None,
                         slab_impl: str = "bands"):
    """Single-stream tail-protocol step with the H axis split over
    ``mesh``.

    Maps raw u8 (T+B, 3, Hp, Wp), baseline (Hp, Wp) f32 (median modes) or
    (3, Hp, Wp) u8 (raw modes), flags (B,), heatmap (Hp, Wp), valid (B,)
    -> (out u8 (B, C, Hp, Wp), stats (B, 4), baseline, heatmap); baseline
    and heatmap are updated in place and returned.  Hp must divide evenly
    by the mesh size.

    Median modes exchange the spatial stencil's halo rows between
    neighbouring cells; raw modes have no stencil, so each cell diffs its
    slab independently and only the statistics are combined.
    ``backend`` / ``slab_impl``: as in ``grid2d.make_grid_step``."""
    from .grid2d import _check_slab_impl, make_grid_step
    _check_slab_impl(slab_impl)  # for every output mode: a typo must fail
    grid = _rows_mesh(mesh, axis)
    if backend == "kernel":
        _check_aligned(h, w, grid.shape["rows"])
    step = make_grid_step(props, h, w, grid, backend=backend,
                          slab_impl=slab_impl)

    def one(raw, baseline, flags, heatmap, valid):
        out, stats, *_ = step(raw[None], baseline[None], _row(flags),
                              heatmap[None], _row(valid))
        return out[0], stats[0], baseline, heatmap
    return one


def _row(x) -> np.ndarray:
    """A (B,) flag vector as the (1, B) rows of the grid steps."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x)[None]


def make_rowsharded_ring_step(props: DiPsProperties, h: int, w: int,
                              mesh: Mesh, axis: str = "rows",
                              slab_impl: str = "bands"):
    """Ring-carry twin of :func:`make_rowsharded_step` (slab kernels only):
    the filtered ring, PER_FRAME's previous plane, baseline and heatmap
    are carried state split over ``axis``; the input is only the B new
    frames.

    Median modes map raw u8 (B, 3, Hp, Wp), ring f32 (T, Hp, Wp), prev /
    baseline / heatmap f32 (Hp, Wp), flags / valid (B,), offset, seed ->
    (out, stats (B, 4), ring, prev, baseline, heatmap).  Raw modes map
    raw, prev u8 (3, Hp, Wp), baseline u8 (3, Hp, Wp), flags, heatmap,
    valid, seed -> (out, stats, prev, baseline, heatmap).  State is
    updated in place and returned.  Slabs must be 8-row aligned."""
    from .grid2d import _check_slab_impl, make_grid_ring_step
    raw_mode = props.output in _RAW_MODES
    if not raw_mode:
        _check_slab_impl(slab_impl)
    grid = _rows_mesh(mesh, axis)
    _check_aligned(h, w, grid.shape["rows"])
    step = make_grid_ring_step(props, h, w, grid, slab_impl=slab_impl
                               if not raw_mode else "bands")
    if raw_mode:
        def one(raw, prev, baseline, flags, heatmap, valid, seed):
            out, stats, *_ = step(raw[None], prev[None], baseline[None],
                                  _row(flags), heatmap[None], _row(valid),
                                  [int(seed)])
            return out[0], stats[0], prev, baseline, heatmap
        return one

    def one(raw, ring, prev, baseline, flags, heatmap, valid, offset, seed):
        out, stats, *_ = step(raw[None], ring[None], prev[None],
                              baseline[None], _row(flags), heatmap[None],
                              _row(valid), [int(offset)], [int(seed)])
        return out[0], stats[0], ring, prev, baseline, heatmap
    return one
