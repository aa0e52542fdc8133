"""Composite 2-D sharding: streams x rows.

Counterpart of ``dips_tpu/parallel/grid2d.py``.  A ``Mesh((S, R),
("stream", "rows"))`` gives each cell a horizontal slab of one subset of
the streams -- the deployment shape for many huge streams.  Everything
after the spatial median is row-local, so a slab's owned rows come out
bit-identical to the full-height kernel's as long as the stencil's taps
just above and below the slab read the neighbouring slabs' raw rows.

Median modes run the stacked slab kernels (``ops/cuda_fused.py`` with
``row_bounds`` / ``bands``): a cell folds its local streams' slabs along
the row axis of ONE launch and takes the 8 raw rows above and below each
slab from its row neighbours -- by default as two thin band inputs in
OWNED coordinates (``slab_impl="bands"``), or concatenated around the slab
(the halo-EXTENDED construction, ``slab_impl="extended"``), whose carried
state is zero-padded in and sliced out every batch.  Raw modes have no
stencil: no halo, no bands; each cell diffs its slabs and only the
statistics cross cells.  The CUDA kernels need 8-row-aligned slabs; the
plain twins take any slab height, so ``backend="plain"`` (CPU tensors only,
tail protocol; the JAX package's ``backend="xla"``) runs the same cells on
slabs that are not aligned.  On a card such slabs raise: nothing there runs
the plain version.

PyTorch drives every device from one process, so a step here loops over
the mesh's cells.  **The cell is the unit**: its launch sees only its own
slab tensors (on its own device) plus its bands; the band exchange
(``ppermute``) is a copy between neighbouring cells' tensors (``.to`` the
receiver's device), ``psum`` / ``pmax`` combine the cells' partial
statistics.  A mesh over several cards and a mesh that names one card in
every cell (``grid_mesh(S, R, devices=["cuda:0"] * n)``, see ``mesh.py``)
take the same path: every launch is made on its tensors' own card
(``cuda_fused._launch_median`` / ``_launch_raw``).  Only the one-card mesh
has run so far.

Two levels:

* ``run_grid_step`` / ``run_grid_ring_step`` work on cells: nested lists of
  row-stacked tensors (``mesh.Layout``), carried state updated in place.
  ``MultiStreamEngine`` keeps its state in cells and calls these.
* ``make_grid_step`` / ``make_grid_ring_step`` have the JAX functions'
  call signatures: whole stream-leading tensors in and out; they scatter,
  run the cells and gather, and also write the new state into the state
  arguments.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import cuda_fused
from ..ops.reference import BAND_ROWS, pad_geometry
from ..properties import DiPsProperties, OutputMode
from .mesh import Layout, Mesh, visible_devices

#: rows added above AND below each slab by the extended construction: one
#: 8-row block keeps every section 8-aligned and covers the widest halo
_EXT = BAND_ROWS

_RAW_MODES = (OutputMode.ABSDIFF, OutputMode.THRESHOLD,
              OutputMode.STATS_ONLY)


def grid_mesh(n_streams_axis: int, n_rows_axis: int,
              devices=None) -> Mesh:
    """A (stream, rows) 2-D mesh over the first S*R devices.

    ``devices`` defaults to the visible cards; fewer than S*R raises, as
    the JAX function does.  Pass ``devices=`` explicitly to place several
    cells on one device (``["cuda:0"] * 6``, or ``["cpu"] * 8`` for the
    plain twins)."""
    if n_streams_axis < 1 or n_rows_axis < 1:
        raise ValueError(
            f"mesh axes must be >= 1, got {n_streams_axis}x{n_rows_axis}")
    if devices is None:
        devices = visible_devices()
    need = n_streams_axis * n_rows_axis
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.empty(need, dtype=object)
    arr[:] = [torch.device(d) for d in list(devices)[:need]]
    return Mesh(arr.reshape(n_streams_axis, n_rows_axis),
                ("stream", "rows"))


def slab_rows_ok(hp: int, rows_ax: int) -> bool:
    """True when the slab kernels can run: every slab 8-row aligned."""
    return hp % (8 * rows_ax) == 0


def _check_slab_alignment(h: int, w: int, mesh: Mesh) -> None:
    hp = pad_geometry(h, w)[0]
    rows_ax = mesh.shape.get("rows", 1)
    if not slab_rows_ok(hp, rows_ax):
        raise ValueError(
            f"kernel 2-D grid needs 8-row-aligned slabs: padded height "
            f"{hp} / {rows_ax} row shards = {hp / rows_ax} rows")


def _check_plain(props: DiPsProperties, layout: Layout, raw: list) -> None:
    """``backend="plain"``: CPU tensors only, slabs no thinner than the
    stencil's halo."""
    on = {t.device.type for row in raw for t in row}
    if on != {"cpu"}:
        raise ValueError(
            f'backend="plain" runs the plain twins, on CPU tensors only '
            f"(got {sorted(on)}); on a card the slabs must be 8-row aligned "
            f'and run backend="kernel"')
    p = props.window_size // 2
    if layout.hs < p:
        raise ValueError(f"row slab {layout.hs} < halo {p}")


def _check_slab_impl(slab_impl: str) -> None:
    if slab_impl not in ("bands", "extended"):
        raise ValueError(f"unknown slab_impl {slab_impl!r}")


def _sections(x: torch.Tensor, s_l: int) -> torch.Tensor:
    """Row-stacked (..., S_l*Hs, Wp) as (..., S_l, Hs, Wp) (a view)."""
    return x.view(*x.shape[:-2], s_l, x.shape[-2] // s_l, x.shape[-1])


def _stacked(x: torch.Tensor) -> torch.Tensor:
    """(..., S_l, Hs, Wp) -> row-stacked (..., S_l*Hs, Wp)."""
    return x.reshape(*x.shape[:-3], x.shape[-3] * x.shape[-2], x.shape[-1])


def _band_exchange_u8(slabs: list, s_l: int) -> list:
    """The row neighbours' 8-row bands: ``slabs`` are the R cells' raw
    slabs of one stream shard, top to bottom, u8 (F, 3, S_l*Hs, Wp) each on
    its device -> [(top, bottom)] per cell, u8 (F, 3, S_l*8, Wp) on that
    cell's device: the last 8 rows of each section of the cell above and
    the first 8 of the cell below (zeros at the global top and bottom, the
    pipeline's zero out-of-bounds taps).  A slab of fewer than 8 rows (the
    plain backend) gives all its rows, next to the receiver, and the band's
    far rows stay zero: the stencil reads at most 3 rows of a band."""
    n = len(slabs)
    k = min(_EXT, slabs[0].shape[-2] // s_l)
    out = []
    for j, slab in enumerate(slabs):
        zero = slab.new_zeros(slab.shape[:2] + (s_l * _EXT, slab.shape[-1]))
        # the copy is the exchange: a contiguous tensor on the receiver
        top = zero if j == 0 else _stacked(F.pad(
            _sections(slabs[j - 1], s_l)[..., -k:, :].to(slab.device),
            (0, 0, _EXT - k, 0)))
        bot = zero if j == n - 1 else _stacked(F.pad(
            _sections(slabs[j + 1], s_l)[..., :k, :].to(slab.device),
            (0, 0, 0, _EXT - k)))
        out.append((top.contiguous(), bot.contiguous()))
    return out


def _slab_row_bounds(props: DiPsProperties, h: int, w: int, hs: int,
                     row_index: int, ext: int = _EXT):
    """Section-local [lo, hi) mask row window of row shard ``row_index``:
    the global roi / validity rows cut to the owned range, shifted by the
    extension offset (0 in band mode: owned coordinates)."""
    row0 = row_index * hs
    y0, _, y1, _ = props.roi_bounds(h, w)  # global rows, clipped to h
    lo = min(max(y0 - row0, 0), hs) + ext
    hi = min(max(y1 - row0, 0), hs) + ext
    return lo, hi


def _raw_grid_bounds(props: DiPsProperties, h: int, w: int, hs: int,
                     row_index: int):
    from .rowsharded import _raw_slab_bounds
    return (None if props.roi is None
            else _raw_slab_bounds(props, h, w, hs, row_index))


def _combine_slab_stats(stats: list) -> torch.Tensor:
    """The R row shards' (s, B, 4) partials of one stream shard -> the
    full-frame stats, on the first shard's device: the mean / mean-abs /
    count partials are sums over owned rows, the max a max over them."""
    st = torch.stack([x.to(stats[0].device) for x in stats])
    return torch.stack([st[..., 0].sum(0), st[..., 1].sum(0),
                        st[..., 2].amax(0), st[..., 3].sum(0)], dim=-1)


def _grid_gmean(stats: torch.Tensor, valid) -> torch.Tensor:
    """Mean |diff| over the valid slots of every stream (a 0-dim tensor):
    padding replicas and dead streams stay out of the aggregate."""
    vw = torch.as_tensor(np.asarray(valid, np.float32), device=stats.device)
    return (stats[..., 1] * vw).sum() / torch.clamp(vw.sum(), min=1.0)


# ---------------------------------------------------------------------------
# One cell's launch (the shard bodies); tensors row-stacked over the cell's
# S_l local streams, carried state updated in place
# ---------------------------------------------------------------------------

def _extend(x: torch.Tensor, s_l: int, top=None, bot=None) -> torch.Tensor:
    """Each section of row-stacked ``x`` with 8 rows above and below: the
    bands' rows, or zeros."""
    sec = _sections(x, s_l)
    if top is None:
        return _stacked(F.pad(sec, (0, 0, _EXT, _EXT)))
    return _stacked(torch.cat([_sections(top, s_l), sec,
                               _sections(bot, s_l)], dim=-2))


def _owned(x: torch.Tensor, s_l: int) -> torch.Tensor:
    """The owned rows of each extended section (a view, (..., S_l, Hs,
    Wp))."""
    return _sections(x, s_l)[..., _EXT:-_EXT, :]


def _slab_body_bands(props, h, w, s_l, raw, baseline, flags, heatmap,
                     valid, bands, row_index):
    """Band-mode stacked slab body, tail protocol: raw, carried state and
    outputs stay in OWNED slab coordinates; the two 8-row neighbour bands
    feed the stencil's boundary taps, so the slab's data movement is the
    full-height kernel's plus 8/Hs of band traffic.

    raw u8 (T+B, 3, S_l*Hs, Wp), baseline / heatmap f32 (S_l*Hs, Wp),
    flags / valid (S_l, B), bands (top, bottom) u8 (T+B, 3, S_l*8, Wp) ->
    (out (B, C, S_l*Hs, Wp), this slab's stats partials (S_l, B, 4))."""
    hs = raw.shape[-2] // s_l
    out, stats, *_ = cuda_fused.batch_step_stacked(
        props, h, w, s_l, raw, baseline, flags, heatmap, valid,
        row_bounds=_slab_row_bounds(props, h, w, hs, row_index, ext=0),
        bands=bands if props.window_size > 1 else None)
    return out, stats


def _slab_body_ring_bands(props, h, w, s_l, raw, ring, prev, baseline,
                          flags, heatmap, valid, offsets, seeds, bands,
                          row_index):
    """Band-mode ring-carry stacked slab body: the ring twin of
    :func:`_slab_body_bands` -- B new frames in, ring / prev / baseline /
    heatmap carried in OWNED slab coordinates, no pad or slice at all.

    raw u8 (B, 3, S_l*Hs, Wp); ring f32 (T, S_l*Hs, Wp); prev / baseline /
    heatmap f32 (S_l*Hs, Wp); flags / valid (S_l, B); offsets / seeds
    (S_l,) -> (out, this slab's stats partials)."""
    hs = raw.shape[-2] // s_l
    out, stats, *_ = cuda_fused.batch_step_ring_stacked(
        props, h, w, s_l, raw, ring, prev, baseline, flags, heatmap, valid,
        offsets, seeds,
        row_bounds=_slab_row_bounds(props, h, w, hs, row_index, ext=0),
        bands=bands if props.window_size > 1 else None)
    return out, stats


def _slab_body(props, h, w, s_l, raw, baseline, flags, heatmap, valid,
               bands, row_index):
    """Stacked slab body on halo-EXTENDED slabs, tail protocol: the bands
    are concatenated around each section, the carried state is zero-padded
    in, and the owned rows of the outputs and of the state are sliced out
    again (the extension rows compute garbage that the row window keeps out
    of the statistics and that never reaches carried state)."""
    hs = raw.shape[-2] // s_l
    bl, hm = _extend(baseline, s_l), _extend(heatmap, s_l)
    out, stats, *_ = cuda_fused.batch_step_stacked(
        props, h, w, s_l, _extend(raw, s_l, *bands), bl, flags, hm, valid,
        row_bounds=_slab_row_bounds(props, h, w, hs, row_index))
    for dst, src in ((baseline, bl), (heatmap, hm)):
        _sections(dst, s_l).copy_(_owned(src, s_l))
    return _stacked(_owned(out, s_l)), stats


def _slab_body_ring(props, h, w, s_l, raw, ring, prev, baseline, flags,
                    heatmap, valid, offsets, seeds, bands, row_index):
    """Ring-carry stacked slab body on halo-EXTENDED slabs.  Carried state
    stays in owned coordinates across batches: it is zero-padded in and
    sliced out every batch, so the extension rows' values are inert and the
    state shapes equal the band mode's."""
    hs = raw.shape[-2] // s_l
    state = (ring, prev, baseline, heatmap)
    ext = [_extend(x, s_l) for x in state]
    out, stats, *_ = cuda_fused.batch_step_ring_stacked(
        props, h, w, s_l, _extend(raw, s_l, *bands), *ext[:3], flags,
        ext[3], valid, offsets, seeds,
        row_bounds=_slab_row_bounds(props, h, w, hs, row_index))
    for dst, src in zip(state, ext):
        _sections(dst, s_l).copy_(_owned(src, s_l))
    return _stacked(_owned(out, s_l)), stats


def _raw_grid_body(props, h, w, s_l, raw, baseline, flags, heatmap, valid,
                   row_index):
    """Stacked raw (absdiff / threshold / stats-only) slab body, tail
    protocol.  No stencil, so no halo, no bands, no extension: slabs live
    in owned coordinates and only the statistics cross cells.

    raw u8 (T+B, 3, S_l*Hs, Wp), baseline u8 (3, S_l*Hs, Wp), heatmap f32
    (S_l*Hs, Wp), flags / valid (S_l, B) -> (out, stats partials)."""
    hs = raw.shape[-2] // s_l
    out, stats, *_ = cuda_fused.absdiff_step_stacked(
        props, h, w, s_l, raw, baseline, flags, heatmap, valid,
        row_bounds=_raw_grid_bounds(props, h, w, hs, row_index))
    return out, stats


def _raw_grid_body_ring(props, h, w, s_l, raw, prev, baseline, flags,
                        heatmap, valid, seeds, row_index):
    """Ring-protocol twin of :func:`_raw_grid_body`: prev / baseline u8
    (3, S_l*Hs, Wp) are carried in owned slab coordinates; the input is only
    the B new frames."""
    hs = raw.shape[-2] // s_l
    out, stats, *_ = cuda_fused.absdiff_step_ring_stacked(
        props, h, w, s_l, raw, prev, baseline, flags, heatmap, valid, seeds,
        row_bounds=_raw_grid_bounds(props, h, w, hs, row_index))
    return out, stats


# ---------------------------------------------------------------------------
# A step over every cell
# ---------------------------------------------------------------------------

def _host2d(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x)


def run_grid_ring_step(props: DiPsProperties, h: int, w: int,
                       layout: Layout, raw: list, state: dict, flags,
                       valid, offsets, seeds, slab_impl: str = "bands",
                       home=None):
    """One ring-carry batch over the cells of ``layout``.

    ``raw``: the cells of the u8 (B, 3, S*Hp, Wp) input; ``state``: the
    cells of "ring" (median modes), "prev", "baseline" and "heatmap",
    updated in place; flags / valid (S, B), offsets / seeds (S,) on the
    host.  Returns (the cells of out, stats f32 (S, B, 4) on ``home``).  A
    mesh without a "rows" axis runs the full-height stacked kernels per
    stream shard."""
    flags, valid = _host2d(flags), _host2d(valid)
    offsets, seeds = _host2d(offsets), _host2d(seeds)
    raw_mode = props.output in _RAW_MODES
    slabs = "rows" in layout.mesh.axis_names
    body = (_slab_body_ring_bands if slab_impl == "bands"
            else _slab_body_ring)
    outs, stats = [], []
    for i in range(layout.s_ax):
        sl = layout.streams(i)
        fl, va, sd = flags[sl], valid[sl], seeds[sl]
        bands = None
        if slabs and not raw_mode and (props.window_size > 1
                                       or slab_impl == "extended"):
            bands = _band_exchange_u8(raw[i], layout.s_l)
        row_out, row_stats = [], []
        for j in range(layout.r_ax):
            cell = {k: v[i][j] for k, v in state.items() if v is not None}
            if raw_mode and slabs:
                o, st = _raw_grid_body_ring(
                    props, h, w, layout.s_l, raw[i][j], cell["prev"],
                    cell["baseline"], fl, cell["heatmap"], va, sd, j)
            elif raw_mode:
                o, st, *_ = cuda_fused.absdiff_step_ring_stacked(
                    props, h, w, layout.s_l, raw[i][j], cell["prev"],
                    cell["baseline"], fl, cell["heatmap"], va, sd)
            elif slabs:
                o, st = body(
                    props, h, w, layout.s_l, raw[i][j], cell["ring"],
                    cell["prev"], cell["baseline"], fl, cell["heatmap"], va,
                    offsets[sl], sd, bands[j] if bands else None, j)
            else:
                o, st, *_ = cuda_fused.batch_step_ring_stacked(
                    props, h, w, layout.s_l, raw[i][j], cell["ring"],
                    cell["prev"], cell["baseline"], fl, cell["heatmap"], va,
                    offsets[sl], sd)
            row_out.append(o)
            row_stats.append(st)
        outs.append(row_out)
        stats.append(_combine_slab_stats(row_stats) if slabs
                     else row_stats[0])
    home = stats[0].device if home is None else home
    return outs, torch.cat([st.to(home) for st in stats])


def run_grid_step(props: DiPsProperties, h: int, w: int, layout: Layout,
                  raw: list, state: dict, flags, valid,
                  slab_impl: str = "bands", backend: str = "kernel",
                  home=None):
    """One tail-protocol batch over the cells of ``layout``: ``raw`` the
    cells of u8 (T+B, 3, S*Hp, Wp), ``state`` those of "baseline" and
    "heatmap" (in place) -> (the cells of out, stats (S, B, 4) on
    ``home``).  ``backend="plain"`` takes slabs of any height of at least
    the stencil's halo, and only CPU tensors (the plain twins)."""
    flags, valid = _host2d(flags), _host2d(valid)
    raw_mode = props.output in _RAW_MODES
    slabs = "rows" in layout.mesh.axis_names
    if backend == "plain":
        _check_plain(props, layout, raw)
    outs, stats = [], []
    for i in range(layout.s_ax):
        sl = layout.streams(i)
        fl, va = flags[sl], valid[sl]
        base, heat = state["baseline"][i], state["heatmap"][i]
        bands = None
        if slabs and not raw_mode and (props.window_size > 1
                                       or slab_impl == "extended"):
            bands = _band_exchange_u8(raw[i], layout.s_l)
        body = _slab_body_bands if slab_impl == "bands" else _slab_body
        row_out, row_stats = [], []
        for j in range(layout.r_ax):
            args = (props, h, w, layout.s_l, raw[i][j], base[j], fl,
                    heat[j], va)
            if raw_mode and slabs:
                o, st = _raw_grid_body(*args, j)
            elif raw_mode:
                o, st, *_ = cuda_fused.absdiff_step_stacked(*args)
            elif slabs:
                o, st = body(*args, bands[j] if bands else None, j)
            else:
                o, st, *_ = cuda_fused.batch_step_stacked(*args)
            row_out.append(o)
            row_stats.append(st)
        outs.append(row_out)
        stats.append(_combine_slab_stats(row_stats) if slabs
                     else row_stats[0])
    home = stats[0].device if home is None else home
    return outs, torch.cat([st.to(home) for st in stats])


# ---------------------------------------------------------------------------
# The JAX functions' call signatures: whole stream-leading tensors
# ---------------------------------------------------------------------------

def _row_stack(x: torch.Tensor, lead: int) -> torch.Tensor:
    """Stream-leading (S, *lead, Hp, Wp) -> row-stacked (*lead, S*Hp, Wp)
    (a copy for S > 1)."""
    return _stacked(x.movedim(0, lead).contiguous())


def _stream_lead(x: torch.Tensor, s: int, lead: int) -> torch.Tensor:
    """The inverse of :func:`_row_stack`."""
    return _sections(x, s).movedim(lead, 0)


def _global_step(props, h, w, mesh, ring_step: bool, slab_impl: str,
                 backend: str = "kernel"):
    """The whole-tensor step behind the ``make_*`` functions: scatter the
    arguments over the mesh's cells, run them, gather; the new state is
    also written into the state arguments."""
    raw_mode = props.output in _RAW_MODES
    hp, wp = pad_geometry(h, w)

    def step(raw, state: dict, flags, valid, offsets=None, seeds=None):
        layout = Layout(mesh, raw.shape[0], hp, wp)
        home = raw.device
        lead = {"ring": 1, "prev": 1 if raw_mode else 0,
                "baseline": 1 if raw_mode else 0, "heatmap": 0}
        cells = {k: layout.scatter(_row_stack(v, lead[k]))
                 for k, v in state.items()}
        raw_cells = layout.scatter(_row_stack(raw, 2))
        if ring_step:
            outs, stats = run_grid_ring_step(
                props, h, w, layout, raw_cells, cells, flags, valid,
                offsets, seeds, slab_impl, home)
        else:
            outs, stats = run_grid_step(
                props, h, w, layout, raw_cells, cells, flags, valid,
                slab_impl, backend, home)
        out = _stream_lead(layout.gather(outs, home), layout.s, 2)
        for k, v in state.items():
            v.copy_(_stream_lead(layout.gather(cells[k], home), layout.s,
                                 lead[k]))
        return out.contiguous(), stats, _grid_gmean(stats, _host2d(valid))

    return step


def make_grid_ring_step(props: DiPsProperties, h: int, w: int, mesh: Mesh,
                        slab_impl: str = "bands"):
    """Ring-carry step over a ("stream", "rows") mesh (slab kernels only).

    Median modes map raw (S, B, 3, Hp, Wp), ring (S, T, Hp, Wp), prev /
    baseline / heatmap (S, Hp, Wp), flags / valid (S, B), offsets / seeds
    (S,) -> (out, stats, ring, prev, baseline, heatmap, global mean |diff|).
    Raw modes have no ring array and no stencil (``slab_impl`` is
    irrelevant): raw, prev / baseline u8 (S, 3, Hp, Wp), flags, heatmap,
    valid, seeds -> (out, stats, prev, baseline, heatmap, global mean).
    The state arguments are updated in place and returned.

    ``slab_impl``: "bands" (default) feeds the stencil's slab-boundary taps
    from two thin 8-row neighbour-band kernel inputs, so raw, carried
    state and outputs stay in OWNED coordinates; "extended" concatenates
    the bands around every slab and pads / slices the state every batch
    (the same bit-exact results)."""
    _check_slab_impl(slab_impl)
    _check_slab_alignment(h, w, mesh)
    run = _global_step(props, h, w, mesh, True, slab_impl)
    if props.output in _RAW_MODES:
        def step(raw, prev, baseline, flags, heatmap, valid, seeds):
            out, stats, gmean = run(
                raw, dict(prev=prev, baseline=baseline, heatmap=heatmap),
                flags, valid, np.zeros(raw.shape[0], np.int32), seeds)
            return out, stats, prev, baseline, heatmap, gmean
        return step

    def step(raw, ring, prev, baseline, flags, heatmap, valid, offsets,
             seeds):
        out, stats, gmean = run(
            raw, dict(ring=ring, prev=prev, baseline=baseline,
                      heatmap=heatmap), flags, valid, offsets, seeds)
        return out, stats, ring, prev, baseline, heatmap, gmean
    return step


def make_grid_step(props: DiPsProperties, h: int, w: int, mesh: Mesh,
                   backend: Optional[str] = None, slab_impl: str = "bands"):
    """Tail-protocol step over a ("stream", "rows") mesh.

    Maps raw u8 (S, T+B, 3, Hp, Wp), baseline (S, Hp, Wp) f32 (median
    modes) or (S, 3, Hp, Wp) u8 (raw modes), flags (S, B), heatmap (S, Hp,
    Wp), valid (S, B) -> (out (S, B, C, Hp, Wp), stats (S, B, 4), baseline,
    heatmap, global mean |diff|); baseline and heatmap are updated in place
    and returned.  S must divide by the stream axis, Hp by the rows axis.

    ``backend``: "kernel" = the stacked slab kernels (the JAX package's
    "pallas": CUDA on a card, their plain twins on the CPU; slabs must be
    8-row aligned, :func:`slab_rows_ok`); "plain" = the plain twins on
    slabs of any height, for CPU tensors only (where the JAX package runs
    its "xla" body; CUDA tensors raise).  None (the default): "kernel" on
    aligned slabs, else "plain".  ``slab_impl`` (median modes): "bands"
    (default) or "extended", see :func:`make_grid_ring_step`."""
    _check_slab_impl(slab_impl)
    if backend is None:
        aligned = slab_rows_ok(pad_geometry(h, w)[0],
                               mesh.shape.get("rows", 1))
        backend = "kernel" if aligned else "plain"
    if backend not in ("plain", "kernel"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "kernel":
        _check_slab_alignment(h, w, mesh)
    run = _global_step(props, h, w, mesh, False, slab_impl, backend)

    def step(raw, baseline, flags, heatmap, valid):
        out, stats, gmean = run(raw, dict(baseline=baseline,
                                          heatmap=heatmap), flags, valid)
        return out, stats, baseline, heatmap, gmean
    return step
