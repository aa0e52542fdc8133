"""The device steps: CUDA kernels and their plain twins.

Counterpart of ``dips_tpu/ops/pallas_fused.py``, in both of its protocols.
The ring-carry steps carry the filtered temporal ring (median modes) or the
previous raw frame (raw modes) as device state:

* :func:`absdiff_step_ring_stacked` (raw ABSDIFF / THRESHOLD /
  STATS_ONLY), kernel ``csrc/raw_ring.cu``;
* :func:`batch_step_ring_stacked` (median pipeline: COLORIZE / GRAYSCALE /
  no maps), kernel ``csrc/median_ring.cu``;
* :func:`absdiff_step_ring` / :func:`batch_step_ring`: one stream, the
  stacked steps at s = 1.

The tail-protocol steps take the T raw tail frames ahead of the B new ones
(raw (T+B, 3, s*Hp, Wp)) and carry only the baseline and the heatmap; their
capture and PER_FRAME advance are not gated on ``valid``:

* :func:`absdiff_step_stacked`, the tail form of ``csrc/raw_ring.cu``;
* :func:`batch_step_stacked`, kernel ``csrc/median_tail.cu``, which
  rebuilds the ring from the tail at every call;
* :func:`absdiff_step` / :func:`batch_step`: one stream, at s = 1.

The stacked steps fold s streams along the row axis of one launch (the JAX
package's row-stacked layout, (B, 3, s*Hp, Wp)), with per-stream flags,
valid, ring offsets and seeds.  Every function takes the JAX function's
arguments in the same order and returns the same tuple.  A wrapper given
CUDA tensors launches its kernel (or raises); given CPU tensors it runs the
plain PyTorch twin (``*_plain``), which mirrors the Pallas body frame by
frame, stream by stream.  Nothing falls back from the card to the plain
version.  Each wrapper counts its own launches (``fn.launches``); the four
median wrappers also count them per spatial filter mode
(``fn.mode_launches``: the exact median, ``approx_median`` or
``quirk_compat``, each a compile-time instance of the kernel).

Row slabs (``parallel/grid2d.py``, ``parallel/rowsharded.py``): the stacked
steps also take ``row_bounds`` and, the median ones, ``bands`` -- the
``dyn_rows`` and ``slab_bands`` forms of the Pallas kernels.  A stacked
section is then a horizontal slab of a stream: ``row_bounds`` = (lo, hi) is
the statistics / heatmap mask's row window in slab-local rows, shared by
every section (host integers: they are launch arguments); the statistics
stay normalised by the FULL image's analysis pixels, so that the slabs'
partials add up.  ``bands`` = (top, bottom) u8 (frames, 3, s*8, Wp) hold,
for each section, the 8 rows above and the 8 rows below it: the spatial
window's taps outside the section read them instead of zeros.  The wrappers
count these launches per form too (``fn.form_launches``).

Carried state is updated in place: the kernels read it once, keep it in
registers for the batch, and write it back into the same tensors, which the
functions also return (the JAX functions donate the same buffers).  The
plain twins update in place too.

Statistics: the raw step reduces its own -- its launch ends with a small
kernel that sums the integer partials (one per block, tile and warp) in
int64 and converts and scales them as :func:`reduce_raw_stats` does, into
the (s, B, 4) stats, so the wrapper launches no reduction of its own.  The
median kernels leave per-(frame, stream) partials, one per warp of each
tile (``dips_median_parts`` of the library says how many), and the final
reduction (the counterpart of ``_reduce_stats``) runs here in plain torch.

The layout prep of a downscaled engine: :func:`pool_prep`, kernel
``csrc/pool_prep.cu`` (the k x k box mean of hwc frames, written into the
planar rows the steps read), in a library of its own built at the first
:func:`pool_prep_lib` of a process; its launches are ``pool_prep`` in
:func:`launch_counts`.

Block geometry: each launch asks :func:`median_tile` / :func:`raw_block`
which geometry to build and launch (``ops/_build.py``): the entry that
``ops/tuning.py``'s store holds for this card and this launch (kernel,
window, stacked or not, slab bands and the owned height), else the
default geometry (``_build.DEFAULT``), whose library holds every kernel.
Without a store file every launch uses the default.  A geometry that
fails to build or to launch raises; nothing falls back to the default.
Each wrapper counts its launches per geometry (``fn.geometry_launches``,
by ``MedianTile.name()`` / ``RawBlock.name()``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..properties import (ChromaFilter, DiPsFilter, DiPsMethod,
                          DiPsProperties, OutputMode)
from . import _build, tuning
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


def _stream_ptr(device: torch.device) -> int:
    """The current stream of ``device`` (ctypes passes the int as the
    entry points' ``void*``)."""
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _host_rows(x, shape: tuple, name: str, key: str) -> np.ndarray:
    """A per-stream argument (flags / valid (s, B), offsets / seeds (s,))
    as a host int64 array of that shape."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    a = np.asarray(x).astype(np.int64)
    if a.shape != shape:
        raise ValueError(f"{name}: {key} shape {a.shape} != {shape}")
    return a


def _one_stream(x, b: int, name: str, key: str):
    """A single-stream (B,) flag vector as the (1, B) rows of the stacked
    functions, on its own device."""
    shape = tuple(x.shape) if isinstance(x, torch.Tensor) \
        else np.shape(x)
    if tuple(shape) != (b,):
        raise ValueError(f"{name}: {key} shape {tuple(shape)} != ({b},)")
    return x.reshape(1, b) if isinstance(x, torch.Tensor) \
        else np.asarray(x).reshape(1, b)


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


def _stream_i32(name: str, device: torch.device, items) -> list:
    """Per-stream int32 kernel arguments ``[(key, value, shape), ...]`` ->
    device tensors of those shapes, cut from one buffer: host values go up
    in one copy, device values are concatenated on the device.

    The uploads are asynchronous, from pinned memory (torch's caching host
    allocator, which holds the block until its copy is done): a copy from
    pageable memory waits for the work already on the stream, which would
    make every launch wait for the one before it."""
    flat = []
    for key, x, shape in items:
        if isinstance(x, torch.Tensor) and not x.is_cuda:
            x = x.numpy()
        t = x if isinstance(x, torch.Tensor) else np.asarray(x)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} shape {tuple(t.shape)} != "
                             f"{shape}")
        flat.append(t.reshape(-1))
    if any(isinstance(t, torch.Tensor) for t in flat):
        buf = torch.cat([t.to(device=device, dtype=torch.int32,
                              non_blocking=True)
                         if isinstance(t, torch.Tensor) else
                         _upload_i32([t], device) for t in flat])
    else:  # all on the host: one array, one copy
        buf = _upload_i32(flat, device)
    views, i = [], 0
    for t, (_, _, shape) in zip(flat, items):
        n = t.numel() if isinstance(t, torch.Tensor) else t.size
        views.append(buf[i:i + n].view(shape))
        i += n
    return views


def _upload_i32(arrays, device: torch.device) -> torch.Tensor:
    """Host arrays, concatenated as int32 into pinned memory, copied to
    ``device`` asynchronously."""
    host = torch.empty(sum(a.size for a in arrays), dtype=torch.int32,
                       pin_memory=True)
    np.concatenate([a.astype(np.int32, copy=False) for a in arrays],
                   out=host.numpy())
    return host.to(device, non_blocking=True)


def _stream_rows(name: str, raw: torch.Tensor, s: int) -> int:
    """One stream's padded height Hp of a row-stacked (B, 3, s*Hp, Wp)
    batch."""
    if raw.dim() != 4 or s < 1 or raw.shape[-2] % s:
        raise ValueError(f"{name}: raw shape {tuple(raw.shape)} is not "
                         f"(B, 3, {s}*Hp, Wp)")
    return raw.shape[-2] // s


#: the row-slab forms of a launch (``fn.form_launches``)
SLAB_FORMS = ("dyn_rows", "slab_bands")


def _row_window(name: str, row_bounds) -> Optional[Tuple[int, int]]:
    """``row_bounds`` as host integers (lo, hi), or None."""
    if row_bounds is None:
        return None
    if isinstance(row_bounds, torch.Tensor):
        row_bounds = row_bounds.tolist()
    lo, hi = (int(v) for v in row_bounds)
    if lo < 0 or hi < 0:
        raise ValueError(f"{name}: row_bounds {(lo, hi)} must not be "
                         f"negative")
    return lo, hi


def _check_bands(name: str, props: DiPsProperties, bands, frames: int,
                 s: int, wp: int, views: bool = False):
    """``bands`` as a (top, bottom) pair of contiguous u8 (frames, 3, s*8,
    Wp) tensors, or None; ``views``: one section's rows of stacked bands,
    which need not be contiguous."""
    if bands is None:
        return None
    if props.window_size <= 1:
        raise ValueError("slab bands apply only to stencil windows (> 1)")
    top, bottom = bands
    shape = (frames, 3, s * ref.BAND_ROWS, wp)
    for key, t in (("top band", top), ("bottom band", bottom)):
        if t.dtype != torch.uint8 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} {t.dtype} {tuple(t.shape)} "
                             f"is not uint8 {shape}")
        if not (views or t.is_contiguous()):  # the kernel needs it
            raise ValueError(f"{name}: {key} must be contiguous")
    return top, bottom


def _section_bands(bands, si: int):
    """Section ``si``'s own 8 rows of each stacked band."""
    if bands is None:
        return None
    r = slice(si * ref.BAND_ROWS, (si + 1) * ref.BAND_ROWS)
    return bands[0][:, :, r], bands[1][:, :, r]


def _route(name: str, raw: torch.Tensor) -> bool:
    """True: launch the kernel (CUDA tensors); False: the plain twin (CPU
    tensors).  Any other device raises."""
    if raw.is_cuda:
        return True
    if raw.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain path for {raw.device}")


# ---------------------------------------------------------------------------
# Block geometry of a launch (counterpart of _ring_geometry / _raw_block_rows)
# ---------------------------------------------------------------------------

def _smem_limit(device: torch.device) -> int:
    """Dynamic shared memory a block may opt in to on ``device``."""
    return torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin


def median_tile(props: DiPsProperties, hp: int, s: int, tail: bool,
                bands: bool, device: torch.device) -> _build.MedianTile:
    """The tile of a median launch on ``device``: the store's entry for
    this card and this launch -- ``tail_tiles`` (the tail kernel);
    ``slab_ring_tiles`` (s = 1) or ``stacked_slab_ring_tiles`` (s > 1) at
    owned height ``hp`` (the ring kernel with bands: a stacked band launch
    never takes the s = 1 slab tile, which was measured on another shape);
    ``stacked_ring_tiles`` (s > 1, else ``ring_tiles``) or ``ring_tiles``
    -- else the default tile.  The store's tiles are
    measured in the exact median, so the approx and quirk launches keep
    the default (a w7 tail tile that won by 18% there lost 6-14% in
    them).  A stored height that does not divide ``hp``, or whose shared
    memory at this window and ring length exceeds what a block may use,
    falls to the largest multiple of 8 below it that does (8 divides
    every padded height)."""
    if spatial_mode(props) != "exact":
        return _build.DEFAULT.tile
    w = props.window_size
    kind = tuning._device_kind(device)
    if tail:
        stored = tuning.tail_tile(w, kind)
    elif bands:
        stored = (tuning.slab_ring_tile(w, hp, kind) if s == 1
                  else tuning.stacked_slab_ring_tile(w, hp, kind))
    else:
        stored = ((tuning.stacked_ring_tile(w, kind) if s > 1 else None)
                  or tuning.ring_tile(w, kind))
    if stored is None:
        return _build.DEFAULT.tile
    limit = _smem_limit(device)
    for rows in range(stored.rows, 8, -8):
        tile = _build.MedianTile(rows, stored.px, stored.stages)
        if hp % rows == 0 and tile.smem_bytes(
                w, 0, props.temporal_size) <= limit:
            return tile
    return _build.MedianTile(8, stored.px, stored.stages)


def raw_block(s: int, wp: int, device: torch.device) -> _build.RawBlock:
    """The block of a raw launch on ``device``: the store's
    ``stacked_raw_block`` (s > 1; else, or when it has none,
    ``raw_block``) for this card, else the default block; a stored width
    that does not divide the row falls to 16 bytes."""
    kind = tuning._device_kind(device)
    stored = ((tuning.stacked_raw_block(kind) if s > 1 else None)
              or tuning.raw_block(kind))
    if stored is None:
        return _build.DEFAULT.block
    if wp % stored.bytes:
        return _build.RawBlock(stored.threads, 16)
    return stored


# ---------------------------------------------------------------------------
# Final reduction of the statistic partials (counterpart of _reduce_stats)
# ---------------------------------------------------------------------------

def reduce_raw_stats(parts: torch.Tensor, props: DiPsProperties, h: int,
                     w: int) -> torch.Tensor:
    """Integer partials (B, S, n_parts, 4) -> (S, B, 4) float32 stats:
    channel-mean signed and abs diff on [-1, 1], max |diff| / 255, changed
    count.  Sums are taken in int64 and converted to float32 once.  The
    raw plain twins' reduction; the raw kernel's launch computes the same
    on the card (``raw_step_stats_kernel``)."""
    p = parts.sum(dim=2, dtype=torch.int64)
    p[..., 2] = parts[..., 2].amax(dim=2)
    st = p.to(torch.float32)
    st[..., :2] *= _f32(1.0 / (3 * props.analysis_pixels(h, w) * 255))
    st[..., 2] *= _f32(1 / 255.0)
    return st.transpose(0, 1).contiguous()


def reduce_median_stats(parts: torch.Tensor, props: DiPsProperties, h: int,
                        w: int) -> torch.Tensor:
    """float32 partials (B, S, n_parts, 4) -> (S, B, 4) stats: mean diff,
    mean |diff|, max |diff|, changed count; any split of the pixels into
    partials (per tile, per tile and warp) sums to the same stats.  The
    sums are taken in float64 and rounded to float32 once, so that a
    stream's stats do not depend on the order torch picks for the
    reduction, which changes with S: a stacked launch's streams equal s = 1
    launches bit for bit."""
    p = parts.sum(dim=2, dtype=torch.float64).to(torch.float32)
    p[..., 2] = parts[..., 2].amax(dim=2)
    p[..., :2] *= _f32(1.0 / props.analysis_pixels(h, w))
    return p.transpose(0, 1).contiguous()


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


def _raw_frames(props: DiPsProperties, h: int, w: int,
                frames: torch.Tensor, refi: torch.Tensor, flags, vals,
                heat: torch.Tensor, gated: bool, rows=None):
    """Frame loop of the raw plain twins, frame by frame as the body of
    ``_make_raw_kernel`` runs it: frames u8 (B, 3, Hp, Wp), refi int32
    (3, Hp, Wp) the reference of the first frame, heat a private heatmap
    -> (out, int64 partials (B, 1, 1, 4), the final reference, heat).
    ``gated`` (ring protocol): capture and the PER_FRAME advance skip
    invalid frames; the tail protocol's are ungated.  ``rows`` = (lo, hi):
    the frames are a row slab and the roi mask's rows are [lo, hi) of it."""
    overall = props.method == DiPsMethod.OVERALL
    b = frames.shape[0]
    hp, wp = frames.shape[-2], frames.shape[-1]
    mode, c = _raw_out_mode(props)
    thr = props.change_threshold
    rm = None
    if props.roi is not None:
        y0, x0, y1, x1 = props.roi_bounds(h, w)
        if rows is not None:
            y0, y1 = rows
        rm = ref.valid_mask(hp, wp, h, w, (y0, x0, y1, x1),
                            device=frames.device).to(torch.int32)
    out = torch.empty((b, c, hp, wp), dtype=torch.uint8,
                      device=frames.device)
    parts = torch.empty((b, 1, 1, 4), dtype=torch.int64,
                        device=frames.device)
    scale = _f32(1.0 / (3 * 255.0))
    for m in range(b):
        cur = frames[m].to(torch.int32)
        state_ok = bool(vals[m]) or not gated
        if overall and flags[m] and state_ok:
            refi = cur
        sg = refi - cur
        ad = sg.abs()
        dmax = ad.amax(0)
        if not overall and state_ok:
            refi = cur
        if rm is None:
            sg_m, ad_m, dmax_m = sg, ad, dmax
        else:
            sg_m, ad_m, dmax_m = sg * rm, ad * rm, dmax * rm
        parts[m, 0, 0, 0] = sg_m.sum(dtype=torch.int64)
        parts[m, 0, 0, 1] = ad_m.sum(dtype=torch.int64)
        parts[m, 0, 0, 2] = dmax_m.amax()
        parts[m, 0, 0, 3] = (dmax_m >= thr).sum(dtype=torch.int64)
        heat = heat + (ad_m.sum(0).to(torch.float32) * scale) \
            * float(vals[m])
        if mode == 1:
            out[m] = ad.to(torch.uint8)
        elif mode == 2:
            out[m, 0] = torch.where(dmax >= thr, 255, 0).to(torch.uint8)
    return out, parts, refi, heat


def _raw_row_window(name: str, props: DiPsProperties, row_bounds):
    """The raw steps' ``row_bounds`` as host integers; they need an roi."""
    rows = _row_window(name, row_bounds)
    if rows is not None and props.roi is None:
        raise ValueError("row_bounds applies only with an roi (the raw "
                         "kernel is maskless otherwise)")
    return rows


def absdiff_step_ring_plain(props: DiPsProperties, h: int, w: int,
                            raw: torch.Tensor, prev: torch.Tensor,
                            baseline_raw: torch.Tensor, snap_flags,
                            heatmap: torch.Tensor, valid, seed,
                            row_bounds=None):
    """Plain twin of one stream of the raw ring step: raw (B, 3, Hp, Wp),
    flags / valid (B,), seed int -> (out, stats (B, 4), prev, baseline,
    heatmap), state in place."""
    overall = props.method == DiPsMethod.OVERALL
    rows = _raw_row_window("absdiff_step_ring", props, row_bounds)
    b = raw.shape[0]
    flags = _host_rows(snap_flags, (b,), "absdiff_step_ring", "snap_flags")
    vals = _host_rows(valid, (b,), "absdiff_step_ring", "valid")
    refi = (baseline_raw if overall else prev).to(torch.int32)
    if not overall and int(seed):
        refi = raw[0].to(torch.int32)
    out, parts, refi, heat = _raw_frames(props, h, w, raw, refi, flags,
                                         vals, heatmap.clone(), gated=True,
                                         rows=rows)
    if overall:
        baseline_raw.copy_(refi.to(torch.uint8))
    else:
        prev.copy_(refi.to(torch.uint8))
    heatmap.copy_(heat)
    return (out, reduce_raw_stats(parts, props, h, w)[0], prev, baseline_raw,
            heatmap)


def absdiff_step_ring_stacked_plain(props: DiPsProperties, h: int, w: int,
                                    s: int, raw: torch.Tensor,
                                    prev: torch.Tensor,
                                    baseline_raw: torch.Tensor, snap_flags,
                                    heatmap: torch.Tensor, valid, seeds,
                                    row_bounds=None):
    """Plain twin of :func:`absdiff_step_ring_stacked`: the streams are
    independent, so each stream's row section (a view) runs through
    :func:`absdiff_step_ring_plain`, and its state is written back in
    place."""
    name = "absdiff_step_ring_stacked"
    b = raw.shape[0]
    hp = _stream_rows(name, raw, s)
    flags = _host_rows(snap_flags, (s, b), name, "snap_flags")
    vals = _host_rows(valid, (s, b), name, "valid")
    sd = _host_rows(seeds, (s,), name, "seeds")
    outs, stats = [], []
    for si in range(s):
        r = slice(si * hp, (si + 1) * hp)
        o, st, *_ = absdiff_step_ring_plain(
            props, h, w, raw[:, :, r], prev[:, r], baseline_raw[:, r],
            flags[si], heatmap[r], vals[si], sd[si], row_bounds)
        outs.append(o)
        stats.append(st)
    return (torch.cat(outs, dim=2), torch.stack(stats), prev, baseline_raw,
            heatmap)


def _new_frames(name: str, props: DiPsProperties, raw: torch.Tensor) -> int:
    """B of a tail-protocol batch (T+B, 3, s*Hp, Wp)."""
    b = raw.shape[0] - props.temporal_size
    if b < 1:
        raise ValueError(f"{name}: raw holds {raw.shape[0]} frames, not the "
                         f"T={props.temporal_size} tail frames and at least "
                         f"one new frame")
    return b


def _launch_raw(name: str, props: DiPsProperties, h: int, w: int, s: int,
                raw: torch.Tensor, prev, baseline_raw: torch.Tensor,
                snap_flags, heatmap: torch.Tensor, valid, seeds,
                row_bounds=None, block: Optional[_build.RawBlock] = None,
                reps: int = 1):
    """One launch of ``csrc/raw_ring.cu`` over s row-stacked streams: the
    ring step, or the tail step when ``prev`` is None (raw then starts with
    the T tail frames, and there are no seeds).  ``row_bounds``: the
    sections are row slabs and the roi mask's rows are that window of each
    (the ``dyn_rows`` form); the statistics keep the full image's scale.
    ``block``: the geometry to launch (default :func:`raw_block`'s);
    ``reps``: launches back to back on the same tensors (the tuner times
    the kernel alone so), the result being the last one's.  Returns (the
    step's result, the block launched)."""
    rows = _raw_row_window(name, props, row_bounds)
    tail = prev is None
    t_in = props.temporal_size if tail else 0
    b = _new_frames(name, props, raw) if tail else raw.shape[0]
    wp = raw.shape[-1]
    hp = _stream_rows(name, raw, s)
    dev = raw.device
    state = (3, s * hp, wp)
    tensors = dict(raw=(raw, torch.uint8, (t_in + b,) + state),
                   baseline_raw=(baseline_raw, torch.uint8, state),
                   heatmap=(heatmap, torch.float32, state[1:]))
    if not tail:
        tensors["prev"] = (prev, torch.uint8, state)
    _check_cuda(name, dev, **tensors)
    if wp % 16:
        raise ValueError(f"{name}: Wp={wp} is not a multiple of 16")
    block = block or raw_block(s, wp, dev)
    if wp % block.bytes:
        raise ValueError(f"{name}: Wp={wp} is not a multiple of the "
                         f"{block.name()} block's {block.bytes} bytes")
    scalars = _stream_i32(name, dev, [
        ("snap_flags", snap_flags, (s, b)), ("valid", valid, (s, b))]
        + ([] if tail else [("seeds", seeds, (s,))]))
    mode, c = _raw_out_mode(props)
    out = torch.empty((b, c, s * hp, wp), dtype=torch.uint8, device=dev)
    stats = torch.empty((s, b, 4), dtype=torch.float32, device=dev)
    y0, x0, y1, x1 = ((0, 0, hp, wp) if props.roi is None
                      else props.roi_bounds(h, w))
    if rows is not None:
        y0, y1 = rows
    # the launch goes to the CURRENT device: make it the tensors' own (a
    # mesh cell on another card than the process's current one)
    with torch.cuda.device(dev):
        lib = _build.kernel_lib(_build.Geometry(block=block),
                                _build.RAW_UNIT)
        nb = block.blocks(s, hp, wp, _raw_resident(lib, dev, block, mode))
        parts = torch.empty((b, s, block.parts(hp, wp, nb), 4),
                            dtype=torch.int32, device=dev)
        common = (nb, int(props.method == DiPsMethod.OVERALL), mode,
                  props.change_threshold, y0, x0, y1, x1,
                  _f32(1.0 / (3 * 255.0)),
                  _f32(1.0 / (3 * props.analysis_pixels(h, w) * 255)),
                  _f32(1 / 255.0), _stream_ptr(dev))
        for _ in range(reps):
            if tail:
                rc = lib.dips_raw_tail(
                    _ptr(raw), _ptr(baseline_raw), _ptr(heatmap), _ptr(out),
                    _ptr(parts), _ptr(stats), *map(_ptr, scalars), s, b,
                    t_in, hp, wp, *common)
            else:
                rc = lib.dips_raw_ring(
                    _ptr(raw), _ptr(prev), _ptr(baseline_raw),
                    _ptr(heatmap), _ptr(out), _ptr(parts), _ptr(stats),
                    *map(_ptr, scalars), s, b, hp, wp, *common)
            if rc:
                _build.check(rc, f"{name} ({block.name()} block)", lib)
    if tail:
        return (out, stats, baseline_raw, heatmap), block
    return (out, stats, prev, baseline_raw, heatmap), block


#: (device index, block, out mode) -> blocks the card holds at once
_RESIDENT: dict = {}


def _raw_resident(lib, dev: torch.device, block: _build.RawBlock,
                  mode: int) -> int:
    """``dips_raw_resident`` of ``block``'s library on ``dev`` (the
    current device) in out mode ``mode``, asked once a device, block and
    mode (each mode is an instance of its own, with its own registers)."""
    key = (dev.index, block, mode)
    n = _RESIDENT.get(key)
    if n is None:
        n = lib.dips_raw_resident(mode)
        if n < 1:
            _build.check(-n, f"dips_raw_resident ({block.name()} block)",
                         lib)
        _RESIDENT[key] = n
    return n


def absdiff_step_ring_stacked(props: DiPsProperties, h: int, w: int, s: int,
                              raw: torch.Tensor, prev: torch.Tensor,
                              baseline_raw: torch.Tensor, snap_flags,
                              heatmap: torch.Tensor, valid, seeds,
                              row_bounds=None):
    """Raw ring-carry step over ``s`` streams stacked along the rows.

    raw u8 (B, 3, s*Hp, Wp), prev / baseline_raw u8 (3, s*Hp, Wp), heatmap
    f32 (s*Hp, Wp), snap_flags / valid (s, B), seeds (s,) ->
    (out u8 (B, C, s*Hp, Wp), stats f32 (s, B, 4), prev, baseline, heatmap),
    C = 3 (ABSDIFF), 1 (THRESHOLD) or 0 (no map).  State is updated in
    place and returned.  ``row_bounds`` (lo, hi), only with an roi: the
    sections are row slabs of Hp rows, the roi's rows are [lo, hi) of each,
    and the stats are the slab's partials on the full image's scale."""
    name = "absdiff_step_ring_stacked"
    if not _route(name, raw):
        return absdiff_step_ring_stacked_plain(props, h, w, s, raw, prev,
                                               baseline_raw, snap_flags,
                                               heatmap, valid, seeds,
                                               row_bounds)
    res, block = _launch_raw(name, props, h, w, s, raw, prev, baseline_raw,
                             snap_flags, heatmap, valid, seeds, row_bounds)
    _count_launch(absdiff_step_ring_stacked, block, row_bounds=row_bounds)
    return res


absdiff_step_ring_stacked.launches = 0


def absdiff_step_ring(props: DiPsProperties, h: int, w: int,
                      raw: torch.Tensor, prev: torch.Tensor,
                      baseline_raw: torch.Tensor, snap_flags,
                      heatmap: torch.Tensor, valid, seed):
    """Raw ring-carry step of one stream: the stacked step at s = 1.

    raw u8 (B, 3, Hp, Wp), prev / baseline_raw u8 (3, Hp, Wp), heatmap f32
    (Hp, Wp), snap_flags / valid (B,), seed int ->
    (out u8 (B, C, Hp, Wp), stats f32 (B, 4), prev, baseline, heatmap).
    State is updated in place and returned."""
    name = "absdiff_step_ring"
    b = raw.shape[0]
    args = (props, h, w, 1, raw, prev, baseline_raw,
            _one_stream(snap_flags, b, name, "snap_flags"), heatmap,
            _one_stream(valid, b, name, "valid"), [int(seed)])
    if not _route(name, raw):
        out, stats, *state = absdiff_step_ring_stacked_plain(*args)
    else:
        (out, stats, *state), block = _launch_raw(name, *args)
        _count_launch(absdiff_step_ring, block)
    return (out, stats[0], *state)


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


#: spatial filter modes of the median kernels (``median_common.cuh``)
SPATIAL_MODES = ("exact", "approx_median", "quirk_compat")


def spatial_mode(props: DiPsProperties) -> str:
    """The median kernels' spatial filter for ``props``: "exact",
    "approx_median" or "quirk_compat" (the two flags exclude each other)."""
    if props.quirk_compat:
        return "quirk_compat"
    return "approx_median" if props.approx_median else "exact"


def _count_launch(fn, geometry, props: Optional[DiPsProperties] = None,
                  row_bounds=None, bands=None) -> None:
    """One launch of wrapper ``fn`` in ``geometry`` (a ``MedianTile`` or
    ``RawBlock``): its total, its geometry's count, its spatial mode's (the
    median wrappers pass ``props``) and its row-slab form's."""
    fn.launches += 1
    key = geometry.name()
    fn.geometry_launches[key] = fn.geometry_launches.get(key, 0) + 1
    if props is not None:
        fn.mode_launches[spatial_mode(props)] += 1
    if bands is not None:
        fn.form_launches["slab_bands"] += 1
    elif row_bounds is not None:
        fn.form_launches["dyn_rows"] += 1


def _median_frames(props: DiPsProperties, h: int, w: int,
                   phis: torch.Tensor, slots: list, off: int,
                   pv: torch.Tensor, base: torch.Tensor, heat: torch.Tensor,
                   flags, vals, gated: bool, rows=None):
    """Frame loop of the median plain twins, frame by frame as the kernel
    bodies run it (the counterpart of ``_emit_median_frame``): phis f32
    (B, Hp, Wp) the frames' spatial medians, ``slots`` the T ring planes
    (a list, rewritten here), frame m writing slot (off + m) mod T; pv /
    base / heat private planes -> (out, partials (B, 1, 1, 4), pv, base,
    heat).  ``gated`` (ring protocol): invalid frames write no slot, no
    capture and no PER_FRAME advance; the tail protocol's are ungated.
    ``rows`` = (lo, hi): the planes are a row slab and the statistics /
    heatmap mask's rows are [lo, hi) of it."""
    overall = props.method == DiPsMethod.OVERALL
    t = props.temporal_size
    b = phis.shape[0]
    hp, wp = phis.shape[-2], phis.shape[-1]
    mode, c = _median_out_mode(props)
    y0, x0, y1, x1 = props.roi_bounds(h, w)
    if rows is not None:
        y0, y1 = rows
    mask = ref.valid_mask(hp, wp, h, w, (y0, x0, y1, x1),
                          device=phis.device)
    thr = _change_thr(props)
    out = torch.empty((b, c, hp, wp), dtype=torch.uint8, device=phis.device)
    parts = torch.empty((b, 1, 1, 4), dtype=torch.float32,
                        device=phis.device)
    for m in range(b):
        state_ok = bool(vals[m]) or not gated
        if state_ok:
            slots[(off + m) % t] = phis[m]
        cur = ref.temporal_median(slots)
        capture = overall and bool(flags[m]) and state_ok
        if overall:
            if capture:
                base = cur
            diff_i = base - cur
        else:
            diff_i = pv - cur
            if state_ok:
                pv = cur
        rd = diff_i * ref.INTENSITY_SCALE
        dm = rd * mask
        am = dm.abs()
        parts[m, 0, 0, 0] = dm.sum()
        parts[m, 0, 0, 1] = am.sum()
        parts[m, 0, 0, 2] = am.amax()
        parts[m, 0, 0, 3] = (am >= thr).to(torch.float32).sum()
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
    return out, parts, pv, base, heat


def batch_step_ring_plain(props: DiPsProperties, h: int, w: int,
                          raw: torch.Tensor, ring: torch.Tensor,
                          prev: torch.Tensor, baseline: torch.Tensor,
                          snap_flags, heatmap: torch.Tensor, valid, offset,
                          seed, row_bounds=None, bands=None):
    """Plain twin of one stream of the median ring step: raw (B, 3, Hp,
    Wp), flags / valid (B,), offset / seed int -> (out, stats (B, 4), ring,
    prev, baseline, heatmap), state in place.  ``seed`` fills every ring
    slot (and prev, in PER_FRAME) with frame 0.  ``row_bounds`` / ``bands``
    (u8 (B, 3, 8, Wp) each): the row-slab forms."""
    name = "batch_step_ring"
    _check_median_props(name, props)
    t = props.temporal_size
    b = raw.shape[0]
    flags = _host_rows(snap_flags, (b,), name, "snap_flags")
    vals = _host_rows(valid, (b,), name, "valid")
    rows = _row_window(name, row_bounds)
    phis = ref.filtered_planes(
        raw, props,
        _check_bands(name, props, bands, b, 1, raw.shape[-1], views=True))
    slots = [ring[k].clone() for k in range(t)]
    pv = prev.clone()
    if int(seed):
        slots = [phis[0]] * t
        if props.method != DiPsMethod.OVERALL:
            pv = phis[0]
    out, parts, pv, base, heat = _median_frames(
        props, h, w, phis, slots, int(offset) % t, pv, baseline.clone(),
        heatmap.clone(), flags, vals, gated=True, rows=rows)
    for k in range(t):
        ring[k].copy_(slots[k])
    if props.method == DiPsMethod.OVERALL:
        baseline.copy_(base)
    else:
        prev.copy_(pv)
    heatmap.copy_(heat)
    return (out, reduce_median_stats(parts, props, h, w)[0], ring, prev,
            baseline, heatmap)


def batch_step_ring_stacked_plain(props: DiPsProperties, h: int, w: int,
                                  s: int, raw: torch.Tensor,
                                  ring: torch.Tensor, prev: torch.Tensor,
                                  baseline: torch.Tensor, snap_flags,
                                  heatmap: torch.Tensor, valid, offsets,
                                  seeds, row_bounds=None, bands=None):
    """Plain twin of :func:`batch_step_ring_stacked`: the streams are
    independent and the halo stops at each stream's rows, so each stream's
    row section (a view) runs through :func:`batch_step_ring_plain`, and
    its state is written back in place.  With ``bands`` each section reads
    its own 8 band rows, never a neighbouring section's."""
    name = "batch_step_ring_stacked"
    b = raw.shape[0]
    hp = _stream_rows(name, raw, s)
    bands = _check_bands(name, props, bands, b, s, raw.shape[-1])
    flags = _host_rows(snap_flags, (s, b), name, "snap_flags")
    vals = _host_rows(valid, (s, b), name, "valid")
    offs = _host_rows(offsets, (s,), name, "offsets")
    sd = _host_rows(seeds, (s,), name, "seeds")
    outs, stats = [], []
    for si in range(s):
        r = slice(si * hp, (si + 1) * hp)
        o, st, *_ = batch_step_ring_plain(
            props, h, w, raw[:, :, r], ring[:, r], prev[r], baseline[r],
            flags[si], heatmap[r], vals[si], offs[si], sd[si], row_bounds,
            _section_bands(bands, si))
        outs.append(o)
        stats.append(st)
    return (torch.cat(outs, dim=2), torch.stack(stats), ring, prev,
            baseline, heatmap)


def _launch_median(name: str, props: DiPsProperties, h: int, w: int, s: int,
                   raw: torch.Tensor, ring, prev, baseline: torch.Tensor,
                   snap_flags, heatmap: torch.Tensor, valid, offsets, seeds,
                   row_bounds=None, bands=None,
                   tile: Optional[_build.MedianTile] = None,
                   reps: int = 1):
    """One launch over s row-stacked streams of ``csrc/median_ring.cu``,
    or of ``csrc/median_tail.cu`` when ``ring`` is None (raw then starts
    with the T tail frames; there is no ring, prev, offset or seed).
    ``row_bounds`` / ``bands``: the sections are row slabs (the
    ``dyn_rows`` and ``slab_bands`` forms); the statistics keep the full
    image's scale.  ``tile``: the geometry to launch (default
    :func:`median_tile`'s); ``reps``: as in :func:`_launch_raw`.  Raises ``ValueError`` unless a section's
    padded geometry is a whole number of the tile's rows x columns (8 x
    128 by default: the kernels have no ragged tile; ``pad_geometry``
    gives whole 8 x 128 tiles).  Returns (the step's result, the tile
    launched)."""
    _check_median_props(name, props)
    rows = _row_window(name, row_bounds)
    tail = ring is None
    t = props.temporal_size
    b = _new_frames(name, props, raw) if tail else raw.shape[0]
    wp = raw.shape[-1]
    hp = _stream_rows(name, raw, s)
    dev = raw.device
    plane = (s * hp, wp)
    tensors = dict(raw=(raw, torch.uint8, ((t if tail else 0) + b, 3)
                        + plane),
                   baseline=(baseline, torch.float32, plane),
                   heatmap=(heatmap, torch.float32, plane))
    if not tail:
        tensors.update(ring=(ring, torch.float32, (t,) + plane),
                       prev=(prev, torch.float32, plane))
    bands = _check_bands(name, props, bands, raw.shape[0], s, wp)
    if bands is not None:
        band = (raw.shape[0], 3, s * ref.BAND_ROWS, wp)
        tensors.update(top_band=(bands[0], torch.uint8, band),
                       bottom_band=(bands[1], torch.uint8, band))
    _check_cuda(name, dev, **tensors)
    tile = tile or median_tile(props, hp, s, tail, bands is not None, dev)
    unit = _build.median_unit(tail, props.window_size)
    lib = _build.kernel_lib(_build.Geometry(tile=tile), unit)
    fn = _build.median_symbol(tail, props.window_size)
    n_parts = getattr(lib, _build.median_symbol(
        tail, props.window_size, "parts"))(hp, wp)
    if n_parts < 1:
        raise ValueError(f"{name}: padded geometry {hp}x{wp} is not a whole "
                         f"number of the kernels' {tile.rows} x {tile.cols} "
                         f"tiles (pad_geometry's is of 8 x 128)")
    items = [("snap_flags", snap_flags, (s, b)), ("valid", valid, (s, b))]
    if not tail:
        offsets = offsets % t if isinstance(offsets, torch.Tensor) \
            else np.asarray(offsets) % t
        items += [("offsets", offsets, (s,)), ("seeds", seeds, (s,))]
    scalars = _stream_i32(name, dev, items)
    mode, c = _median_out_mode(props)
    out = torch.empty((b, c) + plane, dtype=torch.uint8, device=dev)
    parts = torch.empty((b, s, n_parts, 4), dtype=torch.float32, device=dev)
    y0, x0, y1, x1 = props.roi_bounds(h, w)
    if rows is not None:
        y0, y1 = rows
    band_ptrs = ((ctypes.c_void_p(None),) * 2 if bands is None
                 else tuple(map(_ptr, bands)))
    common = (s, b, hp, wp, t, props.window_size,
              SPATIAL_MODES.index(spatial_mode(props)),
              int(props.method == DiPsMethod.OVERALL), mode,
              _CHROMA_CODE[props.chroma], _FILTER_CODE[props.filter],
              _f32(props.sigmoid_horizontal_scalar), _f32(props.sensitivity),
              _f32(-0.5 + ref.INV_SIGMOID_EPS),
              _f32(0.5 - ref.INV_SIGMOID_EPS), ref.INTENSITY_SCALE,
              _change_thr(props), y0, x0, y1, x1, _stream_ptr(dev))
    with torch.cuda.device(dev):  # see _launch_raw
        for _ in range(reps):
            if tail:
                rc = getattr(lib, fn)(
                    _ptr(raw), *band_ptrs, _ptr(baseline), _ptr(heatmap),
                    _ptr(out), _ptr(parts), *map(_ptr, scalars), *common)
            else:
                rc = getattr(lib, fn)(
                    _ptr(raw), *band_ptrs, _ptr(ring), _ptr(prev),
                    _ptr(baseline), _ptr(heatmap), _ptr(out), _ptr(parts),
                    *map(_ptr, scalars), *common)
            _build.check(rc, f"{name} ({tile.name()} tile)", lib)
    stats = reduce_median_stats(parts, props, h, w)
    if tail:
        return (out, stats, baseline, heatmap), tile
    return (out, stats, ring, prev, baseline, heatmap), tile


def batch_step_ring_stacked(props: DiPsProperties, h: int, w: int, s: int,
                            raw: torch.Tensor, ring: torch.Tensor,
                            prev: torch.Tensor, baseline: torch.Tensor,
                            snap_flags, heatmap: torch.Tensor, valid,
                            offsets, seeds, row_bounds=None, bands=None):
    """Median ring-carry step over ``s`` streams stacked along the rows.

    raw u8 (B, 3, s*Hp, Wp), ring f32 (T, s*Hp, Wp), prev / baseline /
    heatmap f32 (s*Hp, Wp), snap_flags / valid (s, B), offsets / seeds (s,)
    -> (out u8 (B, C, s*Hp, Wp), stats f32 (s, B, 4), ring, prev, baseline,
    heatmap), C = 3 (COLORIZE), 1 (GRAYSCALE) or 0 (``emit_maps=False``).
    The spatial halo stops at each stream's rows.  State is updated in place
    and returned.

    Row slabs: with ``row_bounds`` (lo, hi) the sections are slabs of Hp
    rows, the statistics / heatmap mask's rows are [lo, hi) of each, and the
    stats are the slab's partials on the full image's scale (sum, sum, max,
    sum over the slabs of a stream give its stats).  With ``bands`` = (top,
    bottom) u8 (B, 3, s*8, Wp) the window's taps above / below a section
    read the last / first rows of its own 8 band rows instead of zeros
    (window 1 has no taps there and raises)."""
    name = "batch_step_ring_stacked"
    if not _route(name, raw):
        return batch_step_ring_stacked_plain(props, h, w, s, raw, ring, prev,
                                             baseline, snap_flags, heatmap,
                                             valid, offsets, seeds,
                                             row_bounds, bands)
    res, tile = _launch_median(name, props, h, w, s, raw, ring, prev,
                               baseline, snap_flags, heatmap, valid, offsets,
                               seeds, row_bounds, bands)
    _count_launch(batch_step_ring_stacked, tile, props, row_bounds, bands)
    return res


batch_step_ring_stacked.launches = 0


def batch_step_ring(props: DiPsProperties, h: int, w: int,
                    raw: torch.Tensor, ring: torch.Tensor,
                    prev: torch.Tensor, baseline: torch.Tensor, snap_flags,
                    heatmap: torch.Tensor, valid, offset, seed):
    """Median ring-carry step of one stream: the stacked step at s = 1.

    raw u8 (B, 3, Hp, Wp), ring f32 (T, Hp, Wp), prev / baseline / heatmap
    f32 (Hp, Wp), snap_flags / valid (B,), offset / seed int ->
    (out u8 (B, C, Hp, Wp), stats f32 (B, 4), ring, prev, baseline,
    heatmap).  State is updated in place and returned."""
    name = "batch_step_ring"
    b = raw.shape[0]
    args = (props, h, w, 1, raw, ring, prev, baseline,
            _one_stream(snap_flags, b, name, "snap_flags"), heatmap,
            _one_stream(valid, b, name, "valid"), [int(offset)], [int(seed)])
    if not _route(name, raw):
        out, stats, *state = batch_step_ring_stacked_plain(*args)
    else:
        (out, stats, *state), tile = _launch_median(name, *args)
        _count_launch(batch_step_ring, tile, props)
    return (out, stats[0], *state)


batch_step_ring.launches = 0

# ---------------------------------------------------------------------------
# Kernel 3: raw tail step
# ---------------------------------------------------------------------------

def absdiff_step_plain(props: DiPsProperties, h: int, w: int,
                       raw: torch.Tensor, baseline_raw: torch.Tensor,
                       snap_flags, heatmap: torch.Tensor, valid,
                       row_bounds=None):
    """Plain twin of one stream of the raw tail step: raw (T+B, 3, Hp, Wp),
    flags / valid (B,) -> (out, stats (B, 4), baseline, heatmap), state in
    place.  OVERALL reads only the B new frames; PER_FRAME starts from the
    tail's last frame."""
    name = "absdiff_step"
    t = props.temporal_size
    b = _new_frames(name, props, raw)
    flags = _host_rows(snap_flags, (b,), name, "snap_flags")
    vals = _host_rows(valid, (b,), name, "valid")
    rows = _raw_row_window(name, props, row_bounds)
    overall = props.method == DiPsMethod.OVERALL
    refi = (baseline_raw if overall else raw[t - 1]).to(torch.int32)
    out, parts, refi, heat = _raw_frames(props, h, w, raw[t:], refi, flags,
                                         vals, heatmap.clone(), gated=False,
                                         rows=rows)
    if overall:
        baseline_raw.copy_(refi.to(torch.uint8))
    heatmap.copy_(heat)
    return (out, reduce_raw_stats(parts, props, h, w)[0], baseline_raw,
            heatmap)


def absdiff_step_stacked_plain(props: DiPsProperties, h: int, w: int, s: int,
                               raw: torch.Tensor, baseline_raw: torch.Tensor,
                               snap_flags, heatmap: torch.Tensor, valid,
                               row_bounds=None):
    """Plain twin of :func:`absdiff_step_stacked`: each stream's row
    section (a view) runs through :func:`absdiff_step_plain`."""
    name = "absdiff_step_stacked"
    b = _new_frames(name, props, raw)
    hp = _stream_rows(name, raw, s)
    flags = _host_rows(snap_flags, (s, b), name, "snap_flags")
    vals = _host_rows(valid, (s, b), name, "valid")
    outs, stats = [], []
    for si in range(s):
        r = slice(si * hp, (si + 1) * hp)
        o, st, *_ = absdiff_step_plain(props, h, w, raw[:, :, r],
                                       baseline_raw[:, r], flags[si],
                                       heatmap[r], vals[si], row_bounds)
        outs.append(o)
        stats.append(st)
    return torch.cat(outs, dim=2), torch.stack(stats), baseline_raw, heatmap


def absdiff_step_stacked(props: DiPsProperties, h: int, w: int, s: int,
                         raw: torch.Tensor, baseline_raw: torch.Tensor,
                         snap_flags, heatmap: torch.Tensor, valid,
                         row_bounds=None):
    """Raw tail step over ``s`` streams stacked along the rows.

    raw u8 (T+B, 3, s*Hp, Wp), the T tail frames first; baseline_raw u8
    (3, s*Hp, Wp); heatmap f32 (s*Hp, Wp); snap_flags / valid (s, B) ->
    (out u8 (B, C, s*Hp, Wp), stats f32 (s, B, 4), baseline, heatmap).
    Capture is not gated on ``valid``.  State is updated in place and
    returned.  ``row_bounds``: the row-slab form, as in
    :func:`absdiff_step_ring_stacked`."""
    name = "absdiff_step_stacked"
    if not _route(name, raw):
        return absdiff_step_stacked_plain(props, h, w, s, raw, baseline_raw,
                                          snap_flags, heatmap, valid,
                                          row_bounds)
    res, block = _launch_raw(name, props, h, w, s, raw, None, baseline_raw,
                             snap_flags, heatmap, valid, None, row_bounds)
    _count_launch(absdiff_step_stacked, block, row_bounds=row_bounds)
    return res


absdiff_step_stacked.launches = 0


def absdiff_step(props: DiPsProperties, h: int, w: int, raw: torch.Tensor,
                 baseline_raw: torch.Tensor, snap_flags,
                 heatmap: torch.Tensor, valid):
    """Raw tail step of one stream: the stacked step at s = 1.

    raw u8 (T+B, 3, Hp, Wp), baseline_raw u8 (3, Hp, Wp), heatmap f32
    (Hp, Wp), snap_flags / valid (B,) -> (out u8 (B, C, Hp, Wp), stats f32
    (B, 4), baseline, heatmap).  State is updated in place and returned."""
    name = "absdiff_step"
    b = _new_frames(name, props, raw)
    flags = _one_stream(snap_flags, b, name, "snap_flags")
    vals = _one_stream(valid, b, name, "valid")
    if not _route(name, raw):
        out, stats, *state = absdiff_step_stacked_plain(
            props, h, w, 1, raw, baseline_raw, flags, heatmap, vals)
    else:
        (out, stats, *state), block = _launch_raw(
            name, props, h, w, 1, raw, None, baseline_raw, flags, heatmap,
            vals, None)
        _count_launch(absdiff_step, block)
    return (out, stats[0], *state)


absdiff_step.launches = 0


# ---------------------------------------------------------------------------
# Kernel 4: median tail step
# ---------------------------------------------------------------------------

def batch_step_plain(props: DiPsProperties, h: int, w: int,
                     raw: torch.Tensor, baseline: torch.Tensor, snap_flags,
                     heatmap: torch.Tensor, valid, row_bounds=None,
                     bands=None):
    """Plain twin of one stream of the median tail step: raw (T+B, 3, Hp,
    Wp), flags / valid (B,) -> (out, stats (B, 4), baseline, heatmap),
    state in place.  The T tail frames fill the ring (slot k = tail frame
    k); PER_FRAME's first reference is their median.  ``row_bounds`` /
    ``bands`` (u8 (T+B, 3, 8, Wp) each, the tail frames' rows included):
    the row-slab forms."""
    name = "batch_step"
    _check_median_props(name, props)
    t = props.temporal_size
    b = _new_frames(name, props, raw)
    flags = _host_rows(snap_flags, (b,), name, "snap_flags")
    vals = _host_rows(valid, (b,), name, "valid")
    rows = _row_window(name, row_bounds)
    phis = ref.filtered_planes(
        raw, props,
        _check_bands(name, props, bands, t + b, 1, raw.shape[-1],
                     views=True))
    slots = [phis[k] for k in range(t)]
    out, parts, _, base, heat = _median_frames(
        props, h, w, phis[t:], slots, 0, ref.temporal_median(slots),
        baseline.clone(), heatmap.clone(), flags, vals, gated=False,
        rows=rows)
    if props.method == DiPsMethod.OVERALL:
        baseline.copy_(base)
    heatmap.copy_(heat)
    return (out, reduce_median_stats(parts, props, h, w)[0], baseline,
            heatmap)


def batch_step_stacked_plain(props: DiPsProperties, h: int, w: int, s: int,
                             raw: torch.Tensor, baseline: torch.Tensor,
                             snap_flags, heatmap: torch.Tensor, valid,
                             row_bounds=None, bands=None):
    """Plain twin of :func:`batch_step_stacked`: the halo stops at each
    stream's rows, so each stream's row section (a view) runs through
    :func:`batch_step_plain`."""
    name = "batch_step_stacked"
    b = _new_frames(name, props, raw)
    hp = _stream_rows(name, raw, s)
    flags = _host_rows(snap_flags, (s, b), name, "snap_flags")
    vals = _host_rows(valid, (s, b), name, "valid")
    bands = _check_bands(name, props, bands, raw.shape[0], s, raw.shape[-1])
    outs, stats = [], []
    for si in range(s):
        r = slice(si * hp, (si + 1) * hp)
        o, st, *_ = batch_step_plain(props, h, w, raw[:, :, r], baseline[r],
                                     flags[si], heatmap[r], vals[si],
                                     row_bounds, _section_bands(bands, si))
        outs.append(o)
        stats.append(st)
    return torch.cat(outs, dim=2), torch.stack(stats), baseline, heatmap


def batch_step_stacked(props: DiPsProperties, h: int, w: int, s: int,
                       raw: torch.Tensor, baseline: torch.Tensor, snap_flags,
                       heatmap: torch.Tensor, valid, row_bounds=None,
                       bands=None):
    """Median tail step over ``s`` streams stacked along the rows.

    raw u8 (T+B, 3, s*Hp, Wp), the T tail frames first; baseline / heatmap
    f32 (s*Hp, Wp); snap_flags / valid (s, B) -> (out u8 (B, C, s*Hp, Wp),
    stats f32 (s, B, 4), baseline, heatmap).  The ring is rebuilt from the
    tail at every call; capture and the PER_FRAME advance are not gated on
    ``valid``.  State is updated in place and returned.  ``row_bounds`` /
    ``bands`` (u8 (T+B, 3, s*8, Wp) each): the row-slab forms, as in
    :func:`batch_step_ring_stacked`; the bands cover the tail frames too."""
    name = "batch_step_stacked"
    if not _route(name, raw):
        return batch_step_stacked_plain(props, h, w, s, raw, baseline,
                                        snap_flags, heatmap, valid,
                                        row_bounds, bands)
    res, tile = _launch_median(name, props, h, w, s, raw, None, None,
                               baseline, snap_flags, heatmap, valid, None,
                               None, row_bounds, bands)
    _count_launch(batch_step_stacked, tile, props, row_bounds, bands)
    return res


batch_step_stacked.launches = 0


def batch_step(props: DiPsProperties, h: int, w: int, raw: torch.Tensor,
               baseline: torch.Tensor, snap_flags, heatmap: torch.Tensor,
               valid):
    """Median tail step of one stream: the stacked step at s = 1.

    raw u8 (T+B, 3, Hp, Wp), baseline / heatmap f32 (Hp, Wp), snap_flags /
    valid (B,) -> (out u8 (B, C, Hp, Wp), stats f32 (B, 4), baseline,
    heatmap).  State is updated in place and returned."""
    name = "batch_step"
    b = _new_frames(name, props, raw)
    flags = _one_stream(snap_flags, b, name, "snap_flags")
    vals = _one_stream(valid, b, name, "valid")
    if not _route(name, raw):
        out, stats, *state = batch_step_stacked_plain(
            props, h, w, 1, raw, baseline, flags, heatmap, vals)
    else:
        (out, stats, *state), tile = _launch_median(
            name, props, h, w, 1, raw, None, None, baseline, flags, heatmap,
            vals, None, None)
        _count_launch(batch_step, tile, props)
    return (out, stats[0], *state)


batch_step.launches = 0


# ---------------------------------------------------------------------------
# The box mean of a downscaled engine's layout prep (csrc/pool_prep.cu)
# ---------------------------------------------------------------------------

def pool_prep_plain(frames: torch.Tensor, out: torch.Tensor, k: int,
                    swap_rb: bool = False) -> torch.Tensor:
    """The plain twin of :func:`pool_prep`: the layout prep of
    ``reference.make_layout_prep(downscale=k)``, a chain of plain torch
    ops (int32 sum, float32 product, round, uint8, permute-copy)."""
    h, w = frames.shape[-3] // k, frames.shape[-2] // k
    _, prep = ref.make_layout_prep("hwc_bgr" if swap_rb else "hwc", h, w,
                                   out.shape[-2], out.shape[-1],
                                   downscale=k)
    return prep(frames, out=out)


def pool_prep_lib():
    """The library of ``csrc/pool_prep.cu``, built (or loaded) at the
    first call of a process: a downscaled engine on a card calls it when
    it is made, so that no batch waits for the build."""
    return _build.lib(units=(_build.POOL_UNIT,))


def pool_prep(frames: torch.Tensor, out: torch.Tensor, k: int,
              swap_rb: bool = False) -> torch.Tensor:
    """The k x k box mean of uint8 hwc frames (..., H*k, W*k, 3), rounded
    half to even (bit-equal to ``reference.pool_frame_host``), written
    into the true H x W region of the padded planar rows ``out``
    (..., 3, Hp, Wp), R and B swapped with ``swap_rb`` (the hwc_bgr
    layout); the padding is not written.  The leading dims are (n,) or a
    fleet's (S, F); ``frames`` is contiguous, ``out`` may be a strided
    view whose columns are contiguous (the fleet's input seen as
    (S, F, 3, Hp, Wp)).  CUDA tensors launch ``csrc/pool_prep.cu``
    (:func:`pool_prep_lib`); CPU tensors run :func:`pool_prep_plain`.
    Returns ``out``."""
    name = "pool_prep"
    k = int(k)
    lead = tuple(frames.shape[:-3])
    if k < 2:
        raise ValueError(f"{name}: k={k}; k = 1 is the plain layout prep")
    if (frames.dim() not in (4, 5) or frames.shape[-1] != 3
            or tuple(out.shape[:-3]) != lead or out.shape[-3] != 3):
        raise ValueError(f"{name}: frames {tuple(frames.shape)} and out "
                         f"{tuple(out.shape)} are not (..., H*k, W*k, 3) "
                         f"and (..., 3, Hp, Wp) with the same leading dims")
    hk, wk = frames.shape[-3], frames.shape[-2]
    if hk % k or wk % k:
        raise ValueError(f"{name}: k={k} does not divide {hk}x{wk}")
    h, w = hk // k, wk // k
    if h > out.shape[-2] or w > out.shape[-1]:
        raise ValueError(f"{name}: {h}x{w} does not fit the planar rows "
                         f"{tuple(out.shape[-2:])}")
    if frames.dtype != torch.uint8 or out.dtype != torch.uint8:
        raise TypeError(f"{name}: frames and out must be uint8")
    if not _route(name, frames):
        return pool_prep_plain(frames, out, k, swap_rb)
    dev = frames.device
    if out.device != dev:
        raise ValueError(f"{name}: out is on {out.device}, frames on {dev}")
    if not frames.is_contiguous():
        raise ValueError(f"{name}: frames must be contiguous")
    if out.stride(-1) != 1:
        raise ValueError(f"{name}: out's columns must be contiguous")
    st = out.stride()
    s, f = (1, lead[0]) if len(lead) == 1 else lead
    o_stream = st[0] if len(lead) == 2 else 0
    if s * f == 0:
        return out
    with torch.cuda.device(dev):
        lib = pool_prep_lib()
        rc = lib.dips_pool_prep(
            _ptr(frames), _ptr(out), s, f, h, w, k, o_stream, st[-4],
            st[-3], st[-2], int(bool(swap_rb)), _f32(1.0 / (k * k)),
            _stream_ptr(dev))
        if rc:
            _build.check(rc, name, lib)
    pool_prep.launches += 1
    return out


pool_prep.launches = 0

_KERNELS = (absdiff_step_ring, batch_step_ring, absdiff_step_ring_stacked,
            batch_step_ring_stacked, absdiff_step, batch_step,
            absdiff_step_stacked, batch_step_stacked)
_MEDIAN_KERNELS = (batch_step_ring, batch_step_ring_stacked, batch_step,
                   batch_step_stacked)
#: wrapper -> its row-slab forms (the raw steps have no stencil: no bands)
_SLAB_KERNELS = {absdiff_step_ring_stacked: SLAB_FORMS[:1],
                 absdiff_step_stacked: SLAB_FORMS[:1],
                 batch_step_ring_stacked: SLAB_FORMS,
                 batch_step_stacked: SLAB_FORMS}


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0, per geometry, form and
    spatial mode too, and :func:`pool_prep`'s."""
    pool_prep.launches = 0
    for fn in _KERNELS:
        fn.launches = 0
        fn.geometry_launches = {}
    for fn in _SLAB_KERNELS:
        fn.form_launches = dict.fromkeys(SLAB_FORMS, 0)
    for fn in _MEDIAN_KERNELS:
        fn.mode_launches = dict.fromkeys(SPATIAL_MODES, 0)


def launch_counts() -> dict:
    """Launches per wrapper (``name``: all its launches), per row-slab
    form of the stacked wrappers (``name:dyn_rows``: with ``row_bounds``
    and no bands; ``name:slab_bands``: with bands) and, for the median
    wrappers, per non-exact spatial mode (``name:approx_median``,
    ``name:quirk_compat``); and ``pool_prep``, the box mean's."""
    counts = {fn.__name__: fn.launches for fn in _KERNELS}
    counts[pool_prep.__name__] = pool_prep.launches
    for fn, forms in _SLAB_KERNELS.items():
        for form in forms:
            counts[f"{fn.__name__}:{form}"] = fn.form_launches[form]
    for fn in _MEDIAN_KERNELS:
        for mode in SPATIAL_MODES[1:]:
            counts[f"{fn.__name__}:{mode}"] = fn.mode_launches[mode]
    return counts


def geometry_counts() -> dict:
    """Launches per wrapper and geometry: {name: {geometry name: n}}, for
    the wrappers that launched."""
    return {fn.__name__: dict(fn.geometry_launches) for fn in _KERNELS
            if fn.geometry_launches}


reset_launch_counts()
