"""Deployment acceptance check: on-device parity against the numpy oracle.

Counterpart of ``dips_tpu/validate.py``.  ``python -m dips_tpu_torch.validate
[--device cuda|cpu] [--quick] [--with-soak N] [--json PATH]`` runs the
pipeline's CUDA kernels on the card (``--device cuda``, the default; their
plain PyTorch twins with ``--device cpu``, only when asked for) and asserts
the numerics contract against ``ops/oracle.py``: integer modes byte-exact,
f32 modes within 1 LSB, statistics and heatmaps to float tolerance.  Every
case runs on both step protocols (ring-carry and tail); the gates then hold
the stacked, row-slab, band and layout forms against the full-height
single-stream steps on the same device.  Exit code 0 = this torch / CUDA /
dips_tpu_torch stack computes the right answer on this host.  Without a
card ``--device cuda`` exits 1 with the ``DeviceError``: it never drops to
the CPU.  The case names are the JAX check's, so the two ``--json``
artifacts line up case by case.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .errors import DeviceError
from .models import DiPsEngine
from .models.pipeline import resolve_device
from .ops import cuda_fused, reference
from .ops.oracle import DiPsOracle
from .ops.reference import pad_geometry
from .properties import (DiPsFilter, DiPsMethod, DiPsProperties,
                         OutputMode)


def _clip(n=10, h=24, w=140, seed=0):
    r = np.random.default_rng(seed)
    base = r.integers(0, 256, (h, w, 3), np.uint8)
    frames = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        f = base.copy()
        f[(2 + 2 * i) % (h - 5):(2 + 2 * i) % (h - 5) + 5,
          (3 + 5 * i) % (w - 5):(3 + 5 * i) % (w - 5) + 5] = 255
        frames[i] = f
    return frames


CASES = [
    ("overall/colorize/sigmoid/w3/t4", DiPsProperties(), False),
    ("overall/colorize/unfiltered/w5/t2",
     DiPsProperties(window_size=5, temporal_size=2,
                    filter=DiPsFilter.UNFILTERED), True),
    ("per_frame/gray/inv_sig/w3/t3",
     DiPsProperties(method=DiPsMethod.PER_FRAME,
                    output=OutputMode.GRAYSCALE,
                    filter=DiPsFilter.INVERSE_SIGMOID, temporal_size=3),
     False),
    ("overall/absdiff (cv2 parity)",
     DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2), True),
    ("per_frame/threshold",
     DiPsProperties(method=DiPsMethod.PER_FRAME,
                    output=OutputMode.THRESHOLD, temporal_size=2,
                    change_threshold=20), True),
    ("overall/colorize/w7 + markers",
     DiPsProperties(window_size=7, temporal_size=2,
                    filter=DiPsFilter.UNFILTERED, refresh_markers=(5,)),
     True),
    ("overall/colorize/w7 approx-median",
     DiPsProperties(window_size=7, temporal_size=2,
                    filter=DiPsFilter.UNFILTERED, approx_median=True),
     True),
    ("overall/colorize/w5 quirk-compat",
     DiPsProperties(window_size=5, temporal_size=2,
                    filter=DiPsFilter.UNFILTERED, quirk_compat=True), True),
    ("overall/stats_only (no-map fleet mode)",
     DiPsProperties(output=OutputMode.STATS_ONLY, temporal_size=2,
                    refresh_markers=(5,)), True),
    ("overall/median no-maps (emit_maps=False)",
     DiPsProperties(window_size=3, temporal_size=2,
                    filter=DiPsFilter.UNFILTERED, emit_maps=False,
                    refresh_markers=(5,)), True),
    ("overall/absdiff + roi (analysis region)",
     DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2,
                    roi=(4, 10, 20, 120)), True),
    ("per_frame/colorize + roi",
     DiPsProperties(method=DiPsMethod.PER_FRAME, temporal_size=2,
                    filter=DiPsFilter.UNFILTERED, roi=(4, 10, 20, 120)),
     True),
]

#: rows of each neighbour band of a slab section (``ops/reference.py``)
_BAND = reference.BAND_ROWS


def _record(results, case: str, ok: bool, t0: float, error=None, **extra):
    """Append one machine-readable case outcome (``--json`` artifact);
    ``extra``: more keys of the case (the soak's frames/s)."""
    if results is not None:
        results.append({"case": case, "ok": bool(ok),
                        "seconds": round(time.time() - t0, 2),
                        **({"error": str(error)[:500]} if error else {}),
                        **extra})


def _gate(name: str, body, verbose: bool, results) -> int:
    """Run one gate: PASS / FAIL line and record; 1 on failure."""
    t0 = time.time()
    try:
        body()
    except Exception as e:
        if verbose:
            print(f"  FAIL {name:<40s} {e}")
        _record(results, name, False, t0, e)
        return 1
    if verbose:
        print(f"  PASS {name:<40s} ({time.time() - t0:.1f}s)")
    _record(results, name, True, t0)
    return 0


def _on(device):
    """Host array -> contiguous tensor on ``device``; zeros of a shape."""
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    zeros = lambda shape, dtype=torch.float32: torch.zeros(
        shape, dtype=dtype, device=device)
    return put, zeros


def _host(x) -> np.ndarray:
    return x.cpu().numpy()


def _padded_noise(r, shape, h, w):
    """Seeded u8 planar frames, zero outside the true (h, w) region."""
    raw = r.integers(0, 256, shape, np.uint8)
    raw[..., h:, :] = 0
    raw[..., w:] = 0
    return raw


def _halo_slabs(raw, hs: int):
    """The two halo-extended slabs of a 2-shard row split of planar
    ``raw`` (..., 2*hs, Wp), as the neighbour exchange delivers them: slab
    0 = a zero top halo | rows [0, hs) | rows [hs, hs+8); slab 1 = rows
    [hs-8, hs) | rows [hs, 2*hs) | a zero bottom halo."""
    zrow = np.zeros(raw.shape[:-2] + (_BAND, raw.shape[-1]), np.uint8)
    return (np.concatenate([zrow, raw[..., :hs, :],
                            raw[..., hs:hs + _BAND, :]], axis=-2),
            np.concatenate([raw[..., hs - _BAND:hs, :], raw[..., hs:, :],
                            zrow], axis=-2))


def _section_bands(raw, hs: int):
    """The (top, bottom) bands of the two stacked sections [0, hs) and
    [hs, 2*hs) of planar ``raw``: zeros at the global edges, the other
    section's 8 boundary rows in between."""
    zband = np.zeros(raw.shape[:-2] + (_BAND, raw.shape[-1]), np.uint8)
    return (np.concatenate([zband, raw[..., hs - _BAND:hs, :]], axis=-2),
            np.concatenate([raw[..., hs:hs + _BAND, :], zband], axis=-2))


def _check_slab_stats(got, exp, sum_atol=1e-5, max_atol=1e-6):
    """Two row slabs' partial stats (2, B, 4) against the full-height
    stats (B, 4): sum, sum, max, sum."""
    np.testing.assert_allclose(got[0, :, :2] + got[1, :, :2], exp[:, :2],
                               atol=sum_atol)
    np.testing.assert_allclose(np.maximum(got[0, :, 2], got[1, :, 2]),
                               exp[:, 2], atol=max_atol)
    np.testing.assert_allclose(got[0, :, 3] + got[1, :, 3], exp[:, 3],
                               atol=0)


def _run_stacked(device, verbose: bool, results=None) -> int:
    """Stacked-stream kernels (the fleet's launch): two streams in one
    launch must match per-stream launches on THIS device."""
    put, zeros = _on(device)

    def body():
        s, t, b, h, w = 2, 2, 4, 24, 140
        hp, wp = pad_geometry(h, w)
        r = np.random.default_rng(1)
        raws = [r.integers(0, 256, (t + b, 3, hp, wp), np.uint8)
                for _ in range(s)]
        stacked = np.concatenate(raws, axis=2)
        flags = np.zeros((s, b), bool)
        flags[:, 0] = True
        valid = np.ones((s, b), bool)
        for st, one, lead, dtype in [
            (cuda_fused.batch_step_stacked, cuda_fused.batch_step, (),
             torch.float32),
            (cuda_fused.absdiff_step_stacked, cuda_fused.absdiff_step, (3,),
             torch.uint8),
        ]:
            props = (DiPsProperties(window_size=3, temporal_size=t,
                                    filter=DiPsFilter.UNFILTERED)
                     if one is cuda_fused.batch_step
                     else DiPsProperties(output=OutputMode.ABSDIFF,
                                         temporal_size=t))
            out_s, stats_s, _, _ = st(
                props, h, w, s, put(stacked), zeros(lead + (s * hp, wp),
                                                    dtype),
                flags, zeros((s * hp, wp)), valid)
            out_s, stats_s = _host(out_s), _host(stats_s)
            for si in range(s):
                o1, st1, _, _ = one(
                    props, h, w, put(raws[si]), zeros(lead + (hp, wp), dtype),
                    flags[si], zeros((hp, wp)), valid[si])
                d = np.abs(out_s[:, :, si * hp:(si + 1) * hp]
                           .astype(np.int16) - _host(o1).astype(np.int16))
                assert d.max() == 0, f"stacked stream {si} diff {d.max()}"
                np.testing.assert_allclose(stats_s[si], _host(st1),
                                           atol=1e-5)

    return _gate("stacked 2-stream kernels", body, verbose, results)


def _run_slab(device, verbose: bool, results=None) -> int:
    """Row-slab kernel form (``parallel/grid2d.py``'s extended
    construction): the ``row_bounds`` mask-row window must be bit-identical
    to the full-height kernel ON THIS DEVICE.  Emulates a 2-shard row split
    of one stream: the halo-extended slabs are built exactly as the
    neighbour exchange delivers them (real neighbour rows interior, zeros
    at the global edges)."""
    put, zeros = _on(device)

    def body():
        t, b, h, w = 2, 4, 32, 140
        hp, wp = pad_geometry(h, w)
        hs = hp // 2  # 16-row slabs (8-aligned)
        ext = _BAND
        props = DiPsProperties(window_size=3, temporal_size=t,
                               filter=DiPsFilter.UNFILTERED,
                               roi=(4, 10, 28, 120))
        r = np.random.default_rng(2)
        raw = _padded_noise(r, (t + b, 3, hp, wp), h, w)
        flags = np.zeros((b,), bool)
        flags[0] = True
        valid = np.ones((1, b), bool)
        y0, x0, y1, x1 = props.roi_bounds(h, w)
        outs, statss, nbs, nhs = [], [], [], []
        for k, slab in enumerate(_halo_slabs(raw, hs)):
            row0 = k * hs
            lo = int(np.clip(y0 - row0, 0, hs)) + ext
            hi = int(np.clip(y1 - row0, 0, hs)) + ext
            o, st, nb, nh = cuda_fused.batch_step_stacked(
                props, h, w, 1, put(slab), zeros((hs + 2 * ext, wp)),
                flags[None], zeros((hs + 2 * ext, wp)), valid,
                row_bounds=(lo, hi))
            outs.append(_host(o)[..., ext:ext + hs, :])
            statss.append(_host(st[0]))
            nbs.append(_host(nb)[ext:ext + hs])
            nhs.append(_host(nh)[ext:ext + hs])
        eo, es, eb, eh = cuda_fused.batch_step(
            props, h, w, put(raw), zeros((hp, wp)), flags, zeros((hp, wp)),
            valid[0])
        assert (np.concatenate(outs, axis=-2) == _host(eo)).all(), \
            "slab out != full kernel"
        _check_slab_stats(np.stack(statss), _host(es))
        assert (np.concatenate(nbs, axis=-2) == _host(eb)).all(), \
            "slab baseline diverged"
        assert (np.concatenate(nhs, axis=-2) == _host(eh)).all(), \
            "slab heatmap diverged"

    return _gate("row-slab dyn-bounds kernel", body, verbose, results)


def _band_sections(device, props, seed, name: str, capture_first: bool):
    """A 2-section band-form ring launch (one stream's two row halves as
    the stacked sections, the bands built exactly as the neighbour
    exchange delivers them: zeros at the global edges, the other section's
    boundary rows interior) against the full-height ring kernel over two
    carried batches: the maps (or their absence) bit for bit, stats by
    sum / sum / max / sum, every piece of carried state bit for bit.
    ``capture_first``: the first frame captures the baseline."""
    put, zeros = _on(device)
    t, b, h, w = props.temporal_size, 4, 32, 140
    hp, wp = pad_geometry(h, w)
    hs = hp // 2  # 16-row owned sections (8-aligned)
    r = np.random.default_rng(seed)
    valid = np.ones((1, b), bool)
    # the band path updates its state in place: the full-height path keeps
    # its own tensors
    ring, er = zeros((t, hp, wp)), zeros((t, hp, wp))
    prev, ep = zeros((hp, wp)), zeros((hp, wp))
    base, eb = zeros((hp, wp)), zeros((hp, wp))
    heat, eh = zeros((hp, wp)), zeros((hp, wp))
    offs, seeds = np.zeros(2, np.int32), np.ones(2, np.int32)
    for bi in range(2):
        raw = _padded_noise(r, (b, 3, hp, wp), h, w)
        bands = tuple(put(x) for x in _section_bands(raw, hs))
        fl = np.zeros((2, b), bool)
        fl[:, 0] = bi == 0 and capture_first
        out, stats, *_ = cuda_fused.batch_step_ring_stacked(
            props, h, w, 2, put(raw), ring, prev, base, fl, heat,
            np.ones((2, b), bool), offs, seeds, row_bounds=(0, hs),
            bands=bands)
        eo, es, *_ = cuda_fused.batch_step_ring(
            props, h, w, put(raw), er, ep, eb, fl[0], eh, valid[0],
            int(offs[0]), int(seeds[0]))
        if props.out_channels:
            assert (_host(out) == _host(eo)).all(), \
                f"batch {bi}: band-slab out != full-height ring kernel"
        else:
            assert out.shape[1] == 0, "no-maps run emitted map channels"
        _check_slab_stats(_host(stats), _host(es))
        for nm, a, e in (("ring", ring, er), ("prev", prev, ep),
                         ("baseline", base, eb), ("heatmap", heat, eh)):
            assert torch.equal(a, e), f"batch {bi}: {name} {nm} state " \
                                      f"diverged"
        offs = (offs + b) % t
        seeds = np.zeros(2, np.int32)


def _run_slab_bands(device, verbose: bool, results=None) -> int:
    """Band-form slab construction (``parallel/grid2d.py``
    ``slab_impl="bands"``): the ring kernel's stacked sections read their
    boundary stencil taps from thin 8-row neighbour-band inputs instead of
    zeros.  Window 5 reads 2 band rows; PER_FRAME carries prev."""
    props = DiPsProperties(window_size=5, temporal_size=2,
                           method=DiPsMethod.PER_FRAME,
                           filter=DiPsFilter.UNFILTERED)
    return _gate("slab-bands ring kernel (2-section)",
                 lambda: _band_sections(device, props, 5, "band-slab",
                                        False),
                 verbose, results)


def _run_raw_slab(device, verbose: bool, results=None) -> int:
    """Raw-kernel slab composition (the grid / rowsharded raw bodies): a
    2-shard row split of one stream -- slab-local roi ``row_bounds`` --
    must reproduce the full-height raw kernel: maps byte-exact, stats
    combining by sum / sum / max / sum.  Both protocols: the tail body
    (OVERALL), two streams' slabs stacked in one launch with the window,
    and the ring body (PER_FRAME, carried prev / baseline slab state across
    two batches)."""
    put, zeros = _on(device)

    def body():
        t, b, h, w = 2, 4, 64, 140
        hp, wp = pad_geometry(h, w)
        hs = hp // 2
        props = DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=t,
                               roi=(10, 4, 50, 36))
        y0, x0, y1, x1 = props.roi_bounds(h, w)
        r = np.random.default_rng(7)
        raw = _padded_noise(r, (t + b, 3, hp, wp), h, w)
        flags = np.zeros((b,), bool)
        flags[0] = True
        valid = np.ones((1, b), bool)

        def bounds(k):
            row0 = k * hs
            return (int(np.clip(y0 - row0, 0, hs)),
                    int(np.clip(y1 - row0, 0, hs)))

        # tail protocol (OVERALL): one launch per emulated shard
        outs, statss, nhs = [], [], []
        for k in range(2):
            o, st, _, nh = cuda_fused.absdiff_step_stacked(
                props, h, w, 1, put(raw[:, :, k * hs:(k + 1) * hs]),
                zeros((3, hs, wp), torch.uint8), flags[None],
                zeros((hs, wp)), valid, row_bounds=bounds(k))
            outs.append(_host(o))
            statss.append(_host(st[0]))
            nhs.append(_host(nh))
        eo, es, _, eh = cuda_fused.absdiff_step(
            props, h, w, put(raw), zeros((3, hp, wp), torch.uint8), flags,
            zeros((hp, wp)), valid[0])
        assert (np.concatenate(outs, axis=-2) == _host(eo)).all(), \
            "raw slab out != full"
        _check_slab_stats(np.stack(statss), _host(es), max_atol=0)
        assert (np.concatenate(nhs, axis=-2) == _host(eh)).all(), \
            "raw slab heatmap diverged"

        # the grid body's composition: TWO STREAMS' full-height sections
        # stacked in one launch WITH the row window (equal to the roi rows
        # here), each equal to the plain roi kernel byte for byte
        raw2 = _padded_noise(r, (t + b, 3, hp, wp), h, w)
        stacked = np.concatenate([raw, raw2], axis=2)
        o_s, st_s, _, nh_s = cuda_fused.absdiff_step_stacked(
            props, h, w, 2, put(stacked), zeros((3, 2 * hp, wp), torch.uint8),
            np.tile(flags[None], (2, 1)), zeros((2 * hp, wp)),
            np.ones((2, b), bool), row_bounds=(y0, y1))
        o_s, st_s, nh_s = _host(o_s), _host(st_s), _host(nh_s)
        for si, rw in enumerate((raw, raw2)):
            eo, es, _, eh = cuda_fused.absdiff_step(
                props, h, w, put(rw), zeros((3, hp, wp), torch.uint8), flags,
                zeros((hp, wp)), valid[0])
            sect = slice(si * hp, (si + 1) * hp)
            assert (o_s[:, :, sect] == _host(eo)).all(), \
                f"stacked+bounds stream {si} out"
            np.testing.assert_allclose(st_s[si], _host(es), atol=1e-5)
            assert (nh_s[sect] == _host(eh)).all(), \
                f"stacked+bounds stream {si} heatmap"

        # ring protocol (PER_FRAME): carried prev / baseline slab state
        props_r = DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=t,
                                 method=DiPsMethod.PER_FRAME,
                                 roi=(10, 4, 50, 36))
        pv = [zeros((3, hs, wp), torch.uint8) for _ in range(2)]
        bl = [zeros((3, hs, wp), torch.uint8) for _ in range(2)]
        hm = [zeros((hs, wp)) for _ in range(2)]
        epv = zeros((3, hp, wp), torch.uint8)
        ebl = zeros((3, hp, wp), torch.uint8)
        ehm = zeros((hp, wp))
        seed = np.ones((1,), np.int32)
        fl0 = np.zeros((b,), bool)
        for bi in range(2):
            rb = _padded_noise(r, (b, 3, hp, wp), h, w)
            slab_out = []
            for k in range(2):
                o, *_ = cuda_fused.absdiff_step_ring_stacked(
                    props_r, h, w, 1, put(rb[:, :, k * hs:(k + 1) * hs]),
                    pv[k], bl[k], fl0[None], hm[k], valid, seed,
                    row_bounds=bounds(k))
                slab_out.append(_host(o))
            eo, *_ = cuda_fused.absdiff_step_ring(
                props_r, h, w, put(rb), epv, ebl, fl0, ehm, valid[0],
                int(seed[0]))
            assert (np.concatenate(slab_out, axis=-2) == _host(eo)).all(), \
                f"ring batch {bi} out"
            assert torch.equal(torch.cat(pv, dim=-2), epv), \
                f"ring batch {bi} prev"
            assert torch.equal(torch.cat(hm, dim=-2), ehm), \
                f"ring batch {bi} heatmap"
            seed = np.zeros((1,), np.int32)

    return _gate("raw slab row-bounds (tail+stacked+ring)", body, verbose,
                 results)


def _run_band_no_maps(device, verbose: bool, results=None) -> int:
    """Composition gate: band-form slabs x ``emit_maps=False`` (a
    row-sharded no-map fleet).  The 2-section band-form ring kernel with
    zero output channels must reproduce the full-height no-maps ring
    kernel's statistics and every piece of carried state across two
    batches."""
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED, emit_maps=False)
    assert props.out_channels == 0
    return _gate("band slabs x emit_maps=False",
                 lambda: _band_sections(device, props, 9, "band+no-maps",
                                        True),
                 verbose, results)


def _run_hwc(frames, device, verbose: bool, results=None) -> int:
    """Device-side input layout: an ``hwc_bgr`` engine (raw bytes up,
    transpose + pad + BGR swap on the device) must be BIT-EXACT against the
    host-planarize engine -- the transform is pure layout."""
    h, w = frames.shape[1:3]
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)

    def body():
        ep = DiPsEngine(props, h, w, batch=4, device=device,
                        input_layout="planar")
        eh = DiPsEngine(props, h, w, batch=4, device=device,
                        input_layout="hwc_bgr")
        op, sp = ep.process_frames(list(frames))
        oh, sh = eh.process_frames([f[:, :, ::-1] for f in frames])
        assert np.array_equal(oh, op), "hwc_bgr maps != planar maps"
        np.testing.assert_allclose(sh, sp, atol=1e-6)

    return _gate("input-layout hwc_bgr", body, verbose, results)


def _run_downscale(frames, device, verbose: bool, results=None) -> int:
    """On-device input decimation: a ``downscale=2`` engine fed full-res
    frames against a plain engine fed host-pooled frames
    (``reference.pool_frame_host``, the device pool's host twin): maps
    BIT-exact, statistics to float tolerance."""
    h, w = frames.shape[1:3]
    k = 2
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)

    def body():
        ek = DiPsEngine(props, h, w, batch=4, device=device, downscale=k)
        e1 = DiPsEngine(props, h // k, w // k, batch=4, device=device)
        ok_, sk = ek.process_frames(list(frames))
        o1, s1 = e1.process_frames(
            [reference.pool_frame_host(f, k) for f in frames])
        assert np.array_equal(ok_, o1), "downscale maps != pre-pooled maps"
        np.testing.assert_allclose(sk, s1, atol=1e-6)

    return _gate("on-device downscale=2", body, verbose, results)


def soak(n_frames: int = 512, device="cuda", verbose: bool = True,
         results=None) -> int:
    """On-device streaming soak: ``n_frames`` through BOTH step protocols
    (the ring-carry kernels against the tail kernels, on the same device)
    with refresh markers and a mid-stream checkpoint / restore, asserting
    batch-by-batch equality: ring slot rotation across many wraps, marker
    re-captures and the carried state's in-place updates at length.  The
    record holds each protocol's frames/s over the streamed batches (host
    frames in, host maps out; at this geometry, mostly per-launch
    overhead)."""
    t0 = time.time()
    name = f"soak {n_frames}f ring-vs-tail + ckpt"
    h, w, batch = 48, 180, 16
    props = DiPsProperties(window_size=3, temporal_size=4,
                           refresh_markers=(37, 201, 202, 450))
    r = np.random.default_rng(0)
    base = r.integers(0, 256, (h, w, 3), np.uint8)
    # last batch boundary at-or-before the midpoint (always hit)
    ckpt_at = max(0, (n_frames // 2 // batch - 1) * batch)
    try:
        ring_eng = DiPsEngine(props, h, w, batch=batch, device=device,
                              ring_carry=True)
        tail_eng = DiPsEngine(props, h, w, batch=batch, device=device,
                              ring_carry=False)
        ckpt = None
        walls = {"ring": 0.0, "tail": 0.0}
        for start in range(0, n_frames, batch):
            n = min(batch, n_frames - start)
            frames = []
            for i in range(n):
                f = base.copy()
                y, x = (start + i) * 3 % (h - 6), (start + i) * 7 % (w - 6)
                f[y:y + 6, x:x + 6] = r.integers(0, 256, 3, np.uint8)
                frames.append(f)
            tw = time.perf_counter()
            o_r, s_r = ring_eng.process_batch(frames)
            walls["ring"] += time.perf_counter() - tw
            tw = time.perf_counter()
            o_t, s_t = tail_eng.process_batch(frames)
            walls["tail"] += time.perf_counter() - tw
            d = np.abs(o_r.astype(np.int16) - o_t.astype(np.int16))
            assert d.max() <= 1, (
                f"protocol divergence {d.max()} at frame {start}")
            np.testing.assert_allclose(s_r, s_t, atol=1e-4, rtol=1e-3)
            if start == ckpt_at:
                ckpt = ring_eng.state_dict()
        # rewind the ring engine to mid-stream and replay one batch against
        # a TAIL engine loaded from the same checkpoint: the rebuilt ring
        # must reproduce the tail protocol's history (a ring-vs-ring replay
        # would let two identically wrong rebuilds pass)
        assert ckpt is not None
        ring_eng.load_state_dict(ckpt)
        replay = ring_eng.frame_index
        frames = []
        for i in range(batch):
            f = base.copy()
            y, x = (replay + i) * 3 % (h - 6), (replay + i) * 7 % (w - 6)
            f[y:y + 6, x:x + 6] = 0  # both engines see the same frames
            frames.append(f)
        fresh_tail = DiPsEngine(props, h, w, batch=batch, device=device,
                                ring_carry=False)
        fresh_tail.load_state_dict(ckpt)
        o_a, s_a = ring_eng.process_batch(frames)
        o_b, s_b = fresh_tail.process_batch(frames)
        d = np.abs(o_a.astype(np.int16) - o_b.astype(np.int16))
        assert d.max() <= 1, f"ckpt replay divergence {d.max()}"
        np.testing.assert_allclose(s_a, s_b, atol=1e-4, rtol=1e-3)
        fps = {k: round(n_frames / v, 1) for k, v in walls.items()}
        if verbose:
            print(f"  PASS soak {n_frames}f ring-vs-tail + ckpt replay "
                  f"({time.time() - t0:.1f}s; frames/s {fps})")
        _record(results, name, True, t0, fps=fps)
        return 0
    except Exception as e:
        if verbose:
            print(f"  FAIL soak: {e}")
        _record(results, name, False, t0, e)
        return 1


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def run(device="cuda", quick: bool = False, verbose: bool = True,
        results=None) -> int:
    """Every case of :data:`CASES` against the oracle on both protocols
    (``quick``: the first three on the engine's default protocol), then
    the gates.  Returns 1 if any failed."""
    device = resolve_device(device)
    frames = _clip(n=6 if quick else 10)
    h, w = frames.shape[1:3]
    failures = 0
    if verbose:
        print(f"device: {device} ({_device_name(device)}), torch "
              f"{torch.__version__}, cuda {torch.version.cuda}")
    cases = CASES[:3] if quick else CASES
    # two step protocols: ring-carry (the streaming default) and tail
    modes = (True, False) if not quick else (None,)
    for name, props, exact in cases:
        # the numpy oracle dominates each case's wall time and is
        # protocol-independent: once per case
        o = DiPsOracle(props)
        exp_out, exp_stats = o.run(frames)
        if exp_out.ndim == 3:
            exp_out = exp_out[..., None]
        for ring in modes:
            t0 = time.time()
            name_m = (name if ring is None
                      else f"{name} [{'ring' if ring else 'tail'}]")
            try:
                kw = {} if ring is None else dict(ring_carry=ring)
                eng = DiPsEngine(props, h, w, batch=4, device=device, **kw)
                got_out, got_stats = eng.process_frames(list(frames))
                diff = np.abs(got_out.astype(np.int16)
                              - exp_out.astype(np.int16))
                raw = props.output in (OutputMode.ABSDIFF,
                                       OutputMode.THRESHOLD)
                if props.out_channels == 0:
                    # map-suppressed modes: the contract is the empty shape
                    # and the stats / heatmap below
                    assert got_out.shape == exp_out.shape, (
                        f"no-map shape {got_out.shape} != {exp_out.shape}")
                elif raw:
                    assert diff.max() == 0, f"u8 diff {diff.max()} != 0"
                else:
                    # f32 paths: <= 1 LSB (exactly-x.5 rounding ties may
                    # flip); pure min/max paths (exact=True) must also
                    # have only RARE tie flips
                    assert diff.max() <= 1, f"u8 diff {diff.max()} > 1"
                    if exact:
                        frac = (diff != 0).mean()
                        assert frac <= 0.01, f"tie-flip fraction {frac:.3%}"
                np.testing.assert_allclose(got_stats[:, :3],
                                           exp_stats[:, :3],
                                           atol=1e-4, rtol=1e-3)
                # changed_count: exact in integer modes; f32 emphasis paths
                # may flip knife-edge pixels at the threshold boundary only
                cnt_tol = 0 if raw else 0.01 * h * w
                cnt_err = np.abs(got_stats[:, 3] - exp_stats[:, 3]).max()
                assert cnt_err <= cnt_tol, f"changed_count off by {cnt_err}"
                np.testing.assert_allclose(eng.heatmap(), o.heatmap,
                                           atol=1e-3)
                if verbose:
                    print(f"  PASS {name_m:<40s} ({time.time() - t0:.1f}s)")
                _record(results, name_m, True, t0)
            except Exception as e:
                failures += 1
                if verbose:
                    print(f"  FAIL {name_m:<40s} {e}")
                _record(results, name_m, False, t0, e)
    if not quick:
        failures += _run_stacked(device, verbose, results)
        failures += _run_slab(device, verbose, results)
        failures += _run_slab_bands(device, verbose, results)
        failures += _run_raw_slab(device, verbose, results)
        failures += _run_band_no_maps(device, verbose, results)
        failures += _run_hwc(frames, device, verbose, results)
        failures += _run_downscale(frames, device, verbose, results)
    if verbose:
        print("PASS: device numerics match the oracle" if not failures
              else f"FAIL: {failures} case(s) diverged")
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="dips_tpu_torch on-device numerics acceptance check")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cuda:N runs the CUDA "
                         "kernels; cpu runs their plain twins")
    ap.add_argument("--quick", action="store_true",
                    help=f"3 cases instead of {len(CASES)}, one protocol, "
                         f"no gates")
    ap.add_argument("--soak", type=int, nargs="?", const=512, default=None,
                    metavar="N",
                    help="streaming soak: N frames (default 512) through "
                         "both step protocols with markers + mid-stream "
                         "checkpoint replay, asserting equality")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write a machine-readable result artifact (per-"
                         "case pass/fail + environment) to PATH")
    ap.add_argument("--with-soak", type=int, nargs="?", const=512,
                    default=None, metavar="N",
                    help="ALSO run the N-frame soak after the case matrix "
                         "(one artifact covering both)")
    from .utils.compilecache import (add_compile_cache_flag,
                                     apply_compile_cache_flag)
    add_compile_cache_flag(ap)
    args = ap.parse_args(argv)
    apply_compile_cache_flag(args)
    try:
        device = resolve_device(args.device)
    except DeviceError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    results = [] if args.json else None
    t0 = time.time()
    cuda_fused.reset_launch_counts()
    if args.soak is not None:
        rc = soak(args.soak, device=device, results=results)
    else:
        rc = run(device, args.quick, results=results)
        if args.with_soak is not None and rc == 0:
            rc |= soak(args.with_soak, device=device, results=results)
    if args.json:
        from .doctor import _power_line
        doc = {
            "tool": "dips_tpu_torch.validate",
            "device_arg": args.device,
            "device": _device_name(device),
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            **({"card": _power_line()} if device.type == "cuda" else {}),
            "quick": bool(args.quick),
            "ok": rc == 0,
            "cases": results,
            "passed": sum(1 for r in results if r["ok"]),
            "failed": sum(1 for r in results if not r["ok"]),
            "elapsed_s": round(time.time() - t0, 1),
            # kernel launches of the run (the plain twins count none)
            "launches": cuda_fused.launch_counts(),
        }
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        print(f"wrote {args.json}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
