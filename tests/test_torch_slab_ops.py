"""The port's row-slab steps against the JAX package on the CPU.

* ``cuda_fused``'s stacked steps with ``row_bounds`` / ``bands`` (plain
  twins on CPU tensors) against ``pallas_fused._batch_step_impl``,
  ``_batch_step_ring_impl`` and ``_absdiff_step_impl`` with the same
  arguments, in interpret mode as the JAX package's own tests run them.
* The 2-shard row splits of ``dips_tpu/validate.py`` (``_run_slab``,
  ``_run_slab_bands``, ``_run_raw_slab``) rebuilt on the port: the slabs
  equal the port's own full-height step bit for bit.

Inputs are made with numpy from a seed.  A section here is a slab of Hs = 16
rows of a 32 x 140 image (Hp = 32, Wp = 256), B = 4, s = 1 or 2; the bands
are random bytes (zero in the padding columns, as a neighbour's rows are),
so a band row read off by one changes a result.

Tolerances: u8 maps and carried state byte-equal on the true columns
[0, W) (the padding columns differ by design: the Pallas kernel's x-taps
wrap around there, the port reads zeros); with an emphasis filter the maps
within 1 LSB; stats atol 1e-6 on the two sums, counts and maxima exact;
heatmap atol 1e-4.
"""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dips_tpu.ops import pallas_fused
from dips_tpu.properties import (ChromaFilter, DiPsFilter, DiPsMethod,
                                 DiPsProperties, OutputMode)
from dips_tpu_torch.convert import props_from_jax
from dips_tpu_torch.ops import cuda_fused
from dips_tpu_torch.ops import reference as tref

torch.set_num_threads(1)

H, W, B, HS = 32, 140, 4, 16
HP, WP = tref.pad_geometry(H, W)
RAW = (OutputMode.ABSDIFF, OutputMode.THRESHOLD, OutputMode.STATS_ONLY)
NOFILT = dict(filter=DiPsFilter.UNFILTERED)

#: median cases: (props, s, row_bounds, with bands)
MEDIAN_CASES = [
    (DiPsProperties(window_size=3, temporal_size=2, **NOFILT), 1, (2, 13),
     True),
    (DiPsProperties(window_size=5, temporal_size=3, **NOFILT,
                    method=DiPsMethod.PER_FRAME), 2, (0, 16), True),
    (DiPsProperties(window_size=7, temporal_size=2, **NOFILT), 2, (5, 16),
     True),
    (DiPsProperties(window_size=3, temporal_size=2, approx_median=True,
                    **NOFILT), 2, (0, 9), True),
    (DiPsProperties(window_size=7, temporal_size=2, approx_median=True,
                    method=DiPsMethod.PER_FRAME, **NOFILT), 1, (3, 16), True),
    (DiPsProperties(window_size=5, temporal_size=2, quirk_compat=True,
                    **NOFILT), 2, (0, 16), True),
    (DiPsProperties(window_size=7, temporal_size=2, quirk_compat=True,
                    method=DiPsMethod.PER_FRAME, **NOFILT), 1, (1, 12), True),
    (DiPsProperties(window_size=3, temporal_size=2, quirk_compat=True,
                    **NOFILT), 1, (0, 16), True),
    # an empty window: a slab wholly outside the roi
    (DiPsProperties(window_size=5, temporal_size=2, **NOFILT), 2, (0, 0),
     True),
    (DiPsProperties(window_size=3, temporal_size=2, **NOFILT,
                    method=DiPsMethod.PER_FRAME), 1, (16, 16), True),
    # dyn_rows alone (the extended construction's kernel form)
    (DiPsProperties(window_size=5, temporal_size=2, **NOFILT,
                    roi=(4, 10, 28, 120)), 2, (4, 12), False),
    (DiPsProperties(window_size=1, temporal_size=2, **NOFILT), 2, (3, 11),
     False),
    # emphasis, chroma, grayscale, no maps
    (DiPsProperties(window_size=3, temporal_size=4), 2, (0, 16), True),
    (DiPsProperties(window_size=5, temporal_size=2,
                    filter=DiPsFilter.INVERSE_SIGMOID,
                    chroma=ChromaFilter.GREEN,
                    output=OutputMode.GRAYSCALE), 1, (2, 14), True),
    (DiPsProperties(window_size=3, temporal_size=2, emit_maps=False), 2,
     (0, 10), True),
]

RAW_CASES = [
    (DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2,
                    roi=(10, 4, 30, 120)), 1, (10, 16)),
    (DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2,
                    method=DiPsMethod.PER_FRAME, roi=(10, 4, 30, 120)), 2,
     (0, 7)),
    (DiPsProperties(output=OutputMode.THRESHOLD, temporal_size=3,
                    change_threshold=40, roi=(0, 0, 32, 64)), 2, (0, 16)),
    (DiPsProperties(output=OutputMode.STATS_ONLY, temporal_size=2,
                    method=DiPsMethod.PER_FRAME, roi=(2, 30, 20, 90)), 1,
     (4, 4)),  # an empty window
    (DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2,
                    roi=(10, 4, 30, 120)), 2, (0, 0)),
]


def case_id(case):
    props, s, rows = case[:3]
    mode = ("approx" if props.approx_median
            else "quirk" if props.quirk_compat else "exact")
    return (f"{props.output.name}-{props.method.name}-w{props.window_size}"
            f"-{mode}-s{s}-rows{rows[0]}_{rows[1]}"
            + ("" if len(case) < 4 or case[3] else "-nobands"))


def slab_frames(n, s, seed, rows=HS):
    """(n, 3, s*rows, Wp) u8: random bytes on the true columns."""
    r = np.random.default_rng(seed)
    x = np.zeros((n, 3, s * rows, WP), np.uint8)
    x[..., :W] = r.integers(0, 256, (n, 3, s * rows, W), np.uint8)
    return x


def is_raw(props):
    return props.output in RAW


def assert_maps(props, got, exp):
    g = np.asarray(got)[..., :W].astype(np.int16)
    e = np.asarray(exp)[..., :W].astype(np.int16)
    assert g.shape == e.shape
    exact = is_raw(props) or props.filter == DiPsFilter.UNFILTERED
    assert np.abs(g - e).max(initial=0) <= (0 if exact else 1)


def assert_stats(got, exp):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape
    np.testing.assert_array_equal(got[..., 2:], exp[..., 2:])
    np.testing.assert_allclose(got[..., :2], exp[..., :2], rtol=0, atol=1e-6)


def assert_planes(got, exp):
    """Carried state: exact on the true columns."""
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(np.asarray(g)[..., :W],
                                      np.asarray(e)[..., :W])


# ---------------------------------------------------------------------------
# the wrappers with row_bounds / bands against the Pallas _impl functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", MEDIAN_CASES, ids=case_id)
def test_ring_slab_step_matches_pallas(case):
    """Two carried ring batches of s stacked slabs."""
    props, s, rows, with_bands = case
    pp = props_from_jax(props)
    t = props.temporal_size
    plane = (s * HS, WP)
    js = [jnp.zeros((t,) + plane, jnp.float32)] + [
        jnp.zeros(plane, jnp.float32) for _ in range(3)]
    ts = [torch.zeros((t,) + plane)] + [torch.zeros(plane)
                                        for _ in range(3)]
    offs, seeds = np.arange(s, dtype=np.int32) % t, np.ones(s, np.int32)
    for bi in range(2):
        raw = slab_frames(B, s, 10 + bi)
        bands = (slab_frames(B, s, 20 + bi, 8),
                 slab_frames(B, s, 30 + bi, 8)) if with_bands else None
        flags = np.zeros((s, B), bool)
        flags[:, bi] = True
        valid = np.ones((s, B), bool)
        valid[s - 1, 3] = bi == 0
        jo = pallas_fused._batch_step_ring_impl(
            props, H, W, s, jnp.asarray(raw), js[0], js[1], js[2],
            jnp.asarray(flags), js[3], jnp.asarray(valid), jnp.asarray(offs),
            jnp.asarray(seeds), row_bounds=jnp.asarray(rows, jnp.int32),
            bands=None if bands is None else tuple(map(jnp.asarray, bands)))
        to = cuda_fused.batch_step_ring_stacked(
            pp, H, W, s, torch.from_numpy(raw), ts[0], ts[1], ts[2], flags,
            ts[3], valid, offs, seeds, row_bounds=rows,
            bands=None if bands is None else tuple(map(torch.from_numpy,
                                                       bands)))
        js = [jo[2], jo[3], jo[4], jo[5]]
        assert_maps(props, to[0], jo[0])
        assert_stats(to[1], jo[1])
        assert_planes(ts[:3], js[:3])
        np.testing.assert_allclose(ts[3].numpy(), np.asarray(js[3]),
                                   atol=1e-4)
        offs = (offs + B) % t
        seeds = np.zeros(s, np.int32)
    if rows[0] >= rows[1]:  # an empty window: zero stats, untouched heatmap
        assert float(to[1].abs().max()) == 0.0
        assert float(ts[3].abs().max()) == 0.0


@pytest.mark.parametrize("case", MEDIAN_CASES, ids=case_id)
def test_tail_slab_step_matches_pallas(case):
    """Two tail batches of s stacked slabs; the bands cover the T tail
    frames too."""
    props, s, rows, with_bands = case
    pp = props_from_jax(props)
    t = props.temporal_size
    plane = (s * HS, WP)
    js = [jnp.zeros(plane, jnp.float32) for _ in range(2)]
    ts = [torch.zeros(plane) for _ in range(2)]
    for bi in range(2):
        raw = slab_frames(t + B, s, 40 + bi)
        bands = (slab_frames(t + B, s, 50 + bi, 8),
                 slab_frames(t + B, s, 60 + bi, 8)) if with_bands else None
        flags = np.zeros((s, B), bool)
        flags[:, bi] = True
        valid = np.ones((s, B), bool)
        valid[0, 3] = False
        jo = pallas_fused._batch_step_impl(
            props, H, W, s, jnp.asarray(raw), js[0], jnp.asarray(flags),
            js[1], jnp.asarray(valid),
            row_bounds=jnp.asarray(rows, jnp.int32),
            bands=None if bands is None else tuple(map(jnp.asarray, bands)))
        to = cuda_fused.batch_step_stacked(
            pp, H, W, s, torch.from_numpy(raw), ts[0], flags, ts[1], valid,
            row_bounds=rows,
            bands=None if bands is None else tuple(map(torch.from_numpy,
                                                       bands)))
        js = [jo[2], jo[3]]
        assert_maps(props, to[0], jo[0])
        assert_stats(to[1], jo[1])
        assert_planes(ts[:1], js[:1])
        np.testing.assert_allclose(ts[1].numpy(), np.asarray(js[1]),
                                   atol=1e-4)


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "tail"])
@pytest.mark.parametrize("case", RAW_CASES, ids=case_id)
def test_raw_slab_step_matches_pallas(case, ring):
    props, s, rows = case
    pp = props_from_jax(props)
    t = props.temporal_size
    plane = (s * HS, WP)
    js = [jnp.zeros((3,) + plane, jnp.uint8) for _ in range(2)] + [
        jnp.zeros(plane, jnp.float32)]
    ts = [torch.zeros((3,) + plane, dtype=torch.uint8) for _ in range(2)] + [
        torch.zeros(plane)]
    seeds = np.ones(s, np.int32)
    for bi in range(2):
        raw = slab_frames(B + (0 if ring else t), s, 70 + bi)
        flags = np.zeros((s, B), bool)
        flags[:, 1 - bi] = True
        valid = np.ones((s, B), bool)
        valid[s - 1, 3] = bi == 0
        bounds = jnp.asarray(rows, jnp.int32)
        if ring:
            jo = pallas_fused._absdiff_step_impl(
                props, H, W, s, jnp.asarray(raw), js[1], jnp.asarray(flags),
                js[2], jnp.asarray(valid), prev=js[0],
                seeds=jnp.asarray(seeds), ring=True, row_bounds=bounds)
            to = cuda_fused.absdiff_step_ring_stacked(
                pp, H, W, s, torch.from_numpy(raw), ts[0], ts[1], flags,
                ts[2], valid, seeds, row_bounds=rows)
            js = list(jo[2:])
            got = ts
        else:
            jo = pallas_fused._absdiff_step_impl(
                props, H, W, s, jnp.asarray(raw), js[1], jnp.asarray(flags),
                js[2], jnp.asarray(valid), row_bounds=bounds)
            to = cuda_fused.absdiff_step_stacked(
                pp, H, W, s, torch.from_numpy(raw), ts[1], flags, ts[2],
                valid, row_bounds=rows)
            js = [js[0], *jo[2:]]
            got = ts
        assert_maps(props, to[0], jo[0])
        assert_stats(to[1], jo[1])
        assert_planes(got[:2], js[:2])
        np.testing.assert_allclose(got[2].numpy(), np.asarray(js[2]),
                                   atol=1e-4)
        seeds = np.zeros(s, np.int32)
    if rows[0] >= rows[1]:
        assert float(to[1].abs().max()) == 0.0
        assert float(ts[2].abs().max()) == 0.0


def test_slab_argument_guards():
    """The JAX checks: bands need a stencil, raw row_bounds need an roi;
    and the port's own: band shapes, negative bounds."""
    raw = torch.from_numpy(slab_frames(B, 1, 1))
    plane = (HS, WP)
    fl = np.zeros((1, B), bool)
    va = np.ones((1, B), bool)
    bands = tuple(torch.from_numpy(slab_frames(B, 1, 2, 8)) for _ in "tb")
    with pytest.raises(ValueError, match="stencil windows"):
        cuda_fused.batch_step_ring_stacked(
            props_from_jax(DiPsProperties(window_size=1, temporal_size=2)),
            H, W, 1, raw, torch.zeros((2,) + plane), torch.zeros(plane),
            torch.zeros(plane), fl, torch.zeros(plane), va, [0], [1],
            row_bounds=(0, HS), bands=bands)
    with pytest.raises(ValueError, match="stencil windows"):
        cuda_fused.batch_step_stacked(
            props_from_jax(DiPsProperties(window_size=1, temporal_size=2)),
            H, W, 1, torch.from_numpy(slab_frames(2 + B, 1, 1)),
            torch.zeros(plane), fl, torch.zeros(plane), va,
            bands=tuple(torch.from_numpy(slab_frames(2 + B, 1, 2, 8))
                        for _ in "tb"))
    with pytest.raises(ValueError, match="only with an roi"):
        cuda_fused.absdiff_step_ring_stacked(
            props_from_jax(DiPsProperties(output=OutputMode.ABSDIFF)), H, W,
            1, raw, torch.zeros((3,) + plane, dtype=torch.uint8),
            torch.zeros((3,) + plane, dtype=torch.uint8), fl,
            torch.zeros(plane), va, [1], row_bounds=(0, HS))
    p3 = props_from_jax(DiPsProperties(window_size=3, temporal_size=2))
    state = lambda: (torch.zeros((2,) + plane), torch.zeros(plane),
                     torch.zeros(plane))
    with pytest.raises(ValueError, match="band"):
        cuda_fused.batch_step_ring_stacked(
            p3, H, W, 1, raw, *state(), fl, torch.zeros(plane), va, [0],
            [1], bands=(bands[0][:, :, :4], bands[1]))
    with pytest.raises(ValueError, match="negative"):
        cuda_fused.batch_step_ring_stacked(
            p3, H, W, 1, raw, *state(), fl, torch.zeros(plane), va, [0],
            [1], row_bounds=(-1, 4))


# ---------------------------------------------------------------------------
# 2-shard row splits on the port: slabs == the port's own full-height step
# ---------------------------------------------------------------------------

def full_frames(n, seed, h=H):
    hp = tref.pad_geometry(h, W)[0]
    r = np.random.default_rng(seed)
    x = np.zeros((n, 3, hp, WP), np.uint8)
    x[:, :, :h, :W] = r.integers(0, 256, (n, 3, h, W), np.uint8)
    return torch.from_numpy(x)


def combine(stats):
    """Slab partials (R, B, 4) -> full-frame stats: sum, sum, max, sum."""
    st = torch.stack(list(stats))
    return torch.stack([st[..., 0].sum(0), st[..., 1].sum(0),
                        st[..., 2].amax(0), st[..., 3].sum(0)], dim=-1)


def local_rows(y0, y1, k, hs, ext=0):
    lo = min(max(y0 - k * hs, 0), hs) + ext
    hi = min(max(y1 - k * hs, 0), hs) + ext
    return lo, hi


@pytest.mark.parametrize("window", [3, 5, 7])
def test_two_shard_extended_slabs_equal_full_height(window):
    """``validate._run_slab``: halo-extended slabs through the dyn_rows
    form (tail protocol), real neighbour rows inside, zeros at the global
    edges; the owned rows equal the full-height step."""
    t, ext = 2, 8
    props = props_from_jax(DiPsProperties(
        window_size=window, temporal_size=t, roi=(4, 10, 28, 120), **NOFILT))
    raw = full_frames(t + B, 2)
    flags = np.zeros(B, bool)
    flags[0] = True
    valid = np.ones(B, bool)
    zrow = torch.zeros((t + B, 3, ext, WP), dtype=torch.uint8)
    slabs = [torch.cat([zrow, raw[:, :, :HS], raw[:, :, HS:HS + ext]], 2),
             torch.cat([raw[:, :, HS - ext:HS], raw[:, :, HS:], zrow], 2)]
    y0, _, y1, _ = props.roi_bounds(H, W)
    outs, stats, nbs, nhs = [], [], [], []
    for k, slab in enumerate(slabs):
        o, st, nb, nh = cuda_fused.batch_step_stacked(
            props, H, W, 1, slab, torch.zeros(HS + 2 * ext, WP),
            flags[None], torch.zeros(HS + 2 * ext, WP), valid[None],
            row_bounds=local_rows(y0, y1, k, HS, ext))
        outs.append(o[:, :, ext:ext + HS])
        stats.append(st[0])
        nbs.append(nb[ext:ext + HS])
        nhs.append(nh[ext:ext + HS])
    eo, es, eb, eh = cuda_fused.batch_step(
        props, H, W, raw, torch.zeros(HP, WP), flags, torch.zeros(HP, WP),
        valid)
    assert torch.equal(torch.cat(outs, 2), eo)
    assert torch.equal(torch.cat(nbs), eb)
    assert torch.equal(torch.cat(nhs), eh)
    got = combine(stats)
    np.testing.assert_allclose(got.numpy(), es.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(got[:, 2:].numpy(), es[:, 2:].numpy())


@pytest.mark.parametrize("kw", [
    dict(window_size=5, method=DiPsMethod.PER_FRAME),
    dict(window_size=3), dict(window_size=7),
    dict(window_size=7, approx_median=True),
    dict(window_size=5, quirk_compat=True, method=DiPsMethod.PER_FRAME),
    dict(window_size=3, roi=(18, 4, 30, 100)),  # slab 0 misses the roi
], ids=lambda kw: "-".join(f"{k}={getattr(v, 'name', v)}"
                           for k, v in kw.items()))
def test_two_shard_band_slabs_equal_full_height(kw):
    """``validate._run_slab_bands``: two stacked OWNED-coordinate sections
    with the bands the exchange would deliver, over two carried ring
    batches.  The stacked sections share one row window, so the roi case
    runs one launch per slab."""
    t = 2
    props = props_from_jax(DiPsProperties(temporal_size=t, **NOFILT, **kw))
    y0, _, y1, _ = props.roi_bounds(H, W)
    share = props.roi is None
    zband = torch.zeros((B, 3, 8, WP), dtype=torch.uint8)
    st = [torch.zeros(t, HP, WP)] + [torch.zeros(HP, WP) for _ in range(3)]
    se = [x.clone() for x in st]
    offs, seeds = np.zeros(2, np.int32), np.ones(2, np.int32)
    for bi in range(2):
        raw = full_frames(B, 5 + bi)
        btop = torch.cat([zband, raw[:, :, HS - 8:HS]], 2)
        bbot = torch.cat([raw[:, :, HS:HS + 8], zband], 2)
        fl = np.zeros((2, B), bool)
        va = np.ones((2, B), bool)
        if share:  # stacked == full: contiguous halves
            out, stats, *_ = cuda_fused.batch_step_ring_stacked(
                props, H, W, 2, raw, *st[:3], fl, st[3], va, offs, seeds,
                row_bounds=(0, HS), bands=(btop, bbot))
        else:
            outs, stats = [], []
            for k in range(2):
                r, b8 = slice(k * HS, (k + 1) * HS), slice(k * 8, k * 8 + 8)
                cell = [st[0][:, r].clone()] + [x[r].clone()
                                                for x in st[1:]]
                o, s_, *_ = cuda_fused.batch_step_ring_stacked(
                    props, H, W, 1, raw[:, :, r].contiguous(), *cell[:3],
                    fl[:1], cell[3], va[:1], offs[:1], seeds[:1],
                    row_bounds=local_rows(y0, y1, k, HS),
                    bands=(btop[:, :, b8].contiguous(),
                           bbot[:, :, b8].contiguous()))
                st[0][:, r] = cell[0]
                for x, c in zip(st[1:], cell[1:]):
                    x[r] = c
                outs.append(o)
                stats.append(s_[0])
                if k == 0:
                    assert float(s_.abs().max()) == 0.0
            out, stats = torch.cat(outs, 2), torch.stack(stats)
        eo, es, *_ = cuda_fused.batch_step_ring(
            props, H, W, raw, *se[:3], fl[0], se[3], va[0], int(offs[0]),
            int(seeds[0]))
        assert torch.equal(out, eo), f"batch {bi}"
        for a, e in zip(st, se):
            assert torch.equal(a, e), f"batch {bi}: state"
        got = combine(stats)
        np.testing.assert_allclose(got.numpy(), es.numpy(), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_array_equal(got[:, 2:].numpy(), es[:, 2:].numpy())
        offs = (offs + B) % t
        seeds = np.zeros(2, np.int32)


@pytest.mark.parametrize("method", [DiPsMethod.OVERALL, DiPsMethod.PER_FRAME],
                         ids=lambda m: m.name)
@pytest.mark.parametrize("ring", [True, False], ids=["ring", "tail"])
def test_two_shard_raw_slabs_equal_full_height(method, ring):
    """``validate._run_raw_slab``: slab-local roi bounds through the
    dyn_rows form of the raw step, two carried batches; 64 rows, the roi
    in rows [10, 50)."""
    t, h = 2, 64
    hp = tref.pad_geometry(h, W)[0]
    hs = hp // 2
    props = props_from_jax(DiPsProperties(
        output=OutputMode.ABSDIFF, temporal_size=t, method=method,
        roi=(10, 4, 50, 36)))
    y0, _, y1, _ = props.roi_bounds(h, W)
    u8 = lambda *sh: torch.zeros(sh, dtype=torch.uint8)
    full = [u8(3, hp, WP), u8(3, hp, WP), torch.zeros(hp, WP)]
    slab = [[u8(3, hs, WP), u8(3, hs, WP), torch.zeros(hs, WP)]
            for _ in range(2)]
    for bi in range(2):
        raw = full_frames(B + (0 if ring else t), 7 + bi, h)
        flags = np.zeros(B, bool)
        flags[0] = bi == 0
        valid = np.ones(B, bool)
        seed = int(bi == 0)
        outs, stats = [], []
        for k in range(2):
            x = raw[:, :, k * hs:(k + 1) * hs].contiguous()
            rows = local_rows(y0, y1, k, hs)
            if ring:
                o, st, *_ = cuda_fused.absdiff_step_ring_stacked(
                    props, h, W, 1, x, slab[k][0], slab[k][1], flags[None],
                    slab[k][2], valid[None], [seed], row_bounds=rows)
            else:
                o, st, *_ = cuda_fused.absdiff_step_stacked(
                    props, h, W, 1, x, slab[k][1], flags[None], slab[k][2],
                    valid[None], row_bounds=rows)
            outs.append(o)
            stats.append(st[0])
        if ring:
            eo, es, *_ = cuda_fused.absdiff_step_ring(
                props, h, W, raw, full[0], full[1], flags, full[2], valid,
                seed)
        else:
            eo, es, *_ = cuda_fused.absdiff_step(
                props, h, W, raw, full[1], flags, full[2], valid)
        assert torch.equal(torch.cat(outs, 2), eo)
        for i in range(3):
            assert torch.equal(torch.cat([slab[0][i], slab[1][i]], -2),
                               full[i]), f"batch {bi}: state {i}"
        got = combine(stats)
        np.testing.assert_allclose(got.numpy(), es.numpy(), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_array_equal(got[:, 2:].numpy(), es[:, 2:].numpy())
