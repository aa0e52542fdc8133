"""The spatial-filter variants of the port's median steps against the JAX
package on the CPU: ``approx_median`` (``networks.separable_median``) and
``quirk_compat`` (``networks.quirk_window_select`` and the even-integer
store-back).

* ``reference.spatial_median`` / ``filtered_planes`` of the port against
  ``dips_tpu.ops.reference.spatial_median``, windows 1 / 3 / 5 / 7.
* The networks the CUDA kernels are built from (``ops/_build.py`` generates
  ``csort<w>``, ``wmerge<w>``, ``smed<w>`` and ``qsel<w>``), evaluated here
  line by line, against ``ops/networks.py``; the median statistic partials
  split per tile and per (tile, warp).
* The four median steps' plain twins (``cuda_fused.batch_step_ring`` /
  ``batch_step_ring_stacked`` / ``batch_step`` / ``batch_step_stacked`` on
  CPU tensors) against the Pallas functions of the same name in interpret
  mode, s = 1 and s = 3, with a partial batch (and, in the tail protocol, a
  flagged invalid slot); the stacked cases put a white stream between two
  noisy ones with no padding rows between them, so a halo that crossed a
  stream edge would show.
* The port's plain tail step against ``dips_tpu.ops.reference.batch_step``.

Sizes: H = 16 (12 where padding rows separate the streams), W = 136 or 140
(Wp = 256), B = 4, S = 3.  Tolerances: every selection is integer and exact,
so filtered planes, ring, prev and baseline are exactly equal on the true
region; maps, which go through the float32 emphasis, within 1 LSB; stats
atol 1e-6 with counts and maxima exact; heatmap atol 1e-4.  The padded
columns are not compared: the Pallas kernel's x-taps wrap around there.
"""

import re

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dips_tpu.ops import pallas_fused
from dips_tpu.ops import reference as jref
from dips_tpu.properties import (ChromaFilter, DiPsFilter, DiPsMethod,
                                 DiPsProperties, OutputMode)
from dips_tpu_torch.convert import props_from_jax
from dips_tpu_torch.ops import _build, cuda_fused, networks
from dips_tpu_torch.ops import reference as tref
from tests.conftest import make_clip
from tests.test_torch_multistream import (assert_stacked_same,
                                          run_stacked_pair)
from tests.test_torch_tail_ops import (STACKED_BATCHES, assert_maps,
                                       assert_state, assert_stats,
                                       stacked_raw, tail_batches, zero_state)

torch.set_num_threads(1)

H, W, B, S = 16, 140, 4, 3


def variant(mode, w, **kw):
    return DiPsProperties(window_size=w, **{mode: True}, **kw)


#: each variant with a different method / output / filter / chroma / T
CASES = [
    variant("approx_median", 3),
    variant("approx_median", 7, method=DiPsMethod.PER_FRAME,
            output=OutputMode.GRAYSCALE, filter=DiPsFilter.INVERSE_SIGMOID,
            temporal_size=3),
    variant("quirk_compat", 1, chroma=ChromaFilter.RED),
    variant("quirk_compat", 3, method=DiPsMethod.PER_FRAME),
    variant("quirk_compat", 5, refresh_markers=(2,), temporal_size=5),
    variant("quirk_compat", 7, method=DiPsMethod.PER_FRAME,
            output=OutputMode.GRAYSCALE, roi=(2, 5, 14, 120)),
]
#: the stacked cases: both modes, the widest halos
STACKED = [CASES[1], CASES[4], CASES[5]]


# ---------------------------------------------------------------------------
# the plain spatial filters and the generated networks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["approx", "quirk"])
@pytest.mark.parametrize("w", [1, 3, 5, 7])
def test_spatial_median_matches_jax(w, mode):
    """Integer planes on [0, 510]: the port's filter equals the JAX one
    exactly, and the filtered planes carry the quirk's store-back."""
    rng = np.random.default_rng(w)
    planes = rng.integers(0, 511, (3, H, 136)).astype(np.float32)
    kw = {mode: True}
    exp = np.asarray(jref.spatial_median(jnp.asarray(planes), w, **kw))
    got = tref.spatial_median(torch.from_numpy(planes), w, **kw).numpy()
    np.testing.assert_array_equal(got, exp)
    if mode == "quirk" and w == 3:  # the reference's w=3 pick is always 0
        assert not got.any()
    raw = rng.integers(0, 256, (2, 3, H, 136), np.uint8)
    flag = {"approx": "approx_median", "quirk": "quirk_compat"}[mode]
    props = props_from_jax(DiPsProperties(window_size=w, **{flag: True}))
    phi = tref.filtered_planes(torch.from_numpy(raw), props).numpy()
    ref = np.asarray(jref.spatial_median(
        jref.intensity_planar(jnp.asarray(raw), props.chroma), w, **kw))
    if mode == "quirk":  # rounded to the u8 grid, half to even
        ref = 2 * np.rint(ref / 2)
        assert not (phi % 2).any()
    np.testing.assert_array_equal(phi, ref)


def _run_generated(src: str, name: str, tap=None, values=None):
    """Evaluate the generated device function ``name`` of the network
    header on the host.  A tap-form function (``wmerge<w>``, ``smed<w>``,
    ``qsel<w>``) reads its wires through ``tap(*args)`` and returns the
    selected value; ``csort<w>`` sorts the list ``values`` in place and
    returns it."""
    body = src[src.index(f" {name}("):]
    body = body[:body.index("\n}\n")].splitlines()[1:]
    v = {}
    for line in body:
        line = line.strip()
        if m := re.fullmatch(r"int (v\d+) = s\((\d+)(?:, (\d+))?\);", line):
            v[m[1]] = tap(*(int(a) for a in m.groups()[1:] if a is not None))
        elif m := re.fullmatch(r"int (v\d+) = s\[(\d+)\];", line):
            v[m[1]] = values[int(m[2])]
        elif m := re.fullmatch(r"\{ auto t = min\((v\d+), (v\d+)\); \2 = "
                               r"max\(\1, \2\); \1 = t; \}", line):
            v[m[1]], v[m[2]] = min(v[m[1]], v[m[2]]), max(v[m[1]], v[m[2]])
        elif m := re.fullmatch(r"(v\d+) = (min|max)\((v\d+), (v\d+)\);",
                               line):
            v[m[1]] = (min if m[2] == "min" else max)(v[m[3]], v[m[4]])
        elif m := re.fullmatch(r"s\[(\d+)\] = (v\d+);", line):
            values[int(m[1])] = v[m[2]]
        elif m := re.fullmatch(r"return (v\d+|0);", line):
            return 0 if m[1] == "0" else v[m[1]]
        else:
            raise AssertionError(f"unparsed line {line!r}")
    if values is None:
        raise AssertionError("no return")
    return values


@pytest.mark.parametrize("w", [3, 5, 7])
def test_generated_networks_select_as_networks(w):
    """``smed<w>`` is the median of its w taps and ``qsel<w>`` the quirk
    pick over the (w-1)^2 window of its taps, as ``networks.median_of`` /
    ``quirk_window_select`` compute them, on random and tied integer
    taps."""
    src = _build.network_header()
    rng = np.random.default_rng(w)
    for trial in range(40):
        hi = 4 if trial % 2 else 511  # many ties, then few
        col = [int(x) for x in rng.integers(0, hi, w)]
        got = _run_generated(src, f"smed{w}", lambda j: col[j])
        assert got == sorted(col)[w // 2]
        ld = w + 3
        grid = [int(x) for x in rng.integers(0, hi, ld * ld)]
        taps = [grid[dy * ld + dx] for dx in range(w - 1)
                for dy in range(w - 1)]
        rank = w * w // 2 + 1 - 2 * w
        exp = 0 if rank < 0 else sorted(taps)[rank]
        assert _run_generated(src, f"qsel{w}",
                              lambda dx, dy: grid[dy * ld + dx]) == exp
        # the same pick through the plain network on 1x1 "planes"
        vt = [np.asarray([[grid[dy * ld + dx] for dx in range(ld)]])
              for dy in range(w - 1)]
        p = w // 2
        pick = networks.quirk_window_select(
            vt, lambda x, dx: x[..., p + dx:p + dx + 1], np.minimum,
            np.maximum)
        assert int(pick.ravel()[0]) == exp


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("w", [3, 5, 7])
def test_generated_column_sort_and_merge_give_the_window_median(w, tied):
    """The exact median as the kernels split it: ``csort<w>`` sorts each
    column of the window once, and ``wmerge<w>`` merges the w sorted
    columns (``s(dx, j)``: rank j of column dx) into the median, equal to
    ``sorted(window)[w*w//2]`` and to ``networks.window_median`` on random
    and tied integer taps."""
    src = _build.network_header()
    rng = np.random.default_rng(10 * w + tied)
    hi = 3 if tied else 511
    for _ in range(60):
        win = rng.integers(0, hi, (w, w))  # win[dy, dx]
        cols = [_run_generated(src, f"csort{w}",
                               values=[int(x) for x in win[:, dx]])
                for dx in range(w)]
        for dx in range(w):
            assert cols[dx] == sorted(int(x) for x in win[:, dx])
        got = _run_generated(src, f"wmerge{w}", lambda dx, j: cols[dx][j])
        assert got == sorted(int(x) for x in win.ravel())[w * w // 2]
        p = w // 2
        vt = [win[dy][None, :] for dy in range(w)]
        plain = networks.window_median(
            vt, lambda x, dx: x[..., p + dx:p + dx + 1], np.minimum,
            np.maximum)
        assert int(plain.ravel()[0]) == got


def test_median_partials_split_per_warp_sum_to_per_tile_stats():
    """``reduce_median_stats`` gives the same stats whether the kernel
    leaves one partial per tile or one per (tile, warp): sums within float
    rounding, maxima and counts exact."""
    props = props_from_jax(DiPsProperties())
    rng = np.random.default_rng(5)
    b, s, tiles, warps = 3, 2, 12, 8
    fine = np.empty((b, s, tiles * warps, 4), np.float32)
    fine[..., :2] = rng.normal(0, 40, (b, s, tiles * warps, 2))
    fine[..., 1] = np.abs(fine[..., 1])
    fine[..., 2] = rng.uniform(0, 1, (b, s, tiles * warps))
    fine[..., 3] = rng.integers(0, 33, (b, s, tiles * warps))
    per_tile = fine.reshape(b, s, tiles, warps, 4)
    coarse = np.concatenate([per_tile[..., :2].sum(3, dtype=np.float32),
                             per_tile[..., 2:3].max(3),
                             per_tile[..., 3:].sum(3, dtype=np.float32)],
                            axis=-1)
    h, w = 96, 128
    got = cuda_fused.reduce_median_stats(torch.from_numpy(fine), props, h, w)
    exp = cuda_fused.reduce_median_stats(torch.from_numpy(coarse), props, h,
                                         w)
    assert got.shape == (s, b, 4)
    np.testing.assert_array_equal(got[..., 2:].numpy(), exp[..., 2:].numpy())
    np.testing.assert_allclose(got[..., :2].numpy(), exp[..., :2].numpy(),
                               rtol=1e-5, atol=1e-7)


def test_quirk_window_is_off_center():
    """A bright 5x5 block through the ring step at w=5: the quirk window
    spans offsets [-2, 2) in both axes and picks rank 3 of its 16 taps, so
    a pixel lights only when all 16 taps lie in the block: rows 8..9 and
    columns 62..63 of a block at rows 6..10, columns 60..64 (a window one
    tap off in either direction lights 7..8 or 9..10).  Pallas interpret
    mode and the port agree."""
    props = variant("quirk_compat", 5, filter=DiPsFilter.UNFILTERED,
                    temporal_size=1)
    hp, wp = tref.pad_geometry(H, W)
    raw = np.zeros((1, 3, hp, wp), np.uint8)
    raw[0, :, 6:11, 60:65] = 200
    js = [jnp.zeros((1, hp, wp))] + [jnp.zeros((hp, wp)) for _ in range(3)]
    ts = [torch.zeros((1, hp, wp))] + [torch.zeros((hp, wp))
                                       for _ in range(3)]
    ones, zeros = np.ones(1, bool), np.zeros(1, bool)
    jo = pallas_fused.batch_step_ring(props, H, W, jnp.asarray(raw), *js[:3],
                                      jnp.asarray(zeros), js[3],
                                      jnp.asarray(ones), jnp.int32(0),
                                      jnp.int32(1))
    to = cuda_fused.batch_step_ring(props_from_jax(props), H, W,
                                    torch.from_numpy(raw), *ts[:3], zeros,
                                    ts[3], ones, 0, 1)
    ring = to[2][0].numpy()[:H, :W]
    np.testing.assert_array_equal(ring, np.asarray(jo[2])[0, :H, :W])
    lit = np.argwhere(ring > 0)
    assert sorted(set(lit[:, 0])) == [8, 9]
    assert sorted(set(lit[:, 1])) == [62, 63]
    assert len(lit) == 4 and (ring[ring > 0] == 400).all()


# ---------------------------------------------------------------------------
# the four median steps against Pallas interpret mode
# ---------------------------------------------------------------------------

#: ring batches: (flags, valid, offset, seed): a fresh stream with two
#: captures, then a partial batch
RING_BATCHES = [([1, 0, 1, 0], [1, 1, 1, 1], 0, 1),
                ([0, 1, 0, 1], [1, 1, 1, 0], B, 0)]


def _planar(n, h, seed):
    hp, wp = tref.pad_geometry(h, W)
    raw = np.zeros((n, 3, hp, wp), np.uint8)
    raw[:, :, :h, :W] = make_clip(n=n, h=h, w=W, seed=seed).transpose(
        0, 3, 1, 2)
    return raw


@pytest.mark.parametrize("props", CASES)
def test_ring_step_variant_matches_pallas(props):
    hp, wp = tref.pad_geometry(H, W)
    t = props.temporal_size
    raw = _planar(2 * B, H, 7)
    pp = props_from_jax(props)
    js = [jnp.zeros((t, hp, wp))] + [jnp.zeros((hp, wp)) for _ in range(3)]
    ts = [torch.zeros((t, hp, wp))] + [torch.zeros((hp, wp))
                                       for _ in range(3)]
    before = cuda_fused.launch_counts()
    for i, (flags, valid, off, seed) in enumerate(RING_BATCHES):
        x = raw[i * B:(i + 1) * B]
        fl, va = np.asarray(flags, bool), np.asarray(valid, bool)
        jo = pallas_fused.batch_step_ring(
            props, H, W, jnp.asarray(x), *js[:3], jnp.asarray(fl), js[3],
            jnp.asarray(va), jnp.int32(off % t), jnp.int32(seed))
        to = cuda_fused.batch_step_ring(pp, H, W, torch.from_numpy(x),
                                        *ts[:3], fl, ts[3], va, off % t,
                                        seed)
        js = list(jo[2:])
        assert_maps(props, to[0].numpy(), jo[0], H, hp)
        assert_stats(to[1].numpy(), jo[1])
        for g, e in zip(to[2:5], jo[2:5]):  # ring / prev / baseline exact
            np.testing.assert_array_equal(g.numpy()[..., :H, :W],
                                          np.asarray(e)[..., :H, :W])
        np.testing.assert_allclose(to[5].numpy(), np.asarray(jo[5]),
                                   atol=1e-4)
    if props.quirk_compat:  # the ring holds the u8 grid
        assert not (ts[0].numpy() % 2).any()
    assert cuda_fused.launch_counts() == before  # the plain twin ran


@pytest.mark.parametrize("props", STACKED)
def test_stacked_ring_step_variant_matches_pallas(props):
    """H = 16: a white stream between two noisy ones, no padding rows."""
    for to, jo, hp in run_stacked_pair(props, 16, contrast=True):
        assert hp == 16
        assert_stacked_same(props, to, jo, 16, hp)


@pytest.mark.parametrize("props", CASES)
def test_tail_step_variant_matches_pallas(props):
    hp, wp = tref.pad_geometry(H, W)
    raw_all = _planar(2 * B + props.temporal_size, H, 8)
    pp = props_from_jax(props)
    js, ts = zero_state(props, (hp, wp), "jax"), \
        zero_state(props, (hp, wp), "torch")
    for x, flags, valid in tail_batches(props, raw_all):
        jo = pallas_fused.batch_step(props, H, W, jnp.asarray(x), js[0],
                                     jnp.asarray(flags), js[1],
                                     jnp.asarray(valid))
        to = cuda_fused.batch_step(pp, H, W, torch.from_numpy(x), ts[0],
                                   torch.from_numpy(flags), ts[1],
                                   torch.from_numpy(valid))
        js = list(jo[2:])
        assert_maps(props, to[0].numpy(), jo[0], H, hp)
        assert_stats(to[1].numpy(), jo[1])
        assert_state(props, [a.numpy() for a in to[2:]], jo[2:], H, hp)


@pytest.mark.parametrize("props", STACKED)
def test_stacked_tail_step_variant_matches_pallas(props):
    h, t = 16, props.temporal_size
    hp, wp = tref.pad_geometry(h, W)
    raw_all = stacked_raw(2 * B + t, h, contrast=True)
    pp = props_from_jax(props)
    js, ts = zero_state(props, (S * hp, wp), "jax"), \
        zero_state(props, (S * hp, wp), "torch")
    for i, (flags, valid) in enumerate(STACKED_BATCHES):
        x = raw_all[i * B:i * B + t + B]
        fl, va = np.asarray(flags, bool), np.asarray(valid, bool)
        jo = pallas_fused.batch_step_stacked(
            props, h, W, S, jnp.asarray(x), js[0], jnp.asarray(fl), js[1],
            jnp.asarray(va))
        to = cuda_fused.batch_step_stacked(pp, h, W, S, torch.from_numpy(x),
                                           ts[0], torch.from_numpy(fl),
                                           ts[1], torch.from_numpy(va))
        js = list(jo[2:])
        assert_maps(props, to[0].numpy(), jo[0], h, hp)
        assert_stats(to[1].numpy(), jo[1])
        assert_state(props, [a.numpy() for a in to[2:]], jo[2:], h, hp)


@pytest.mark.parametrize("props", [CASES[0], CASES[4]])
def test_reference_step_variant_matches_jax(props):
    """The port's plain tail step against ``dips_tpu.ops.reference``
    (the JAX package's portable backend)."""
    hp, wp = tref.pad_geometry(H, W)
    raw_all = _planar(2 * B + props.temporal_size, H, 9)
    pp = props_from_jax(props)
    js, ts = zero_state(props, (hp, wp), "jax"), \
        zero_state(props, (hp, wp), "torch")
    for x, flags, valid in tail_batches(props, raw_all):
        jo = jref.batch_step(props, H, W, jnp.asarray(x), js[0],
                             jnp.asarray(flags), js[1], jnp.asarray(valid))
        to = tref.batch_step(pp, H, W, torch.from_numpy(x), ts[0],
                             torch.from_numpy(flags), ts[1],
                             torch.from_numpy(valid))
        js, ts = list(jo[2:]), list(to[2:])
        assert_maps(props, to[0].numpy(), jo[0], H, hp)
        assert_stats(to[1].numpy(), jo[1])
        assert_state(props, [a.numpy() for a in to[2:]], jo[2:], H, hp)


def test_mode_launch_counts_are_kept_per_variant():
    """Every median wrapper has a count per spatial mode, and a reset
    clears them all."""
    counts = cuda_fused.launch_counts()
    for name in ("batch_step_ring", "batch_step_ring_stacked", "batch_step",
                 "batch_step_stacked"):
        for mode in ("approx_median", "quirk_compat"):
            assert f"{name}:{mode}" in counts
    cuda_fused.batch_step_ring.mode_launches["quirk_compat"] = 3
    assert cuda_fused.launch_counts()["batch_step_ring:quirk_compat"] == 3
    cuda_fused.reset_launch_counts()
    assert not any(cuda_fused.launch_counts().values())
