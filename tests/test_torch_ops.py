"""The port's plain stage functions and the plain twins of its two kernels
against the JAX package on the CPU.

The JAX side runs the real Pallas kernels in interpret mode
(``pallas_fused.absdiff_step_ring`` / ``batch_step_ring``), as the JAX
package's own tests do.  Inputs are made with numpy from a seed and handed
to both.

Tolerances: integer maps, u8 state and integer-valued float state on the
true region exact; emphasis maps within 1 LSB (exp/log may round a tie the
other way); stats atol 1e-6 with changed counts and maxima exact; heatmap
atol 1e-4.  The padded region of maps and median state is not compared:
the Pallas kernel's x-taps wrap around there, the port reads zeros.
"""

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
from dips_tpu_torch.ops import cuda_fused
from dips_tpu_torch.ops import reference as tref
from tests.conftest import make_clip
from tests.test_ring_carry import CASES

torch.set_num_threads(1)

H, W = 12, 140


def planar_clip(n, h, w, seed):
    hp, wp = tref.pad_geometry(h, w)
    clip = make_clip(n=n, h=h, w=w, seed=seed)
    raw = np.zeros((n, 3, hp, wp), np.uint8)
    raw[:, :, :h, :w] = clip.transpose(0, 3, 1, 2)
    return raw


# ---------------------------------------------------------------------------
# stage functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(12, 140), (16, 200), (1080, 1920),
                                (480, 640), (7, 124), (720, 1280)])
def test_pad_geometry(hw):
    assert tref.pad_geometry(*hw) == jref.pad_geometry(*hw)


@pytest.mark.parametrize("layout", ["hwc", "hwc_bgr"])
def test_layout_prep(layout):
    h, w = 16, 200
    hp, wp = tref.pad_geometry(h, w)
    frames = np.random.default_rng(1).integers(0, 256, (3, h, w, 3),
                                               np.uint8)
    _, _, jprep = jref.make_layout_prep(layout, h, w, hp, wp)
    swap, tprep = tref.make_layout_prep(layout, h, w, hp, wp)
    assert swap == (layout == "hwc_bgr")
    exp = np.asarray(jprep(jnp.asarray(frames)))
    np.testing.assert_array_equal(tprep(torch.from_numpy(frames)).numpy(),
                                  exp)
    np.testing.assert_array_equal(
        tref.planarize_host(frames[0], hp, wp, swap_rb=swap), exp[0])


@pytest.mark.parametrize("chroma", list(ChromaFilter))
def test_intensity(chroma):
    raw = planar_clip(3, H, W, 2)
    exp = np.asarray(jref.intensity_planar(jnp.asarray(raw), chroma))
    got = tref.intensity_planar(torch.from_numpy(raw),
                                props_from_jax(DiPsProperties(
                                    chroma=chroma)).chroma).numpy()
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("window", [1, 3, 5, 7])
def test_spatial_median(window):
    planes = np.random.default_rng(3).integers(
        0, 511, (2, 16, 40)).astype(np.float32)
    exp = np.asarray(jref.spatial_median(jnp.asarray(planes), window))
    got = tref.spatial_median(torch.from_numpy(planes), window).numpy()
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("t", [1, 2, 3, 4, 9, 16])
def test_temporal_median(t):
    slots = np.random.default_rng(t).integers(0, 511, (t, 8, 16)) \
        .astype(np.float32)
    exp = np.asarray(jref.temporal_median_windows(jnp.asarray(slots), t))[0]
    got = tref.temporal_median([torch.from_numpy(s) for s in slots]).numpy()
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("filt", list(DiPsFilter))
@pytest.mark.parametrize("k,sens", [(5.0, 5.0), (1.0, 0.7), (10.0, 12.5)])
def test_emphasize(filt, k, sens):
    # every diff the pipeline can produce: (int in [-510, 510]) / 510
    diff = (np.arange(-510, 511, dtype=np.float32)
            * np.float32(1.0 / 510.0))
    exp = np.asarray(jref.emphasize(jnp.asarray(diff), filt, k, sens))
    pf = props_from_jax(DiPsProperties(filter=filt)).filter
    got = tref.emphasize(torch.from_numpy(diff), pf, k, sens).numpy()
    # exp/log may differ by an ulp between the two libraries; the sigmoid
    # then subtracts 0.5, so the bound is a few ulp of 0.5, times sens
    np.testing.assert_allclose(got, exp, rtol=2e-6,
                               atol=4 * np.spacing(np.float32(0.5)) * sens)
    q = [tref.quantize_u8(torch.from_numpy(0.5 - x)).numpy().astype(int)
         for x in (got, exp)]
    assert np.abs(q[0] - q[1]).max() <= 1


def test_color_planes_and_quantize():
    d = np.linspace(-1.2, 1.2, 2001, dtype=np.float32)
    exp = [np.asarray(x) for x in jref.diff_to_color_planes(jnp.asarray(d))]
    got = [x.numpy() for x in tref.diff_to_color_planes(torch.from_numpy(d))]
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g, e)
        np.testing.assert_array_equal(
            tref.quantize_u8(torch.from_numpy(g)).numpy(),
            np.asarray(jref.quantize_u8(jnp.asarray(e))))
    # exact ties k + 0.5 round half to even
    ties = (np.arange(255, dtype=np.float32) + np.float32(0.5)) / 255
    np.testing.assert_array_equal(
        tref.quantize_u8(torch.from_numpy(ties)).numpy(),
        np.asarray(jref.quantize_u8(jnp.asarray(ties))))


@pytest.mark.parametrize("roi", [None, (2, 3, 10, 100)])
def test_valid_mask(roi):
    np.testing.assert_array_equal(
        tref.valid_mask(16, 256, H, W, roi).numpy(),
        np.asarray(jref.valid_mask(16, 256, H, W, roi)))


def test_constants():
    from dips_tpu.ops import oracle
    assert tref.NUM_STATS == oracle.NUM_STATS
    assert tref.STAT_NAMES == oracle.STAT_NAMES
    assert tref.INV_SIGMOID_EPS == oracle.INV_SIGMOID_EPS
    assert np.float32(tref.INTENSITY_SCALE) == oracle.INTENSITY_SCALE


# ---------------------------------------------------------------------------
# plain kernel twins against the Pallas kernels
# ---------------------------------------------------------------------------

RAW_CASES = [p for p in CASES if p.output in (OutputMode.ABSDIFF,
                                             OutputMode.THRESHOLD)] + [
    DiPsProperties(output=OutputMode.ABSDIFF, roi=(2, 5, 10, 120)),
    DiPsProperties(output=OutputMode.STATS_ONLY,
                   method=DiPsMethod.PER_FRAME),
]
MEDIAN_CASES = [p for p in CASES if p.output in (OutputMode.COLORIZE,
                                                OutputMode.GRAYSCALE)] + [
    DiPsProperties(),
    DiPsProperties(window_size=7, temporal_size=5,
                   filter=DiPsFilter.INVERSE_SIGMOID,
                   chroma=ChromaFilter.BLUE),
    DiPsProperties(method=DiPsMethod.PER_FRAME, roi=(2, 5, 10, 120),
                   chroma=ChromaFilter.GREEN),
    DiPsProperties(output=OutputMode.GRAYSCALE, emit_maps=False),
]
#: (flags, valid, offset, seed) of two consecutive batches: a fresh stream
#: with a capture, then a partial batch whose padding must not touch state
BATCHES = [([1, 0, 1, 0], [1, 1, 1, 1], 0, 1),
           ([0, 1, 0, 1], [1, 1, 0, 0], 4, 0)]


def _compare_maps(got, exp, exact):
    g = got[..., :H, :W].astype(np.int16)
    e = exp[..., :H, :W].astype(np.int16)
    if exact:
        np.testing.assert_array_equal(g, e)
    else:
        assert np.abs(g - e).max(initial=0) <= 1


def _compare_stats(got, exp):
    np.testing.assert_array_equal(got[:, 2:], exp[:, 2:])
    np.testing.assert_allclose(got[:, :2], exp[:, :2], rtol=0, atol=1e-6)


@pytest.mark.parametrize("props", RAW_CASES)
def test_absdiff_step_ring_plain_matches_pallas(props):
    hp, wp = tref.pad_geometry(H, W)
    raw = planar_clip(8, H, W, 4)
    pp = props_from_jax(props)
    jstate = [jnp.zeros((3, hp, wp), jnp.uint8), jnp.zeros((3, hp, wp),
                                                           jnp.uint8),
              jnp.zeros((hp, wp), jnp.float32)]
    tstate = [torch.zeros((3, hp, wp), dtype=torch.uint8),
              torch.zeros((3, hp, wp), dtype=torch.uint8),
              torch.zeros((hp, wp))]
    for i, (flags, valid, _, seed) in enumerate(BATCHES):
        x = raw[4 * i:4 * i + 4]
        prev, base, heat = jstate
        jo = pallas_fused.absdiff_step_ring(
            props, H, W, jnp.asarray(x), prev, base,
            jnp.asarray(flags, bool), heat, jnp.asarray(valid, bool),
            jnp.int32(seed))
        jstate = list(jo[2:])
        to = cuda_fused.absdiff_step_ring(
            pp, H, W, torch.from_numpy(x), *tstate[:2],
            torch.tensor(flags, dtype=torch.bool), tstate[2],
            torch.tensor(valid, dtype=torch.bool), seed)
        assert to[0].shape == jo[0].shape
        _compare_maps(to[0].numpy(), np.asarray(jo[0]), exact=True)
        _compare_stats(to[1].numpy(), np.asarray(jo[1]))
        for g, e in zip(to[2:4], jo[2:4]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(e))
        np.testing.assert_allclose(to[4].numpy(), np.asarray(jo[4]),
                                   atol=1e-4)


@pytest.mark.parametrize("props", MEDIAN_CASES)
def test_batch_step_ring_plain_matches_pallas(props):
    hp, wp = tref.pad_geometry(H, W)
    t = props.temporal_size
    raw = planar_clip(8, H, W, 5)
    pp = props_from_jax(props)
    jstate = [jnp.zeros((t, hp, wp), jnp.float32)] + [
        jnp.zeros((hp, wp), jnp.float32) for _ in range(3)]
    tstate = [torch.zeros((t, hp, wp))] + [torch.zeros((hp, wp))
                                            for _ in range(3)]
    for i, (flags, valid, off, seed) in enumerate(BATCHES):
        x = raw[4 * i:4 * i + 4]
        ring, prev, base, heat = jstate
        jo = pallas_fused.batch_step_ring(
            props, H, W, jnp.asarray(x), ring, prev, base,
            jnp.asarray(flags, bool), heat, jnp.asarray(valid, bool),
            jnp.int32(off % t), jnp.int32(seed))
        jstate = list(jo[2:])
        to = cuda_fused.batch_step_ring(
            pp, H, W, torch.from_numpy(x), *tstate[:3],
            torch.tensor(flags, dtype=torch.bool), tstate[3],
            torch.tensor(valid, dtype=torch.bool), off % t, seed)
        assert to[0].shape == jo[0].shape
        _compare_maps(to[0].numpy(), np.asarray(jo[0]), exact=False)
        _compare_stats(to[1].numpy(), np.asarray(jo[1]))
        for g, e in zip(to[2:5], jo[2:5]):
            np.testing.assert_array_equal(g.numpy()[..., :H, :W],
                                          np.asarray(e)[..., :H, :W])
        np.testing.assert_allclose(to[5].numpy(), np.asarray(jo[5]),
                                   atol=1e-4)


def test_plain_twins_update_state_in_place():
    props = props_from_jax(DiPsProperties(method=DiPsMethod.PER_FRAME))
    hp, wp = tref.pad_geometry(H, W)
    raw = torch.from_numpy(planar_clip(4, H, W, 6))
    ring = torch.zeros((4, hp, wp))
    prev, base, heat = (torch.zeros((hp, wp)) for _ in range(3))
    out = cuda_fused.batch_step_ring(props, H, W, raw, ring, prev, base,
                                     torch.zeros(4, dtype=torch.bool), heat,
                                     torch.ones(4, dtype=torch.bool), 0, 1)
    assert out[2] is ring and out[3] is prev and out[5] is heat
    assert float(heat.sum()) > 0 and float(ring.sum()) > 0
