"""The port's tail-protocol steps against the JAX package on the CPU.

* ``cuda_fused.absdiff_step`` / ``batch_step`` and their stacked forms
  (plain twins on CPU tensors) against the Pallas functions of the same
  name in interpret mode, as the JAX package's own tests run them.
* ``reference.absdiff_step`` / ``batch_step`` of the port against
  ``dips_tpu.ops.reference``.

Inputs are made with numpy from a seed.  Each step takes the T tail frames
ahead of the B new ones.  Two batches per case: a fresh stream with two
captures, then a partial batch whose slot 3 is flagged but invalid (the
tail kernels capture on it all the same: their state writes are not
gated).  Sizes: H = 12, W = 140 (Hp = 16, Wp = 256), B = 4, S = 3; the
stream-edge cases use H = 16, where no padding rows separate the streams.

Tolerances (as in ``tests/test_torch_ops.py``): integer maps and u8 state
exact; emphasis maps within 1 LSB; stats atol 1e-6 with changed counts and
maxima exact; heatmap atol 1e-4; float state exact on the true region.  The
padded region of maps is not compared: the Pallas kernel's x-taps wrap
around there, the port reads zeros.
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

H, W, B, S = 12, 140, 4, 3
RAW = (OutputMode.ABSDIFF, OutputMode.THRESHOLD, OutputMode.STATS_ONLY)

#: (flags, valid) of two consecutive batches: a fresh stream with two
#: captures, then a partial batch with a flagged invalid slot
BATCHES = [([1, 0, 1, 0], [1, 1, 1, 1]),
           ([0, 1, 0, 1], [1, 1, 1, 0])]

TAIL_CASES = CASES + [
    DiPsProperties(),
    DiPsProperties(window_size=7, temporal_size=5,
                   filter=DiPsFilter.INVERSE_SIGMOID,
                   chroma=ChromaFilter.BLUE),
    DiPsProperties(method=DiPsMethod.PER_FRAME, roi=(2, 5, 10, 120),
                   chroma=ChromaFilter.GREEN),
    DiPsProperties(output=OutputMode.GRAYSCALE, emit_maps=False),
    DiPsProperties(output=OutputMode.ABSDIFF, roi=(2, 5, 10, 120)),
    DiPsProperties(output=OutputMode.STATS_ONLY,
                   method=DiPsMethod.PER_FRAME),
]


def is_raw(props):
    return props.output in RAW


def planar(clip, h, w):
    hp, wp = tref.pad_geometry(h, w)
    raw = np.zeros((len(clip), 3, hp, wp), np.uint8)
    raw[:, :, :h, :w] = np.asarray(clip).transpose(0, 3, 1, 2)
    return raw


def tail_batches(props, raw_all):
    """(raw (T+B, ...), flags, valid) per batch: batch i is frames
    [i*B, i*B + T + B) of ``raw_all``; a partial batch's padding slots
    replicate its last valid frame."""
    t = props.temporal_size
    for i, (flags, valid) in enumerate(BATCHES):
        x = raw_all[i * B:i * B + t + B].copy()
        n = sum(valid)
        x[t + n:] = x[t + n - 1]
        yield x, np.asarray(flags, bool), np.asarray(valid, bool)


def zero_state(props, rows, xp):
    """Zero (baseline, heatmap) of ``rows`` = (Hp or S*Hp, Wp)."""
    shapes = [((3,) + rows if is_raw(props) else rows,
               np.uint8 if is_raw(props) else np.float32),
              (rows, np.float32)]
    if xp == "jax":
        return [jnp.zeros(sh, dt) for sh, dt in shapes]
    return [torch.from_numpy(np.zeros(sh, dt)) for sh, dt in shapes]


def assert_maps(props, got, exp, h, hp):
    """(..., s*Hp, Wp) maps compared on each stream's true region."""
    g, e = np.asarray(got), np.asarray(exp)
    assert g.shape == e.shape
    per = lambda a: a.reshape(a.shape[:-2] + (a.shape[-2] // hp, hp,
                                              a.shape[-1]))[
        ..., :h, :W].astype(np.int16)
    d = np.abs(per(g) - per(e))
    assert d.max(initial=0) <= (0 if is_raw(props) else 1)


def assert_stats(got, exp):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape
    np.testing.assert_array_equal(got[..., 2:], exp[..., 2:])
    np.testing.assert_allclose(got[..., :2], exp[..., :2], rtol=0, atol=1e-6)


def assert_state(props, got, exp, h, hp):
    """(baseline, heatmap): the baseline exact on each stream's true
    region, the heatmap whole within 1e-4."""
    gb, eb = np.asarray(got[0]), np.asarray(exp[0])
    per = lambda a: a.reshape(a.shape[:-2] + (a.shape[-2] // hp, hp,
                                              a.shape[-1]))[..., :h, :W]
    np.testing.assert_array_equal(per(gb), per(eb))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(exp[1]),
                               atol=1e-4)


# ---------------------------------------------------------------------------
# one stream: the tail wrappers and the plain reference steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("props", TAIL_CASES)
def test_tail_step_matches_pallas(props):
    hp, wp = tref.pad_geometry(H, W)
    raw_all = planar(make_clip(n=2 * B + props.temporal_size, h=H, w=W,
                               seed=4), H, W)
    pp = props_from_jax(props)
    jfn = pallas_fused.absdiff_step if is_raw(props) \
        else pallas_fused.batch_step
    tfn = cuda_fused.absdiff_step if is_raw(props) else cuda_fused.batch_step
    js, ts = zero_state(props, (hp, wp), "jax"), \
        zero_state(props, (hp, wp), "torch")
    before = cuda_fused.launch_counts()
    for x, flags, valid in tail_batches(props, raw_all):
        jo = jfn(props, H, W, jnp.asarray(x), js[0], jnp.asarray(flags),
                 js[1], jnp.asarray(valid))
        to = tfn(pp, H, W, torch.from_numpy(x), ts[0],
                 torch.from_numpy(flags), ts[1], torch.from_numpy(valid))
        js = list(jo[2:])
        assert to[2] is ts[0] and to[3] is ts[1]  # updated in place
        assert_maps(props, to[0].numpy(), jo[0], H, hp)
        assert_stats(to[1].numpy(), jo[1])
        assert_state(props, [x.numpy() for x in to[2:]], jo[2:], H, hp)
    # the plain twin ran: no kernel was counted
    assert cuda_fused.launch_counts() == before


@pytest.mark.parametrize("props", TAIL_CASES[:7])
def test_reference_step_matches_jax(props):
    """The port's plain tail steps against ``dips_tpu.ops.reference``
    (the JAX package's portable backend)."""
    hp, wp = tref.pad_geometry(H, W)
    raw_all = planar(make_clip(n=2 * B + props.temporal_size, h=H, w=W,
                               seed=5), H, W)
    pp = props_from_jax(props)
    jfn = jref.absdiff_step if is_raw(props) else jref.batch_step
    tfn = tref.absdiff_step if is_raw(props) else tref.batch_step
    js, ts = zero_state(props, (hp, wp), "jax"), \
        zero_state(props, (hp, wp), "torch")
    for x, flags, valid in tail_batches(props, raw_all):
        jo = jfn(props, H, W, jnp.asarray(x), js[0], jnp.asarray(flags),
                 js[1], jnp.asarray(valid))
        to = tfn(pp, H, W, torch.from_numpy(x), ts[0],
                 torch.from_numpy(flags), ts[1], torch.from_numpy(valid))
        js, ts = list(jo[2:]), list(to[2:])
        assert_maps(props, to[0].numpy(), jo[0], H, hp)
        assert_stats(to[1].numpy(), jo[1])
        assert_state(props, [x.numpy() for x in to[2:]], jo[2:], H, hp)


@pytest.mark.parametrize("t,b", [(9, 8), (16, 4), (1, 3)])
def test_long_and_short_rings(t, b):
    """T up to 16, T = 9 with B = 8 (coprime), and T = 1: the tail twin
    against the Pallas kernel."""
    props = DiPsProperties(window_size=3, temporal_size=t)
    hp, wp = tref.pad_geometry(H, W)
    x = planar(make_clip(n=t + b, h=H, w=W, seed=t), H, W)
    flags = np.zeros(b, bool)
    flags[0] = True
    valid = np.ones(b, bool)
    js, ts = zero_state(props, (hp, wp), "jax"), \
        zero_state(props, (hp, wp), "torch")
    jo = pallas_fused.batch_step(props, H, W, jnp.asarray(x), js[0],
                                 jnp.asarray(flags), js[1],
                                 jnp.asarray(valid))
    to = cuda_fused.batch_step(props_from_jax(props), H, W,
                               torch.from_numpy(x), ts[0], flags, ts[1],
                               valid)
    assert_maps(props, to[0].numpy(), jo[0], H, hp)
    assert_stats(to[1].numpy(), jo[1])
    assert_state(props, [x.numpy() for x in to[2:]], jo[2:], H, hp)


def test_tail_step_checks_its_arguments():
    pp = props_from_jax(DiPsProperties())
    hp, wp = tref.pad_geometry(H, W)
    base, heat = torch.zeros((hp, wp)), torch.zeros((hp, wp))
    ok = np.ones(B, bool)
    with pytest.raises(ValueError):  # no new frame after the T=4 tail
        cuda_fused.batch_step(pp, H, W,
                              torch.zeros((4, 3, hp, wp), dtype=torch.uint8),
                              base, ok[:0], heat, ok[:0])
    raw = torch.zeros((4 + B, 3, hp, wp), dtype=torch.uint8)
    with pytest.raises(ValueError):  # flags of the wrong length
        cuda_fused.batch_step(pp, H, W, raw, base, ok[:3], heat, ok)
    with pytest.raises(ValueError):  # a raw mode is not a median step
        cuda_fused.batch_step(props_from_jax(DiPsProperties(
            output=OutputMode.ABSDIFF)), H, W, raw, base, ok, heat, ok)
    # the spatial modes run (held against Pallas in
    # tests/test_torch_filters.py)
    for props in (DiPsProperties(approx_median=True),
                  DiPsProperties(quirk_compat=True)):
        out = tref.batch_step(props_from_jax(props), H, W, raw, base, ok,
                              heat, ok)
        assert out[0].shape == (B, 3, hp, wp)


# ---------------------------------------------------------------------------
# stacked streams
# ---------------------------------------------------------------------------

STACKED_CASES = [
    DiPsProperties(window_size=3, temporal_size=4),
    DiPsProperties(window_size=7, temporal_size=3,
                   method=DiPsMethod.PER_FRAME,
                   filter=DiPsFilter.INVERSE_SIGMOID,
                   output=OutputMode.GRAYSCALE, roi=(1, 4, 11, 130)),
    DiPsProperties(output=OutputMode.ABSDIFF),
    DiPsProperties(output=OutputMode.THRESHOLD, method=DiPsMethod.PER_FRAME,
                   roi=(3, 7, 10, 100), change_threshold=15),
]

#: per batch: flags (S, B), valid (S, B): stream 2 all-invalid in the first
#: batch, a flagged invalid slot and a partial stream in the second
STACKED_BATCHES = [
    ([[1, 0, 1, 0], [0, 1, 0, 0], [1, 0, 0, 1]],
     [[1, 1, 1, 1], [1, 1, 1, 1], [0, 0, 0, 0]]),
    ([[0, 1, 0, 1], [1, 0, 0, 0], [0, 0, 1, 0]],
     [[1, 1, 1, 0], [1, 1, 1, 1], [1, 1, 0, 0]]),
]


def stacked_raw(n, h, contrast):
    """(n, 3, S*Hp, Wp) u8: seeded clips stacked along the rows;
    ``contrast``: stream 1 is white with a moving dark bar, between two
    noisy streams."""
    hp, wp = tref.pad_geometry(h, W)
    raw = np.zeros((n, 3, S * hp, wp), np.uint8)
    for si in range(S):
        clip = make_clip(n=n, h=h, w=W, seed=20 + si).transpose(0, 3, 1, 2)
        if contrast and si == 1:
            clip = np.full_like(clip, 255)
            for i in range(n):
                clip[i, :, h // 2:h // 2 + 2, 10 + 8 * i:18 + 8 * i] = 40
        raw[:, :, si * hp:si * hp + h, :W] = clip
    return raw


@pytest.mark.parametrize("h", [H, 16])
@pytest.mark.parametrize("props", STACKED_CASES)
def test_stacked_tail_step_matches_pallas(props, h):
    """h = 16: no padding rows between the streams, and stream 1 white
    between two noisy ones, so a leak across a stream edge would show."""
    t = props.temporal_size
    hp, wp = tref.pad_geometry(h, W)
    raw_all = stacked_raw(2 * B + t, h, contrast=h == 16)
    pp = props_from_jax(props)
    jfn = pallas_fused.absdiff_step_stacked if is_raw(props) \
        else pallas_fused.batch_step_stacked
    tfn = cuda_fused.absdiff_step_stacked if is_raw(props) \
        else cuda_fused.batch_step_stacked
    js, ts = zero_state(props, (S * hp, wp), "jax"), \
        zero_state(props, (S * hp, wp), "torch")
    for i, (flags, valid) in enumerate(STACKED_BATCHES):
        x = raw_all[i * B:i * B + t + B]
        fl, va = np.asarray(flags, bool), np.asarray(valid, bool)
        jo = jfn(props, h, W, S, jnp.asarray(x), js[0], jnp.asarray(fl),
                 js[1], jnp.asarray(va))
        to = tfn(pp, h, W, S, torch.from_numpy(x), ts[0],
                 torch.from_numpy(fl), ts[1], torch.from_numpy(va))
        js = list(jo[2:])
        assert to[1].shape == (S, B, 4)
        assert_maps(props, to[0].numpy(), jo[0], h, hp)
        assert_stats(to[1].numpy(), jo[1])
        assert_state(props, [x.numpy() for x in to[2:]], jo[2:], h, hp)


@pytest.mark.parametrize("props", [STACKED_CASES[1], STACKED_CASES[3]])
def test_stacked_tail_streams_equal_single_streams(props):
    """Each stream of a stacked tail step equals the single-stream tail
    step on that stream's rows alone."""
    h, t = 16, props.temporal_size
    hp, wp = tref.pad_geometry(h, W)
    pp = props_from_jax(props)
    raw = torch.from_numpy(stacked_raw(t + B, h, contrast=True))
    flags, valid = (torch.tensor(a, dtype=torch.bool)
                    for a in STACKED_BATCHES[1])
    st = zero_state(props, (S * hp, wp), "torch")
    stacked = cuda_fused.absdiff_step_stacked if is_raw(props) \
        else cuda_fused.batch_step_stacked
    one = cuda_fused.absdiff_step if is_raw(props) else cuda_fused.batch_step
    res = stacked(pp, h, W, S, raw, st[0], flags, st[1], valid)
    for si in range(S):
        r = slice(si * hp, (si + 1) * hp)
        s1 = zero_state(props, (hp, wp), "torch")
        exp = one(pp, h, W, raw[:, :, r].contiguous(), s1[0], flags[si],
                  s1[1], valid[si])
        assert torch.equal(res[0][:, :, r], exp[0])
        assert torch.equal(res[1][si], exp[1])
        for g, e in zip(res[2:], exp[2:]):
            assert torch.equal(g[..., r, :], e)
