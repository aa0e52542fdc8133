"""The port's fleet path against the JAX package's, on the CPU.

* The stacked ring steps (``cuda_fused.absdiff_step_ring_stacked`` /
  ``batch_step_ring_stacked``, plain twins here) against the Pallas
  functions of the same name in interpret mode.
* ``MultiStreamEngine`` against ``dips_tpu.parallel.MultiStreamEngine`` on a
  one-device stream mesh with the Pallas backend (the ring-carry protocol).
* Failure isolation and revive.

Fleet and slot checkpoints across the packages, ``run_dips_on_files`` and
the ``--inputs`` CLI are held in ``tests/test_torch_fleet_io.py``.

Inputs are made with numpy from a seed (``tests.conftest.make_clip``, one
seed per stream).  Sizes: H = 12, W = 140 (Hp = 16, Wp = 256), S = 3, B = 4,
windows 3 and 7, T = 4; the stream-edge cases use H = 16, where no padding
rows separate the streams, so a halo or roi leak across a stream edge
reaches the true region.

Tolerances: raw maps exact; emphasis maps within 1 LSB; stats atol 1e-6
with maxima and counts exact; ``gmean`` rtol 1e-6; heatmap atol 1e-4;
baseline and carried state exact on the true region.  The padded columns
are not compared: the Pallas kernel's x-taps wrap around there.
"""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dips_tpu.ops import pallas_fused
from dips_tpu.parallel import MultiStreamEngine as JaxFleet
from dips_tpu.parallel import stream_mesh
from dips_tpu.properties import (ChromaFilter, DiPsFilter, DiPsMethod,
                                 DiPsProperties, OutputMode)
from dips_tpu_torch import DiPsEngine as TorchEngine
from dips_tpu_torch import MultiStreamEngine as TorchFleet
from dips_tpu_torch import StreamError
from dips_tpu_torch.convert import props_from_jax
from dips_tpu_torch.ops import cuda_fused
from dips_tpu_torch.ops.reference import pad_geometry
from tests.conftest import make_clip
from tests.test_ring_carry import CASES

torch.set_num_threads(1)

H, W, S, B = 12, 140, 3, 4
RAW = (OutputMode.ABSDIFF, OutputMode.THRESHOLD, OutputMode.STATS_ONLY)


def is_raw(props):
    return props.output in RAW


# ---------------------------------------------------------------------------
# the stacked ring steps against the Pallas kernels
# ---------------------------------------------------------------------------

STACKED_CASES = CASES + [
    DiPsProperties(window_size=3, temporal_size=4),
    DiPsProperties(window_size=7, temporal_size=4,
                   filter=DiPsFilter.INVERSE_SIGMOID,
                   chroma=ChromaFilter.BLUE, refresh_markers=(2,)),
    DiPsProperties(method=DiPsMethod.PER_FRAME, window_size=3,
                   temporal_size=4, roi=(2, 5, 9, 120)),
    DiPsProperties(output=OutputMode.THRESHOLD, roi=(3, 7, 10, 100),
                   change_threshold=15),
    DiPsProperties(output=OutputMode.STATS_ONLY,
                   method=DiPsMethod.PER_FRAME, temporal_size=4),
    DiPsProperties(output=OutputMode.GRAYSCALE, emit_maps=False,
                   window_size=7, temporal_size=4),
]

#: per batch: flags (S, B), valid (S, B), offsets (S,), seeds (S,).  Mixed
#: seeds and offsets, stream 2 all-invalid in the first batch, captures on
#: different frames per stream, a partial second batch.
STACKED_BATCHES = [
    ([[1, 0, 1, 0], [0, 1, 0, 0], [1, 0, 0, 1]],
     [[1, 1, 1, 1], [1, 1, 1, 1], [0, 0, 0, 0]], [0, 2, 3], [1, 1, 0]),
    ([[0, 1, 0, 1], [1, 0, 0, 0], [0, 0, 1, 0]],
     [[1, 1, 0, 0], [1, 1, 1, 1], [1, 1, 1, 0]], [4, 6, 3], [0, 0, 1]),
]


def stacked_raw(n, h, w, contrast=False):
    """(n, 3, S*Hp, Wp) u8: S seeded clips stacked along the rows.
    ``contrast``: stream 1 is white (with a moving dark bar) between two
    noisy streams, so a median tap that reads a neighbouring stream's rows
    in place of the zero fill moves the noisy streams' edge rows."""
    hp, wp = pad_geometry(h, w)
    raw = np.zeros((n, 3, S * hp, wp), np.uint8)
    for si in range(S):
        clip = make_clip(n=n, h=h, w=w, seed=10 + si).transpose(0, 3, 1, 2)
        if contrast and si == 1:
            clip = np.full_like(clip, 255)
            for i in range(n):
                clip[i, :, h // 2:h // 2 + 2, 20 + 8 * i:28 + 8 * i] = 40
        raw[:, :, si * hp:si * hp + h, :w] = clip
    return raw


def _init_state(props, hp, wp, xp):
    """Zero stacked state as (JAX arrays | torch tensors)."""
    t = props.temporal_size
    rows = (S * hp, wp)
    if is_raw(props):
        shapes = [((3,) + rows, "u8"), ((3,) + rows, "u8"), (rows, "f32")]
    else:
        shapes = [((t,) + rows, "f32")] + [(rows, "f32")] * 3
    if xp == "jax":
        return [jnp.zeros(sh, jnp.uint8 if d == "u8" else jnp.float32)
                for sh, d in shapes]
    return [torch.zeros(sh, dtype=torch.uint8 if d == "u8"
                        else torch.float32) for sh, d in shapes]


def _true(a, h, hp):
    """(..., S*Hp, Wp) -> (..., S, h, W): each stream's true region."""
    a = np.asarray(a)
    a = a.reshape(a.shape[:-2] + (S, hp, a.shape[-1]))
    return a[..., :h, :W]


def run_stacked_pair(props, h, contrast=False):
    """Both packages' stacked steps over STACKED_BATCHES; yields
    (port result, JAX result, hp) per batch."""
    hp, wp = pad_geometry(h, W)
    raw = stacked_raw(2 * B, h, W, contrast)
    t = props.temporal_size
    pp = props_from_jax(props)
    js, ts = _init_state(props, hp, wp, "jax"), _init_state(props, hp, wp,
                                                            "torch")
    for i, (flags, valid, offs, seeds) in enumerate(STACKED_BATCHES):
        x = raw[i * B:(i + 1) * B]
        fl, va = np.asarray(flags, bool), np.asarray(valid, bool)
        offs = [o % t for o in offs]
        if is_raw(props):
            jo = pallas_fused.absdiff_step_ring_stacked(
                props, h, W, S, jnp.asarray(x), js[0], js[1],
                jnp.asarray(fl), js[2], jnp.asarray(va),
                jnp.asarray(seeds, jnp.int32))
            to = cuda_fused.absdiff_step_ring_stacked(
                pp, h, W, S, torch.from_numpy(x), ts[0], ts[1],
                torch.from_numpy(fl), ts[2], torch.from_numpy(va),
                torch.tensor(seeds))
            js = list(jo[2:])
        else:
            jo = pallas_fused.batch_step_ring_stacked(
                props, h, W, S, jnp.asarray(x), js[0], js[1], js[2],
                jnp.asarray(fl), js[3], jnp.asarray(va),
                jnp.asarray(offs, jnp.int32), jnp.asarray(seeds, jnp.int32))
            to = cuda_fused.batch_step_ring_stacked(
                pp, h, W, S, torch.from_numpy(x), ts[0], ts[1], ts[2],
                fl, ts[3], va, offs, seeds)
            js = list(jo[2:])
        yield to, jo, hp


def assert_stacked_same(props, to, jo, h, hp):
    assert to[0].shape == jo[0].shape
    assert to[1].shape == jo[1].shape == (S, B, 4)
    g = _true(to[0].numpy(), h, hp).astype(np.int16)
    e = _true(jo[0], h, hp).astype(np.int16)
    assert np.abs(g - e).max(initial=0) <= (0 if is_raw(props) else 1)
    gs, es = to[1].numpy(), np.asarray(jo[1])
    np.testing.assert_array_equal(gs[..., 2:], es[..., 2:])
    np.testing.assert_allclose(gs[..., :2], es[..., :2], rtol=0, atol=1e-6)
    for gt, et in zip(to[2:-1], jo[2:-1]):  # ring / prev / baseline
        np.testing.assert_array_equal(_true(gt.numpy(), h, hp),
                                      _true(et, h, hp))
    np.testing.assert_allclose(to[-1].numpy(), np.asarray(jo[-1]),
                               atol=1e-4)


@pytest.mark.parametrize("props", STACKED_CASES)
def test_stacked_step_matches_pallas(props):
    for to, jo, hp in run_stacked_pair(props, H):
        assert_stacked_same(props, to, jo, H, hp)


EDGE_CASES = [
    DiPsProperties(window_size=7, temporal_size=4),
    DiPsProperties(method=DiPsMethod.PER_FRAME, window_size=3,
                   temporal_size=4, output=OutputMode.GRAYSCALE,
                   roi=(1, 4, 15, 130)),
    DiPsProperties(output=OutputMode.THRESHOLD, roi=(2, 3, 14, 120),
                   change_threshold=10),
    DiPsProperties(output=OutputMode.ABSDIFF, method=DiPsMethod.PER_FRAME,
                   roi=(0, 0, 8, 140)),
]


@pytest.mark.parametrize("props", EDGE_CASES)
def test_stacked_stream_edges(props):
    """Contrasting adjacent streams with no padding rows between them
    (H = 16): the halo and the roi stop at each stream's own rows."""
    h = 16
    for to, jo, hp in run_stacked_pair(props, h, contrast=True):
        assert hp == h
        assert_stacked_same(props, to, jo, h, hp)


@pytest.mark.parametrize("props", [EDGE_CASES[0], EDGE_CASES[2]])
def test_stacked_streams_equal_single_streams(props):
    """Each stream of a stacked step equals the single-stream step on that
    stream's rows alone (same flags, valid, offset and seed)."""
    h = 16
    hp, wp = pad_geometry(h, W)
    pp = props_from_jax(props)
    raw = torch.from_numpy(stacked_raw(B, h, W, contrast=True))
    flags, valid, offs, seeds = STACKED_BATCHES[0]
    fl = torch.tensor(flags, dtype=torch.bool)
    va = torch.tensor(valid, dtype=torch.bool)
    st = _init_state(props, hp, wp, "torch")
    if is_raw(props):
        res = cuda_fused.absdiff_step_ring_stacked(
            pp, h, W, S, raw, st[0], st[1], fl, st[2], va, seeds)
    else:
        res = cuda_fused.batch_step_ring_stacked(
            pp, h, W, S, raw, *st[:3], fl, st[3], va, offs, seeds)
    for si in range(S):
        r = slice(si * hp, (si + 1) * hp)
        one = [torch.zeros_like(x[..., r, :]) for x in
               _init_state(props, hp, wp, "torch")]
        if is_raw(props):
            exp = cuda_fused.absdiff_step_ring(
                pp, h, W, raw[:, :, r].contiguous(), one[0], one[1],
                fl[si], one[2], va[si], seeds[si])
        else:
            exp = cuda_fused.batch_step_ring(
                pp, h, W, raw[:, :, r].contiguous(), *one[:3], fl[si],
                one[3], va[si], offs[si], seeds[si])
        assert torch.equal(res[0][:, :, r], exp[0])
        assert torch.equal(res[1][si], exp[1])
        for g, e in zip(res[2:], exp[2:]):
            assert torch.equal(g[..., r, :], e)


def test_stacked_step_checks_its_arguments():
    pp = props_from_jax(DiPsProperties(output=OutputMode.ABSDIFF))
    hp, wp = pad_geometry(H, W)
    raw = torch.zeros((B, 3, S * hp, wp), dtype=torch.uint8)
    st = _init_state(DiPsProperties(output=OutputMode.ABSDIFF), hp, wp,
                     "torch")
    ok = np.ones((S, B), bool)
    with pytest.raises(ValueError):  # flags of one stream, not (S, B)
        cuda_fused.absdiff_step_ring_stacked(pp, H, W, S, raw, st[0], st[1],
                                             ok[0], st[2], ok, [0] * S)
    with pytest.raises(ValueError):  # rows not a multiple of s
        cuda_fused.absdiff_step_ring_stacked(pp, H, W, 5, raw, st[0], st[1],
                                             ok, st[2], ok, [0] * S)


# ---------------------------------------------------------------------------
# the fleet engine against the JAX fleet engine
# ---------------------------------------------------------------------------

def torch_fleet(props):
    return TorchFleet(props_from_jax(props), H, W, n_streams=S, batch=B,
                      device="cpu")


def fleets(props):
    """(the JAX fleet on one device, ring-carry; the port's fleet)."""
    return (JaxFleet(props, H, W, n_streams=S, batch=B, mesh=stream_mesh(1),
                     backend="pallas"), torch_fleet(props))


def clips(n, h=H, w=W, s=S, seed=0):
    return [make_clip(n=n, h=h, w=w, seed=seed + si) for si in range(s)]


def assert_batch_same(props, got, exp):
    (go, gs, gg), (eo, es, eg) = got, exp
    assert go.shape == eo.shape and go.dtype == eo.dtype
    d = np.abs(go.astype(np.int16) - eo.astype(np.int16))
    assert d.max(initial=0) <= (0 if is_raw(props) else 1)
    assert gs.shape == es.shape
    np.testing.assert_array_equal(gs[..., 2:], es[..., 2:])
    np.testing.assert_allclose(gs[..., :2], es[..., :2], rtol=0, atol=1e-6)
    np.testing.assert_allclose(gg, eg, rtol=1e-6, atol=1e-12)


def assert_fleet_state_same(jf, tf):
    np.testing.assert_allclose(tf.heatmaps(), jf.heatmaps(), atol=1e-4)
    jb, tb = jf.state_dict(), tf.state_dict()
    np.testing.assert_array_equal(tb["baseline"][..., :H, :W],
                                  jb["baseline"][..., :H, :W])
    assert tb["frame_cursors"] == jb["frame_cursors"]
    assert tb["failed"] == jb["failed"]
    for a, b in zip(tb["tails"], jb["tails"]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def feed_both(jf, tf, props, feeds):
    exp = jf.process_batch(feeds)
    got = tf.process_batch(feeds)
    assert_batch_same(props, got, exp)
    return got


#: per batch: frames fed to each stream, as (start, count) into its clip;
#: uneven counts, a stream that starts late, an empty stream
UNEVEN = [[(0, 4), (0, 2), None],
          [(4, 3), (2, 4), (0, 1)],
          [(7, 1), None, (1, 4)],
          [(8, 4), (6, 3), (5, 2)]]


@pytest.mark.parametrize("props", CASES + [DiPsProperties(window_size=7,
                                                          temporal_size=4)])
def test_fleet_matches_jax(props):
    cl = clips(12)
    jf, tf = fleets(props)
    for step in UNEVEN:
        feeds = [[] if sp is None else list(cl[si][sp[0]:sp[0] + sp[1]])
                 for si, sp in enumerate(step)]
        feed_both(jf, tf, props, feeds)
    assert_fleet_state_same(jf, tf)
    assert tf.frame_cursors == [12, 9, 7] and tf.frame_index == 12


@pytest.mark.parametrize("props", [CASES[0], CASES[3]])
def test_fleet_snapshot_and_reset_stream(props):
    cl = clips(12, seed=3)
    jf, tf = fleets(props)
    feed_both(jf, tf, props, [list(c[:4]) for c in cl])
    for f in (jf, tf):
        f.snapshot(stream=1)
    got = feed_both(jf, tf, props, [list(c[4:8]) for c in cl])
    assert got[1][1, 0, 3] == 0 and got[1][0, 0, 3] > 0  # only stream 1
    for f in (jf, tf):
        f.reset_stream(2)
        f.snapshot()
    assert tf.frame_cursors[2] == 0 and tf.heatmaps()[2].max() == 0
    feed_both(jf, tf, props, [list(c[8:12]) for c in cl])
    assert_fleet_state_same(jf, tf)


def test_fleet_empty_and_oversized_batches():
    tf = torch_fleet(DiPsProperties())
    out, stats, g = tf.process_batch([[], [], []])
    assert out.shape == (S, 0, H, W, 3) and stats.shape == (S, 0, 4)
    assert g == 0.0
    with pytest.raises(ValueError):
        tf.process_batch([[np.zeros((H, W, 3), np.uint8)] * 5] * S)
    with pytest.raises(ValueError):
        tf.process_batch([[]] * 2)


def test_fleet_bgr_layout_matches_rgb():
    props = props_from_jax(DiPsProperties(method=DiPsMethod.PER_FRAME))
    cl = clips(6, seed=5)
    rgb = TorchFleet(props, H, W, S, batch=3, device="cpu")
    bgr = TorchFleet(props, H, W, S, batch=3, device="cpu",
                     input_layout="hwc_bgr")
    for i in (0, 3):
        a = rgb.process_batch([list(c[i:i + 3]) for c in cl])
        b = bgr.process_batch([[f[..., ::-1].copy() for f in c[i:i + 3]]
                               for c in cl])
        np.testing.assert_array_equal(a[0], b[0])
    for x, y in zip(rgb.state_dict()["tails"], bgr.state_dict()["tails"]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("props", [CASES[1], CASES[4]])
def test_fleet_failure_isolation_and_revive(props):
    """A wrong-shape frame mid-batch isolates its stream; the siblings'
    outputs equal those of a run without the bad stream's frames, and the
    revived stream continues from its old state."""
    cl = clips(12, seed=6)
    jf, tf = fleets(props)
    feed_both(jf, tf, props, [list(c[:4]) for c in cl])
    feeds = [list(c[4:8]) for c in cl]
    feeds[1][2] = np.zeros((H, W + 1, 3), np.uint8)
    got = feed_both(jf, tf, props, feeds)
    assert set(tf.failed) == {1} and isinstance(tf.failed[1], StreamError)
    assert tf.frame_cursors == [8, 4, 8]
    # siblings: as in a run where stream 1 sat this batch out
    ref = torch_fleet(props)
    ref.process_batch([list(c[:4]) for c in cl])
    exp = ref.process_batch([list(cl[0][4:8]), [], list(cl[2][4:8])])
    for si in (0, 2):
        np.testing.assert_array_equal(got[0][si], exp[0][si])
        np.testing.assert_array_equal(got[1][si], exp[1][si])
    # while failed, its feeds are ignored
    feed_both(jf, tf, props, [list(c[8:12]) for c in cl])
    assert tf.frame_cursors[1] == 4
    for f in (jf, tf):
        f.revive(1)
    got = feed_both(jf, tf, props,
                    [[], list(cl[1][4:8]), []])
    single = TorchEngine(props_from_jax(props), H, W, batch=4, device="cpu")
    single.process_batch(list(cl[1][:4]))
    so, ss = single.process_batch(list(cl[1][4:8]))
    np.testing.assert_array_equal(got[0][1], so)
    np.testing.assert_allclose(got[1][1], ss, atol=1e-6)
    assert_fleet_state_same(jf, tf)


def test_fleet_gmean_masks_invalid_slots():
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    cl = clips(4, seed=7)
    jf, tf = fleets(props)
    feeds = [list(cl[0]), list(cl[1][:1]), [np.zeros((4, 4, 3), np.uint8)]]
    out, stats, g = feed_both(jf, tf, props, feeds)
    assert 2 in tf.failed
    np.testing.assert_allclose(
        g, np.mean(np.concatenate([stats[0, :, 1], stats[1, :1, 1]])),
        rtol=1e-6)


def test_fleet_options_validated():
    props = props_from_jax(DiPsProperties())
    with pytest.raises(ValueError, match="slab_impl"):
        TorchFleet(props, H, W, S, device="cpu", slab_impl="nope")
    for impl in ("bands", "extended"):
        TorchFleet(props, H, W, S, device="cpu", slab_impl=impl)
