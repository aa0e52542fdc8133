"""The port's DiPsEngine against the JAX engine on the ring-carry protocol.

The JAX side is ``dips_tpu.DiPsEngine(backend="pallas", ring_carry=True)``
(Pallas in interpret mode on the CPU); the port runs on the CPU, where its
kernels' plain twins run.  Frames are made with numpy from a seed.

Tolerances: ABSDIFF / THRESHOLD maps exact, emphasis maps within 1 LSB;
stats atol 1e-6 with changed counts and maxima exact; heatmap atol 1e-4;
the baseline exact on the true region.
"""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from dips_tpu.models import DiPsEngine as JaxEngine
from dips_tpu.properties import DiPsMethod, DiPsProperties, OutputMode
from dips_tpu_torch import DiPsEngine as TorchEngine
from dips_tpu_torch.convert import props_from_jax, state_from_jax, \
    state_to_jax
from tests.conftest import make_clip
from tests.test_ring_carry import CASES

torch.set_num_threads(1)

H, W = 12, 140
RAW = (OutputMode.ABSDIFF, OutputMode.THRESHOLD, OutputMode.STATS_ONLY)


def engines(props, batch, h=H, w=W):
    return (JaxEngine(props, h, w, batch=batch, backend="pallas",
                      ring_carry=True),
            TorchEngine(props_from_jax(props), h, w, batch=batch,
                        device="cpu"))


def feed(eng, clip, splits=None):
    if splits is None:
        return eng.process_frames(list(clip))
    outs, stats, i = [], [], 0
    for n in splits:
        o, s = eng.process_batch([clip[i + k] for k in range(n)])
        outs.append(o)
        stats.append(s)
        i += n
    return np.concatenate(outs), np.concatenate(stats)


def assert_same(props, got, exp):
    (go, gs), (eo, es) = got, exp
    assert go.shape == eo.shape and go.dtype == eo.dtype
    d = np.abs(go.astype(np.int16) - eo.astype(np.int16))
    assert d.max(initial=0) <= (0 if props.output in RAW else 1)
    np.testing.assert_array_equal(gs[:, 2:], es[:, 2:])
    np.testing.assert_allclose(gs[:, :2], es[:, :2], rtol=0, atol=1e-6)


def assert_same_state(jeng, teng):
    np.testing.assert_allclose(teng.heatmap(), jeng.heatmap(), atol=1e-4)
    jb = np.asarray(jeng._baseline)[..., :H, :W]
    np.testing.assert_array_equal(teng.state_dict()["baseline"][..., :H, :W],
                                  jb)


@pytest.mark.parametrize("props", CASES + [DiPsProperties()])
def test_engine_matches_jax(props):
    clip = make_clip(n=13, h=H, w=W)
    jeng, teng = engines(props, 4)
    assert_same(props, feed(teng, clip), feed(jeng, clip))
    assert_same_state(jeng, teng)
    assert teng.frame_index == jeng.frame_index == 13


@pytest.mark.parametrize("props", [CASES[1], CASES[3]])
def test_engine_matches_jax_batch13(props):
    """One batch holds the whole 13-frame clip (T < B, one launch)."""
    clip = make_clip(n=13, h=H, w=W, seed=1)
    jeng, teng = engines(props, 13)
    assert_same(props, feed(teng, clip), feed(jeng, clip))
    assert_same_state(jeng, teng)


@pytest.mark.parametrize("props", [CASES[0], CASES[1], CASES[4]])
def test_uneven_splits(props):
    """Partial batches pad with replicas of the last frame; the replicas
    must not touch the carried state."""
    clip = make_clip(n=11, h=H, w=W, seed=2)
    jeng, teng = engines(props, 4)
    splits = (1, 3, 2, 4, 1)
    assert_same(props, feed(teng, clip, splits), feed(jeng, clip, splits))
    assert_same_state(jeng, teng)


def test_refresh_markers_and_snapshot():
    props = DiPsProperties(refresh_markers=(5,), window_size=3,
                           temporal_size=2)
    clip = make_clip(n=12, h=16, w=200, seed=3)
    jeng, teng = engines(props, 4, 16, 200)
    res = []
    for eng in (teng, jeng):
        a = eng.process_frames(list(clip[:4]))
        eng.snapshot()
        b = eng.process_frames(list(clip[4:]))
        res.append((np.concatenate([a[0], b[0]]),
                    np.concatenate([a[1], b[1]])))
    assert_same(props, *res)
    out, stats = res[0]
    for f in (0, 4, 5):  # capture frames render gray and diff nothing
        assert np.array_equal(out[f, ..., 0], out[f, ..., 1])
        assert stats[f, 3] == 0
    assert (stats[1:4, 3] > 0).all()


def test_empty_and_oversized_batches():
    teng = TorchEngine(props_from_jax(DiPsProperties()), H, W, batch=4,
                       device="cpu")
    out, stats = teng.process_batch([])
    assert out.shape == (0, H, W, 3) and stats.shape == (0, 4)
    with pytest.raises(ValueError):
        teng.process_batch([np.zeros((H, W, 3), np.uint8)] * 5)
    with pytest.raises(ValueError):
        teng.process_batch([np.zeros((H + 1, W, 3), np.uint8)])


@pytest.mark.parametrize("props", [CASES[1], CASES[2], CASES[4]])
def test_checkpoint_across_packages(props, tmp_path):
    """Save mid-stream from one package, load into the other, continue:
    the continuation equals an uninterrupted run (both directions)."""
    clip = make_clip(n=12, h=H, w=W, seed=4)
    jref, tref_ = engines(props, 4)
    ref_out, ref_stats = feed(tref_, clip)
    jout, jstats = feed(jref, clip)
    assert_same(props, (ref_out, ref_stats), (jout, jstats))

    # JAX -> port through the .npz checkpoint
    src, _ = engines(props, 4)
    src.process_frames(list(clip[:7]))
    path = str(tmp_path / "jax.npz")
    src.save(path)
    _, dst = engines(props, 4)
    dst.load(path)
    assert_same(props, dst.process_frames(list(clip[7:])),
                (ref_out[7:], ref_stats[7:]))

    # port -> JAX through state dicts
    _, src = engines(props, 4)
    src.process_frames(list(clip[:5]))
    dst, _ = engines(props, 4)
    dst.load_state_dict(state_to_jax(src.state_dict()))
    assert_same(props, dst.process_frames(list(clip[5:])),
                (jout[5:], jstats[5:]))

    # JAX state dict -> port, and port .npz -> port
    src, _ = engines(props, 4)
    src.process_frames(list(clip[:9]))
    _, dst = engines(props, 4)
    dst.load_state_dict(state_from_jax(src.state_dict()))
    dst.save(str(tmp_path / "port.npz"))
    _, dst2 = engines(props, 4)
    dst2.load(str(tmp_path / "port.npz"))
    assert_same(props, dst2.process_frames(list(clip[9:])),
                (ref_out[9:], ref_stats[9:]))


def test_checkpoint_files_have_the_same_layout(tmp_path):
    props = CASES[0]
    clip = make_clip(n=6, h=H, w=W, seed=5)
    jeng, teng = engines(props, 4)
    for eng, name in ((jeng, "j.npz"), (teng, "t.npz")):
        eng.process_frames(list(clip))
        eng.save(str(tmp_path / name))
    zj, zt = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        assert zj[k].shape == zt[k].shape and zj[k].dtype == zt[k].dtype, k
    np.testing.assert_array_equal(zt["tail"], zj["tail"])
    np.testing.assert_array_equal(zt["geometry"], zj["geometry"])


def test_reset_clears_state():
    props = props_from_jax(CASES[1])
    clip = make_clip(n=6, h=H, w=W, seed=6)
    eng = TorchEngine(props, H, W, batch=3, device="cpu")
    first = eng.process_frames(list(clip))
    eng.reset()
    again = eng.process_frames(list(clip))
    np.testing.assert_array_equal(first[0], again[0])
    np.testing.assert_array_equal(first[1], again[1])


def test_bgr_layout_matches_rgb():
    props = props_from_jax(DiPsProperties(method=DiPsMethod.PER_FRAME))
    clip = make_clip(n=5, h=H, w=W, seed=7)
    rgb = TorchEngine(props, H, W, batch=4, device="cpu")
    bgr = TorchEngine(props, H, W, batch=4, device="cpu",
                      input_layout="hwc_bgr")
    a = rgb.process_frames(list(clip))
    b = bgr.process_frames([f[..., ::-1].copy() for f in clip])
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(rgb.state_dict()["tail"],
                                  bgr.state_dict()["tail"])
