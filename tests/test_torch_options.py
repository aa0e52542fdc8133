"""The port's engine options against the JAX package on the CPU:
``downscale``, ``packed_wire``, the planar upload layout and the stage
timers, through both engines, the run path and the CLI; and both engines
with the ``approx_median`` / ``quirk_compat`` spatial filters.

* ``reference.make_layout_prep(downscale=k)`` against ``pool_frame_host``
  and the JAX layout prep; the downscale engines and fleets against the
  JAX ones (Pallas interpret mode) and against engines fed pooled frames;
  checkpoints across the packages.
* ``wire.pack_mask`` against the JAX ``wire.pack_mask``; packed
  ``collect`` against the JAX engine's, byte for byte, padding included.
* The planar layout equal to the hwc one; the StageTimers stages.
* ``DiPsEngine`` / ``MultiStreamEngine`` with the variant filters against
  ``dips_tpu.DiPsEngine`` / ``MultiStreamEngine(backend="pallas")``, ring
  and tail protocol.
* The new CLI flags and their exit codes.

Sizes: H = 16, W = 48 (Wp = 128), inputs at 2x for downscale, B = 3 or 4,
S = 2.  Tolerances: integer maps and packed bytes exact; the port against
itself (pooled frames, planar against hwc, packed against unpacked) byte
for byte; emphasis maps against JAX within 1 LSB; stats atol 1e-6 with
counts and maxima exact; baselines and checkpoint tails exact; heatmaps
atol 1e-4.
"""

import os

import cv2
import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dips_tpu.cli
import dips_tpu_torch.cli
from dips_tpu.models import DiPsEngine as JaxEngine
from dips_tpu.ops import reference as jref
from dips_tpu.ops import wire as jwire
from dips_tpu.parallel import MultiStreamEngine as JaxFleet
from dips_tpu.parallel import stream_mesh
from dips_tpu.properties import (DiPsFilter, DiPsMethod, DiPsProperties,
                                 OutputMode)
from dips_tpu_torch import DiPsEngine, MultiStreamEngine
from dips_tpu_torch.convert import props_from_jax
from dips_tpu_torch.ops import reference as tref
from dips_tpu_torch.ops import wire
from dips_tpu_torch.utils.profiling import StageTimers
from tests.conftest import make_clip

torch.set_num_threads(1)

H, W, B, S = 16, 48, 4, 2
RAW = (OutputMode.ABSDIFF, OutputMode.THRESHOLD, OutputMode.STATS_ONLY)


def assert_same(props, got, exp):
    """(maps, stats) of the port against the JAX engine's."""
    (go, gs), (eo, es) = got, exp
    assert go.shape == eo.shape and go.dtype == eo.dtype
    d = np.abs(go.astype(np.int16) - eo.astype(np.int16))
    assert d.max(initial=0) <= (0 if props.output in RAW else 1)
    np.testing.assert_array_equal(gs[..., 2:], es[..., 2:])
    np.testing.assert_allclose(gs[..., :2], es[..., :2], rtol=0, atol=1e-6)


def assert_state_same(tstate, jstate, h=H, w=W):
    np.testing.assert_array_equal(tstate["baseline"][..., :h, :w],
                                  jstate["baseline"][..., :h, :w])
    np.testing.assert_array_equal(tstate["tail"], jstate["tail"])
    np.testing.assert_allclose(tstate["heatmap"], jstate["heatmap"],
                               atol=1e-4)
    assert tstate["frame_index"] == jstate["frame_index"]


def run(eng, clip, sizes, **kw):
    """Process ``clip`` in batches of ``sizes``; concatenated results."""
    outs, stats, i = [], [], 0
    for k in sizes:
        o, s = eng.process_batch(list(clip[i:i + k]), **kw)
        outs.append(o)
        stats.append(s)
        i += k
    return np.concatenate(outs), np.concatenate(stats)


# ---------------------------------------------------------------------------
# downscale
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 3, 4])
def test_downscale_prep_matches_host_twin_and_jax(k):
    """The layout prep's k x k decimation is bit-equal to
    ``pool_frame_host`` and to the JAX prep (checkpoint tails rely on it),
    with leading batch axes and a BGR swap."""
    rng = np.random.default_rng(k)
    h, w = 8 * k, 12 * k
    frames = rng.integers(0, 256, (2, 3, h, w, 3), np.uint8)
    hp, wp = tref.pad_geometry(h // k, w // k)
    swap, prep = tref.make_layout_prep("hwc", h // k, w // k, hp, wp,
                                       downscale=k)
    assert not swap
    got = prep(torch.from_numpy(frames)).numpy()
    _, _, jprep = jref.make_layout_prep("hwc", h // k, w // k, hp, wp,
                                        downscale=k)
    np.testing.assert_array_equal(got, np.asarray(jprep(jnp.asarray(
        frames))))
    host = tref.pool_frame_host(frames[1, 0], k)
    np.testing.assert_array_equal(got[1, 0, :, :h // k, :w // k],
                                  np.moveaxis(host, -1, 0))
    _, bgr = tref.make_layout_prep("hwc_bgr", h // k, w // k, hp, wp,
                                   downscale=k)
    np.testing.assert_array_equal(bgr(torch.from_numpy(frames[..., ::-1]
                                                       .copy())).numpy(),
                                  got)
    with pytest.raises(ValueError):  # decimation needs a hwc layout
        tref.make_layout_prep("planar", h // k, w // k, hp, wp, downscale=k)


@pytest.mark.parametrize("props,ring", [
    (DiPsProperties(window_size=3, temporal_size=2, refresh_markers=(5,)),
     True),
    (DiPsProperties(output=OutputMode.THRESHOLD, method=DiPsMethod.PER_FRAME,
                    temporal_size=3), False)])
def test_downscale_engine_matches_jax(props, ring):
    """A downscale-2 engine against the JAX one, and against the port's
    engine fed pool_frame_host frames (byte for byte); then a checkpoint
    of each package continues in the other."""
    clip = make_clip(n=11, h=2 * H, w=2 * W, seed=3)
    pp = props_from_jax(props)
    te = DiPsEngine(pp, 2 * H, 2 * W, batch=B, device="cpu", ring_carry=ring,
                    downscale=2)
    je = JaxEngine(props, 2 * H, 2 * W, batch=B, backend="pallas",
                   ring_carry=ring, downscale=2)
    assert (te.height, te.width, te.in_height) == (H, W, 2 * H)
    sizes = (4, 3, 4)
    got = run(te, clip[:7], sizes[:2])
    assert_same(props, got, run(je, clip[:7], sizes[:2]))
    pooled = np.stack([tref.pool_frame_host(f, 2) for f in clip])
    one = DiPsEngine(pp, H, W, batch=B, device="cpu", ring_carry=ring)
    exp = run(one, pooled[:7], sizes[:2])
    assert np.array_equal(got[0], exp[0]) and np.array_equal(got[1], exp[1])
    assert_state_same(te.state_dict(), je.state_dict())
    # checkpoints across the packages, both ways
    t2 = DiPsEngine(pp, 2 * H, 2 * W, batch=B, device="cpu",
                    ring_carry=not ring, downscale=2)
    t2.load_state_dict(je.state_dict())
    j2 = JaxEngine(props, 2 * H, 2 * W, batch=B, backend="pallas",
                   ring_carry=True, downscale=2)
    j2.load_state_dict(te.state_dict())
    rest = clip[7:]
    a, b_ = run(t2, rest, (4,)), run(j2, rest, (4,))
    assert_same(props, a, b_)
    assert_same(props, a, run(te, rest, (4,)))


def test_downscale_fleet_matches_jax():
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    clips = [make_clip(n=6, h=2 * H, w=2 * W, seed=10 + si)
             for si in range(S)]
    tf = MultiStreamEngine(props_from_jax(props), 2 * H, 2 * W, S, batch=3,
                           device="cpu", downscale=2)
    jf = JaxFleet(props, 2 * H, 2 * W, S, batch=3, mesh=stream_mesh(1),
                  backend="pallas", downscale=2)
    assert (tf.height, tf.width) == (H, W)
    for sl in (slice(0, 3), slice(3, 5)):
        feeds = [list(c[sl]) for c in clips]
        go, gs, gg = tf.process_batch(feeds)
        eo, es, eg = jf.process_batch(feeds)
        assert_same(props, (go, gs), (eo, es))
        np.testing.assert_allclose(gg, eg, rtol=1e-6)
    for a, b_ in zip(tf.state_dict()["tails"], jf.state_dict()["tails"]):
        np.testing.assert_array_equal(a, b_)


# ---------------------------------------------------------------------------
# packed_wire
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 48), (3, 1, 24, 128), (0, 8, 4)])
def test_pack_mask_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    for hi in (2, 256):  # {0, 1} bit planes and any-nonzero masks
        m = rng.integers(0, hi, shape).astype(np.uint8)
        got = wire.pack_mask(torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jwire.pack_mask(
            jnp.asarray(m))))
        np.testing.assert_array_equal(got, wire.pack_mask_host(m))
        np.testing.assert_array_equal(wire.unpack_mask(got),
                                      np.where(m > 0, 255, 0))
    with pytest.raises(ValueError):
        wire.pack_mask(torch.zeros((12, 8), dtype=torch.uint8))


@pytest.mark.parametrize("ring", [True, False])
def test_packed_collect_matches_jax(ring):
    """Packed batches equal the JAX engine's packed bytes whole (the
    padding diffs to 0 in both packages); unpacked batches equal the
    unpacked engine's."""
    props = DiPsProperties(output=OutputMode.THRESHOLD,
                           method=DiPsMethod.PER_FRAME, change_threshold=12)
    pp = props_from_jax(props)
    clip = make_clip(n=10, h=H, w=W, seed=5)
    te = DiPsEngine(pp, H, W, batch=B, device="cpu", ring_carry=ring,
                    packed_wire=True)
    je = JaxEngine(props, H, W, batch=B, backend="pallas", ring_carry=ring,
                   packed_wire=True)
    plain = DiPsEngine(pp, H, W, batch=B, device="cpu", ring_carry=ring)
    for i, k in ((0, 4), (4, 2), (6, 4)):
        fb = list(clip[i:i + k])
        exp = plain.process_batch(fb)
        if i == 4:  # the engine unpacks and crops
            np.testing.assert_array_equal(te.process_batch(fb)[0], exp[0])
            je.process_batch(fb)
            continue
        got, st = te.process_batch(fb, packed=True)
        jgot, jst = je.process_batch(fb, packed=True)
        assert got.shape == (k, 1, te.hp // 8, te.wp)
        np.testing.assert_array_equal(got, jgot)
        np.testing.assert_allclose(st, jst, atol=1e-6)
        np.testing.assert_array_equal(
            np.moveaxis(wire.unpack_mask(got)[:, :, :H, :W], 1, -1), exp[0])


def test_packed_wire_rules():
    with pytest.raises(ValueError, match="THRESHOLD"):
        DiPsEngine(props_from_jax(DiPsProperties()), H, W, device="cpu",
                   packed_wire=True)
    with pytest.raises(ValueError, match="THRESHOLD"):
        MultiStreamEngine(props_from_jax(DiPsProperties(
            output=OutputMode.THRESHOLD, emit_maps=False)), H, W, S,
            device="cpu", packed_wire=True)
    eng = DiPsEngine(props_from_jax(DiPsProperties(
        output=OutputMode.THRESHOLD)), H, W, device="cpu")
    with pytest.raises(ValueError, match="packed_wire"):
        eng.process_batch(list(make_clip(n=2, h=H, w=W)), packed=True)


@pytest.mark.parametrize("ring", [True, False])
def test_packed_fleet_equals_unpacked(ring):
    props = props_from_jax(DiPsProperties(output=OutputMode.THRESHOLD))
    clips = [make_clip(n=7, h=H, w=W, seed=20 + si) for si in range(S)]
    fl = [MultiStreamEngine(props, H, W, S, batch=B, device="cpu",
                            ring_carry=ring, packed_wire=pw)
          for pw in (True, False)]
    for feeds in ([list(c[:4]) for c in clips],
                  [list(clips[0][4:7]), []]):
        (a, sa, _), (b_, sb, _) = (f.process_batch(feeds) for f in fl)
        np.testing.assert_array_equal(a, b_)
        np.testing.assert_array_equal(sa, sb)


# ---------------------------------------------------------------------------
# the planar upload layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ring", [True, False])
def test_planar_layout_equals_hwc(ring):
    props = props_from_jax(DiPsProperties(temporal_size=3,
                                          refresh_markers=(4,)))
    clip = make_clip(n=10, h=H, w=W, seed=6)
    pl = DiPsEngine(props, H, W, batch=B, device="cpu", ring_carry=ring,
                    input_layout="planar")
    hwc = DiPsEngine(props, H, W, batch=B, device="cpu", ring_carry=ring)
    t = props.temporal_size
    assert pl.tail_rows == (0 if ring else t) and hwc.tail_rows == 0
    assert pl.new_batch_buffer().shape == (pl.tail_rows + B, 3, pl.hp,
                                           pl.wp)
    exp = run(hwc, clip, (4, 2, 4))
    # planarized on the host by the engine, then by the caller
    got1 = run(pl, clip[:6], (4, 2))
    planes = [tref.planarize_host(f, pl.hp, pl.wp) for f in clip[6:]]
    got2 = pl.process_planar(planes)
    np.testing.assert_array_equal(np.concatenate([got1[0], got2[0]]), exp[0])
    np.testing.assert_array_equal(np.concatenate([got1[1], got2[1]]), exp[1])
    assert_state_same(pl.state_dict(), hwc.state_dict())
    with pytest.raises(ValueError, match="process_planar"):
        hwc.process_planar(planes)


@pytest.mark.parametrize("ring", [True, False])
def test_planar_fleet_equals_hwc(ring):
    """Uneven feeds, an idle stream: the host-planarized fleet (its tails
    uploaded with the frames in the tail protocol) equals the hwc one."""
    props = props_from_jax(DiPsProperties(window_size=3, temporal_size=3))
    clips = [make_clip(n=9, h=H, w=W, seed=30 + si) for si in range(S)]
    fl = [MultiStreamEngine(props, H, W, S, batch=B, device="cpu",
                            ring_carry=ring, input_layout=layout)
          for layout in ("planar", "hwc")]
    for feeds in ([list(clips[0][:4]), list(clips[1][:2])],
                  [[], list(clips[1][2:6])],
                  [list(clips[0][4:7]), list(clips[1][6:9])]):
        (a, sa, ga), (b_, sb, gb) = (f.process_batch(feeds) for f in fl)
        np.testing.assert_array_equal(a, b_)
        np.testing.assert_array_equal(sa, sb)
    sa, sb = (f.state_dict() for f in fl)
    for x, y in zip(sa["tails"], sb["tails"]):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# stage timers
# ---------------------------------------------------------------------------

def test_engine_stage_timers():
    eng = DiPsEngine(props_from_jax(DiPsProperties()), H, W, batch=B,
                     device="cpu")
    eng.timers = StageTimers()
    run(eng, make_clip(n=6, h=H, w=W), (4, 2))
    summary = eng.timers.summary()
    for stage in ("h2d", "dispatch", "d2h"):
        assert summary[stage]["calls"] == 2
    eng.timers = None  # off: nothing is timed
    run(eng, make_clip(n=2, h=H, w=W), (2,))


# ---------------------------------------------------------------------------
# the spatial-filter variants through both engines
# ---------------------------------------------------------------------------

VARIANTS = [
    DiPsProperties(approx_median=True, window_size=7, temporal_size=3,
                   refresh_markers=(5,)),
    DiPsProperties(quirk_compat=True, window_size=5, temporal_size=4,
                   method=DiPsMethod.PER_FRAME,
                   output=OutputMode.GRAYSCALE),
]


@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("props", VARIANTS)
def test_variant_engine_matches_jax(props, ring):
    """Uneven batches and a snapshot; then a checkpoint of the JAX engine
    resumes in the port (the ring rebuilt through the same filter)."""
    clip = make_clip(n=13, h=H, w=W, seed=7)
    te = DiPsEngine(props_from_jax(props), H, W, batch=B, device="cpu",
                    ring_carry=ring)
    je = JaxEngine(props, H, W, batch=B, backend="pallas", ring_carry=ring)
    assert_same(props, run(te, clip[:6], (4, 2)), run(je, clip[:6], (4, 2)))
    te.snapshot()
    je.snapshot()
    assert_same(props, run(te, clip[6:9], (3,)), run(je, clip[6:9], (3,)))
    assert_state_same(te.state_dict(), je.state_dict())
    resumed = DiPsEngine(props_from_jax(props), H, W, batch=B, device="cpu",
                         ring_carry=ring)
    resumed.load_state_dict(je.state_dict())
    exp = run(je, clip[9:], (4,))
    assert_same(props, run(resumed, clip[9:], (4,)), exp)
    assert_same(props, run(te, clip[9:], (4,)), exp)


@pytest.mark.parametrize("props,ring", [(VARIANTS[0], True),
                                        (VARIANTS[1], False)])
def test_variant_fleet_matches_jax(props, ring):
    clips = [make_clip(n=8, h=H, w=W, seed=40 + si) for si in range(S)]
    tf = MultiStreamEngine(props_from_jax(props), H, W, S, batch=B,
                           device="cpu", ring_carry=ring)
    jf = JaxFleet(props, H, W, S, batch=B, mesh=stream_mesh(1),
                  backend="pallas", ring_carry=ring)
    for feeds in ([list(clips[0][:4]), list(clips[1][:3])],
                  [list(clips[0][4:8]), list(clips[1][3:7])]):
        go, gs, _ = tf.process_batch(feeds)
        eo, es, _ = jf.process_batch(feeds)
        assert_same(props, (go, gs), (eo, es))
    np.testing.assert_array_equal(
        tf.state_dict()["baseline"][..., :H, :W],
        np.asarray(jf.state_dict()["baseline"])[..., :H, :W])


# ---------------------------------------------------------------------------
# the run path and the CLI
# ---------------------------------------------------------------------------

def write_clip(path, n, h, w, seed=1):
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"HFYU"), 10,
                         (w, h))
    for f in make_clip(n=n, h=h, w=w, seed=seed):
        vw.write(np.ascontiguousarray(f[..., ::-1]))
    vw.release()
    return str(path)


def read_video(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return np.stack(frames)


def test_run_dips_on_file_options(tmp_path):
    """downscale writes at the analysis geometry; the planar layout,
    packed_wire (THRESHOLD) and the timers change no output byte."""
    import dips_tpu_torch
    src = write_clip(tmp_path / "in.avi", 7, 2 * H, 2 * W)
    props = props_from_jax(DiPsProperties(output=OutputMode.THRESHOLD))
    runs = {}
    for name, kw in (("base", {}), ("planar", dict(input_layout="planar")),
                     ("packed", dict(packed_wire=True, profile=True)),
                     ("down", dict(downscale=2))):
        out = str(tmp_path / f"{name}.avi")
        runs[name] = (dips_tpu_torch.run_dips_on_file(
            src, out, encoding="HFYU", properties=props, batch=B,
            device="cpu", **kw), read_video(out))
    for name in ("planar", "packed"):
        np.testing.assert_array_equal(runs[name][0], runs["base"][0])
        np.testing.assert_array_equal(runs[name][1], runs["base"][1])
    assert runs["down"][1].shape == (7, H, W, 3)
    job = dips_tpu_torch.DiPsJob(properties=props, video_path=src,
                                 output_path=str(tmp_path / "t.avi"),
                                 batch=B, device="cpu", profile=True,
                                 downscale=2)
    dips_tpu_torch.perform_dips(job)
    assert job.frame_geometry == (H, W)
    stages = job.timers.summary()
    for stage in ("decode", "device", "encode", "h2d", "dispatch", "d2h"):
        assert stages[stage]["calls"] > 0, stage
    assert stages["_overall"]["frames"] == 7
    with pytest.raises(ValueError, match="divide"):
        dips_tpu_torch.run_dips_on_file(src, str(tmp_path / "x.avi"),
                                        properties=props, device="cpu",
                                        downscale=3)


def test_cli_new_flags_match_jax(tmp_path, capsys):
    """The same clip through both CLIs with the variant and property flags
    (the JAX CLI on its portable backend): equal videos within 1 LSB; and
    --profile prints the stage timers."""
    src = write_clip(tmp_path / "in.avi", 9, H, W)
    flags = ["--approx-median", "--win_size", "5", "--temporal", "3",
             "--sensitivity", "3", "--threshold", "20", "--roi",
             "2,4,14,40", "--batch", "4", "--encoding", "HFYU"]
    outs = {}
    for name, main, extra in (("j", dips_tpu.cli.main, []),
                              ("t", dips_tpu_torch.cli.main,
                               ["--device", "cpu", "--profile",
                                "--input-layout", "planar"])):
        out = str(tmp_path / f"{name}.avi")
        assert main(["--input", src, "--output", out] + flags + extra) == 0
        outs[name] = read_video(out)
    assert "StageTimers" in capsys.readouterr().out
    d = np.abs(outs["t"].astype(np.int16) - outs["j"].astype(np.int16))
    assert d.max() <= 1


def test_cli_downscale_and_packed(tmp_path):
    src = write_clip(tmp_path / "in.avi", 6, 2 * H, 2 * W)
    out = str(tmp_path / "out.avi")
    main = dips_tpu_torch.cli.main
    assert main([f"--input={src}", f"--output={out}", "--downscale=2",
                 "--temporal=2", "--batch=3", "--device=cpu"]) == 0
    assert read_video(out).shape == (6, H, W, 3)
    assert main([f"--input={src}", f"--output={out}", "--packed-wire",
                 "--output-mode=threshold", "--device=cpu"]) == 0
    outd = str(tmp_path / "o")
    assert main(["--inputs", src, src, f"--output-dir={outd}",
                 "--downscale=2", "--packed-wire", "--output-mode=threshold",
                 "--batch=4", "--device=cpu"]) == 0
    for name in sorted(os.listdir(outd)):
        assert read_video(os.path.join(outd, name)).shape == (6, H, W, 3)


@pytest.mark.parametrize("argv,msg", [
    (["--approx-median", "--quirk-compat"], "approx_median"),
    (["--downscale", "0"], "--downscale must be >= 1"),
    (["--packed-wire", "--output-mode", "stats_only"],
     "--packed-wire needs diff maps"),
    (["--packed-wire", "--no-maps"], "--packed-wire needs diff maps"),
    (["--no-maps", "--output", "{d}/o.avi"], "--no-maps writes no diff"),
    (["--roi", "1,2,3"], "--roi wants"),
])
def test_cli_new_flag_errors_exit_2(tmp_path, capsys, argv, msg):
    """Usage errors exit 2 in both CLIs, with the JAX CLI's message."""
    src = write_clip(tmp_path / "in.avi", 2, H, W)
    argv = ["--input", src] + [a.format(d=tmp_path) for a in argv]
    if "--output" not in argv and "stats_only" not in argv \
            and "--no-maps" not in argv:
        argv += ["--output", str(tmp_path / "o.avi")]
    for main, extra in ((dips_tpu.cli.main, []),
                        (dips_tpu_torch.cli.main, ["--device", "cpu"])):
        assert main(argv + extra) == 2
        assert msg in capsys.readouterr().err
