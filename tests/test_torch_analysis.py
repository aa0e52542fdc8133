"""The port's post-analysis ops (``dips_tpu_torch/ops/analysis.py``) and
their hooks in the run path against the JAX package on the CPU.

* ``temporal_dft``, ``fft_denoise``, ``fft_magnitude_spectrum`` and
  ``denoise_frames`` against the JAX functions (and numpy's float64
  recipes) on seeded inputs.
* ``FlickerAnalyzer`` against the JAX analyzer and the float32 numpy
  mirror of ``tests/test_analysis.py``: every chroma, batching,
  validation, geometry errors, flush frame by frame, a degenerate tau.
* ``perform_dips(DiPsJob(denoise_radius=))`` and the single-stream CLI's
  ``--denoise``, ``--dft-json``, ``--flicker-hz``, ``--flicker-png`` and
  ``--flicker-tau`` against the JAX package's on the same clips, with
  the usage errors' exit codes.

The port runs with ``device="cpu"``.  Tolerances: DFT magnitude rtol 1e-5
+ atol 1e-5, phase (atol 1e-5) where the magnitude exceeds 1e-3 of its
maximum; ``fft_denoise`` and the spectrum rtol 1e-4 + atol 1e-3;
``denoise_frames`` and denoised maps within 1 LSB with at most 1e-3 of
the values flipped; flicker amplitude maps rtol 1e-5 + atol 1e-4 against
JAX; the port against itself (batching) bit for bit.
"""

import json
import math
import os
import re

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import dips_tpu.app
import dips_tpu.cli
import dips_tpu.properties as jprops
import dips_tpu_torch.app
import dips_tpu_torch.cli
from dips_tpu.io import moving_square_clip, write_clip
from dips_tpu.ops import analysis as jan
from dips_tpu_torch import DeviceError
from dips_tpu_torch.convert import props_from_jax
from dips_tpu_torch.ops import analysis as tan
from dips_tpu_torch.properties import ChromaFilter
from tests.test_analysis import _blink_clip, _np_flicker_power

torch.set_num_threads(1)

CPU = dict(device="cpu")
AMP_TOL = dict(rtol=1e-5, atol=1e-4)


def assert_lsb(got, exp, flip_frac=1e-3):
    """uint8 maps within 1 LSB, with at most ``flip_frac`` of the values
    off by one."""
    assert got.shape == exp.shape and got.dtype == exp.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - exp.astype(np.int16))
    assert d.max() <= 1
    assert (d > 0).mean() <= flip_frac


# ---------------------------------------------------------------------------
# temporal DFT, FFT denoise, spectrum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 6, 7), (15, 4), (33,), (2, 3, 5)])
def test_temporal_dft_matches_jax(shape):
    traces = np.random.default_rng(sum(shape)).standard_normal(
        shape).astype(np.float32) * 40
    jm, jp = (np.asarray(a) for a in jan.temporal_dft(traces))
    tm, tp = (a.numpy() for a in tan.temporal_dft(traces, **CPU))
    assert tm.shape == (shape[0] // 2 + 1,) + shape[1:]
    assert tm.dtype == tp.dtype == np.float32
    np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=1e-5)
    live = jm > 1e-3 * jm.max()
    np.testing.assert_allclose(tp[live], jp[live], rtol=1e-5, atol=1e-5)
    f = np.fft.rfft(traces.astype(np.float64), axis=0)
    np.testing.assert_allclose(tm, np.abs(f), rtol=1e-5, atol=1e-4)


def test_temporal_dft_reference_vector():
    """The reference's dft.py analyses [0, 1, 0, -1]: energy only at k=1."""
    mag, _ = tan.temporal_dft(np.array([0., 1., 0., -1.], np.float32), **CPU)
    np.testing.assert_allclose(mag.numpy(), [0.0, 2.0, 0.0], atol=1e-5)


def _np_denoise(img, radius):
    """The reference recipe in numpy float64 (image_denoise.py:13-30)."""
    f = np.fft.fftshift(np.fft.fft2(img.astype(np.float64)), axes=(-2, -1))
    rows, cols = img.shape[-2:]
    mask = np.zeros((rows, cols))
    mask[max(rows // 2 - radius, 0):rows // 2 + radius,
         max(cols // 2 - radius, 0):cols // 2 + radius] = 1
    return np.abs(np.fft.ifft2(np.fft.ifftshift(f * mask, axes=(-2, -1))))


@pytest.mark.parametrize("shape,radius", [((64, 80), 10), ((63, 81), 7),
                                          ((32, 32), 40), ((3, 24, 32), 6),
                                          ((2, 17, 30), 0)])
def test_fft_denoise_matches_jax(shape, radius):
    img = np.random.default_rng(radius).integers(0, 256, shape).astype(
        np.float32)
    got = tan.fft_denoise(img, radius, **CPU).numpy()
    exp = np.asarray(jan.fft_denoise(img, radius))
    assert got.shape == exp.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got, _np_denoise(img, radius), rtol=1e-4,
                               atol=1e-3)


def test_fft_denoise_takes_a_tensor_where_it_lies():
    img = np.random.default_rng(2).integers(0, 256, (20, 24)).astype(
        np.uint8)
    a = tan.fft_denoise(torch.from_numpy(img), 5)
    b = tan.fft_denoise(img, 5, **CPU)
    assert a.device.type == "cpu"
    assert torch.equal(a, b)


def test_fft_denoise_removes_high_frequency():
    x = np.zeros((64, 64), np.float32)
    x += np.sin(np.arange(64) * np.pi)[None, :] * 50  # checkerboard columns
    x += 100.0
    out = tan.fft_denoise(x, radius=4, **CPU).numpy()
    assert np.abs(out - 100.0).max() < 1.0  # high-freq stripe removed


@pytest.mark.parametrize("shape", [(64, 80), (2, 31, 45)])
def test_fft_magnitude_spectrum_matches_jax(shape):
    img = np.random.default_rng(3).integers(0, 256, shape).astype(np.float32)
    got = tan.fft_magnitude_spectrum(img, **CPU).numpy()
    exp = np.asarray(jan.fft_magnitude_spectrum(img))
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("shape,radius", [((3, 24, 32, 3), 6),
                                          ((2, 40, 56, 1), 9),
                                          ((1, 36, 64, 3), 75)])
def test_denoise_frames_matches_jax(shape, radius):
    frames = np.random.default_rng(radius).integers(0, 256, shape, np.uint8)
    got = tan.denoise_frames(frames, radius, **CPU).numpy()
    exp = np.asarray(jan.denoise_frames(frames, radius))
    assert_lsb(got, exp)
    f64 = np.moveaxis(_np_denoise(np.moveaxis(frames, -1, 1), radius), 1, -1)
    assert_lsb(got, np.clip(np.rint(f64), 0, 255).astype(np.uint8))
    if radius < 20:  # low-pass: variance must drop
        assert got.std() < frames.std()


def test_functions_refuse_a_missing_card_and_a_moved_tensor():
    """Array-likes go to ``device`` ("cuda" by default: DeviceError
    without a card); a tensor on another device than the one asked for
    raises instead of moving."""
    x = np.zeros((4, 6), np.float32)
    if not torch.cuda.is_available():
        for fn in (tan.temporal_dft, tan.fft_denoise,
                   tan.fft_magnitude_spectrum):
            with pytest.raises(DeviceError):
                fn(x)
        with pytest.raises(DeviceError):
            tan.denoise_frames(np.zeros((1, 4, 6, 3), np.uint8), 2)
    with pytest.raises(ValueError, match="was asked for"):
        tan.fft_denoise(torch.zeros((4, 6), device="meta"), 2, **CPU)


# ---------------------------------------------------------------------------
# FlickerAnalyzer
# ---------------------------------------------------------------------------

CHROMAS = [("all", None), ("r", "RED"), ("g", "GREEN"), ("b", "BLUE")]


def _pair(*args, chroma=None, **kw):
    """The JAX analyzer and the port's, same arguments."""
    jc = None if chroma is None else jprops.ChromaFilter[chroma]
    tc = None if chroma is None else ChromaFilter[chroma]
    return (jan.FlickerAnalyzer(*args, chroma=jc, **kw),
            tan.FlickerAnalyzer(*args, chroma=tc, device="cpu", **kw))


@pytest.mark.parametrize("key,chroma", CHROMAS)
def test_flicker_matches_jax_and_numpy(key, chroma, rng):
    frames = rng.integers(0, 256, (37, 10, 12, 3), np.uint8)
    ja, ta = _pair(5.0, 24.0, tau_frames=8.0, batch=16, chroma=chroma)
    ja.update(frames)
    ta.update(frames)
    got = ta.power()
    assert got.dtype == np.float32 and ta.frames_seen == 37
    np.testing.assert_allclose(np.sqrt(got), ja.amplitude(), **AMP_TOL)
    np.testing.assert_allclose(
        got, _np_flicker_power(frames, 5.0, 24.0, 8.0, key), rtol=2e-3,
        atol=1e-3)


def test_flicker_separates_frequencies():
    fps, n = 24.0, 240
    frames = _blink_clip(n, 16, 20, fps, freq_a=6.0, freq_b=2.0)
    ja, ta = _pair(6.0, fps, tau_frames=48.0)
    ja.update(frames)
    ta.update(frames)
    amp = ta.amplitude()
    np.testing.assert_allclose(amp, ja.amplitude(), **AMP_TOL)
    in_a = amp[2:6, 2:8].mean()
    in_b = amp[8:12, 10:16].mean()
    bg = np.delete(amp.reshape(-1),
                   np.ravel_multi_index(
                       np.mgrid[2:12, 2:16].reshape(2, -1),
                       amp.shape)).mean()
    assert in_a > 5 * in_b, (in_a, in_b)
    assert in_a > 10 * bg, (in_a, bg)
    # the 2 Hz analyzer picks the other region
    jb, tb = _pair(2.0, fps)
    jb.update(frames)
    tb.update(frames)
    amp2 = tb.amplitude()
    np.testing.assert_allclose(amp2, jb.amplitude(), **AMP_TOL)
    assert amp2[8:12, 10:16].mean() > 5 * amp2[2:6, 2:8].mean()


def test_flicker_amplitude_recovery():
    """A pure intensity sinusoid A*cos reads back ~A (gray frames:
    lightness = 2*pixel value, so pixel swing 64 -> intensity A = 128)."""
    fps, n = 30.0, 600
    t = np.arange(n) / fps
    v = 128.0 + 64.0 * np.cos(2 * math.pi * 5.0 * t)
    frames = np.clip(np.rint(v), 0, 255).astype(np.uint8)
    frames = np.broadcast_to(frames[:, None, None, None],
                             (n, 4, 6, 3)).copy()
    ja, ta = _pair(5.0, fps, tau_frames=60.0)
    ja.update(frames)
    ta.update(frames)
    amp = ta.amplitude()
    np.testing.assert_allclose(amp, 128.0, rtol=0.05)
    np.testing.assert_allclose(amp, ja.amplitude(), **AMP_TOL)
    # and a DC-only stream reads ~0
    fd = tan.FlickerAnalyzer(5.0, fps, tau_frames=60.0, **CPU)
    fd.update(np.full((300, 4, 6, 3), 128, np.uint8))
    assert fd.amplitude().max() < 2.0


@pytest.mark.parametrize("batch", [1, 5, 8, 32])
def test_flicker_incremental_matches_bulk(rng, batch):
    """The maps do not depend on how the frames were batched: bit for bit
    against one frame per update and against the JAX analyzer."""
    frames = rng.integers(0, 256, (23, 5, 7, 3), np.uint8)
    bulk = tan.FlickerAnalyzer(4.0, 24.0, tau_frames=8.0, batch=batch, **CPU)
    bulk.update(frames)
    inc = tan.FlickerAnalyzer(4.0, 24.0, tau_frames=8.0, batch=8, **CPU)
    for fr in frames:
        inc.update(fr)  # single (H, W, 3) frames buffer then dispatch
    np.testing.assert_array_equal(bulk.power(), inc.power())
    assert bulk.frames_seen == inc.frames_seen == 23
    ja = jan.FlickerAnalyzer(4.0, 24.0, tau_frames=8.0, batch=batch)
    ja.update(frames)
    np.testing.assert_allclose(bulk.amplitude(), ja.amplitude(), **AMP_TOL)


def test_flicker_reset_and_validation(rng):
    fa = tan.FlickerAnalyzer(4.0, 24.0, batch=4, **CPU)
    fa.update(rng.integers(0, 256, (6, 5, 7, 3), np.uint8))
    p1 = fa.power()
    fa.reset()
    assert fa.frames_seen == 0
    with pytest.raises(RuntimeError):
        tan.FlickerAnalyzer(4.0, 24.0, **CPU).power()  # no frames yet
    again = rng.integers(0, 256, (6, 5, 7, 3), np.uint8)
    fa.update(again)
    assert fa.power().shape == p1.shape
    fresh = tan.FlickerAnalyzer(4.0, 24.0, batch=4, **CPU)
    fresh.update(again)
    np.testing.assert_array_equal(fa.power(), fresh.power())
    with pytest.raises(ValueError):  # geometry change mid-stream
        fa.update(rng.integers(0, 256, (4, 6, 7, 3), np.uint8))
        fa.flush()
    for args, kw in (((0.0, 24.0), {}),       # freq must be > 0
                     ((12.0, 24.0), {}),      # >= Nyquist
                     ((4.0, 0.0), {}),        # bad fps
                     ((4.0, 24.0), dict(tau_frames=1.0))):
        for cls, extra in ((jan.FlickerAnalyzer, {}),
                           (tan.FlickerAnalyzer, CPU)):
            with pytest.raises(ValueError):
                cls(*args, **kw, **extra)
    with pytest.raises(ValueError):
        tan.FlickerAnalyzer(4.0, 24.0, **CPU).update(
            rng.standard_normal((3, 4, 5, 3)))    # not uint8


def test_flicker_geometry_mismatch_is_loud_and_lossless(rng):
    """A mid-stream geometry change raises the analyzer's own error BEFORE
    any buffered frame is consumed — nothing silently vanishes."""
    fa = tan.FlickerAnalyzer(4.0, 24.0, batch=4, **CPU)
    fa.update(rng.integers(0, 256, (2, 5, 7, 3), np.uint8))  # buffered
    with pytest.raises(ValueError, match="analyzer geometry"):
        fa.update(rng.integers(0, 256, (2, 6, 7, 3), np.uint8))
    # the two good frames are still pending; feeding two more dispatches
    fa.update(rng.integers(0, 256, (2, 5, 7, 3), np.uint8))
    assert fa.frames_seen == 4
    # even before ANY dispatch the first frame pins the geometry
    fb = tan.FlickerAnalyzer(4.0, 24.0, batch=16, **CPU)
    fb.update(rng.integers(0, 256, (5, 7, 3), np.uint8))
    with pytest.raises(ValueError, match="analyzer geometry"):
        fb.update(rng.integers(0, 256, (6, 7, 3), np.uint8))


def test_flicker_flush_dispatches_frame_by_frame(rng, monkeypatch):
    """Flushes dispatch remainders one frame at a time, as the JAX
    analyzer does: only the batch size and N=1 reach the update."""
    fa = tan.FlickerAnalyzer(4.0, 24.0, batch=8, **CPU)
    sizes = []
    real = tan._flicker_update

    def spy(chroma, state, frames, *a):
        sizes.append(int(frames.shape[0]))
        return real(chroma, state, frames, *a)

    monkeypatch.setattr(tan, "_flicker_update", spy)
    fa.update(rng.integers(0, 256, (13, 4, 6, 3), np.uint8))
    fa.power()   # flushes the 5-frame remainder
    fa.update(rng.integers(0, 256, (3, 4, 6, 3), np.uint8))
    fa.power()
    assert sizes == [8] + [1] * 8, sizes
    assert fa.frames_seen == 16


def test_flicker_takes_strided_frames(rng):
    """BGR-flipped views (negative strides) and read-only arrays feed the
    analyzer like contiguous copies."""
    frames = rng.integers(0, 256, (7, 5, 6, 3), np.uint8)
    a = tan.FlickerAnalyzer(4.0, 24.0, batch=4, **CPU)
    b = tan.FlickerAnalyzer(4.0, 24.0, batch=4, **CPU)
    ro = frames[..., ::-1]
    ro.flags.writeable = False
    for f in ro:
        a.update(f)
    b.update(np.ascontiguousarray(frames[..., ::-1]))
    np.testing.assert_array_equal(a.power(), b.power())


def test_flicker_degenerate_tau_yields_zero_not_nan():
    """alpha at the float64 boundary (enormous tau / tiny freq) must read
    zero flicker, never 0/0 NaN planes; non-finite parameters are
    rejected outright."""
    fa = tan.FlickerAnalyzer(1e-15, 30.0, batch=4, **CPU)  # alpha == 1.0
    fa.update(np.full((8, 4, 6, 3), 128, np.uint8))
    p = fa.power()
    assert np.isfinite(p).all() and p.max() == 0.0
    for args, kw in (((5.0, 30.0), dict(tau_frames=float("nan"))),
                     ((5.0, 30.0), dict(tau_frames=float("inf"))),
                     ((5.0, float("inf")), {})):
        with pytest.raises(ValueError):
            tan.FlickerAnalyzer(*args, **kw, **CPU)


def test_flicker_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(DeviceError):
        tan.FlickerAnalyzer(4.0, 24.0)
    with pytest.raises(DeviceError):
        tan.FlickerAnalyzer(4.0, 24.0, device="cuda:0")


# ---------------------------------------------------------------------------
# the run path: perform_dips(denoise_radius=) and the CLI
# ---------------------------------------------------------------------------

def _capture_run(pkg, props, src, out, radius, batch=4):
    """perform_dips of one package with denoise; the maps the frame
    callback saw, and the stats."""
    maps = []

    def cb(idx, inp, m, st):
        maps.append(np.array(m))

    if pkg is dips_tpu_torch.app:
        props, kw = props_from_jax(props), CPU
    else:
        kw = {}
    job = pkg.DiPsJob(properties=props, video_path=src, output_path=out,
                      frame_callback=cb, batch=batch, denoise_radius=radius,
                      **kw)
    stats = pkg.perform_dips(job)
    return np.stack(maps), stats


@pytest.mark.parametrize("output", ["COLORIZE", "GRAYSCALE", "THRESHOLD"])
def test_perform_dips_denoise_matches_jax(output, tmp_path):
    src = write_clip(moving_square_clip(n=9, height=24, width=40, seed=3),
                     str(tmp_path / "in.avi"))
    props = jprops.DiPsProperties(output=jprops.OutputMode[output],
                                  temporal_size=2)
    tm, ts = _capture_run(dips_tpu_torch.app, props, src,
                          str(tmp_path / "t.avi"), 6)
    jm, js = _capture_run(dips_tpu.app, props, src,
                          str(tmp_path / "j.avi"), 6)
    assert tm.shape == jm.shape and tm.shape[0] == 9
    assert_lsb(tm, jm)
    np.testing.assert_allclose(ts, js, atol=1e-6)
    # denoising changed the maps: the run without it differs
    plain, _ = _capture_run(dips_tpu_torch.app, props, src,
                            str(tmp_path / "p.avi"), None)
    assert not np.array_equal(plain, tm)


def test_perform_dips_denoise_needs_maps(tmp_path):
    """Both packages refuse denoise on a map-suppressed pipeline."""
    for pkg, kw, p in ((dips_tpu.app, {}, jprops),
                       (dips_tpu_torch.app, CPU, dips_tpu_torch.properties)):
        props = p.DiPsProperties(output=p.OutputMode.STATS_ONLY)
        job = pkg.DiPsJob(properties=props, video_path="in.avi",
                          denoise_radius=5, **kw)
        with pytest.raises(ValueError, match="denoise"):
            pkg.perform_dips(job)


def _clis():
    return (("j", dips_tpu.cli.main, []),
            ("t", dips_tpu_torch.cli.main, ["--device", "cpu"]))


def test_cli_denoise_and_dft(tmp_path):
    """--denoise and --dft-json through both CLIs: the JSON has N//2 + 1
    bins equal within tolerance, the videos (lossless) within 1 LSB."""
    import cv2
    path = write_clip(moving_square_clip(n=8, height=32, width=48),
                      str(tmp_path / "in.avi"))
    dfts, vids = {}, {}
    for name, main, extra in _clis():
        dft = str(tmp_path / f"{name}.json")
        out = str(tmp_path / f"{name}.avi")
        rc = main(["--input", path, "--output", out, "--temporal=2",
                   "--batch=4", "--denoise", "8", "--dft-json", dft,
                   "--encoding", "HFYU"] + extra)
        assert rc == 0
        dfts[name] = json.load(open(dft))
        cap = cv2.VideoCapture(out)
        vids[name] = np.stack([f for ok, f in iter(cap.read, (False, None))
                               if ok])
        cap.release()
    assert len(dfts["t"]["magnitude"]) == 8 // 2 + 1
    jm, tm = (np.array(dfts[k]["magnitude"]) for k in "jt")
    np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=1e-5)
    live = jm > 1e-3 * jm.max()
    np.testing.assert_allclose(np.array(dfts["t"]["phase"])[live],
                               np.array(dfts["j"]["phase"])[live],
                               rtol=1e-5, atol=1e-5)
    assert vids["t"].shape == vids["j"].shape
    assert_lsb(vids["t"], vids["j"])


@pytest.mark.parametrize("tau", [None, 12.0])
def test_cli_flicker(tmp_path, capsys, tau):
    fps = 24.0
    frames = _blink_clip(96, 16, 20, fps, freq_a=6.0, freq_b=2.0)
    path = write_clip(frames, str(tmp_path / "blink.avi"), fps=fps)
    lines = {}
    for name, main, extra in _clis():
        png = str(tmp_path / f"{name}.png")
        argv = ["--input", path, "--output", str(tmp_path / f"{name}.avi"),
                "--temporal=2", "--batch=8", "--flicker-hz", "6",
                "--flicker-png", png] + extra
        if tau is not None:
            argv += ["--flicker-tau", str(tau)]
        assert main(argv) == 0
        out = capsys.readouterr().out
        lines[name] = [ln for ln in out.splitlines()
                       if ln.startswith("flicker @")]
        assert os.path.getsize(png) > 0
    out = lines["t"][0]
    assert "flicker @ 6 Hz over 96 frames" in out and "peak amplitude" in out
    # the reported peak lands inside the 6 Hz region (MJPG perturbs
    # pixels, so parse the printed location), where the JAX CLI's does
    m = re.search(r"x=(\d+) y=(\d+)", out)
    assert m and 2 <= int(m.group(2)) < 6 and 2 <= int(m.group(1)) < 8, out
    assert m.group(0) in lines["j"][0]
    amp = [float(re.search(r"peak amplitude ([\d.]+)", lines[k][0]).group(1))
           for k in "jt"]
    assert abs(amp[0] - amp[1]) <= 0.1 + 1e-5 * amp[0]


@pytest.mark.parametrize("argv,rc,msg", [
    (["--input", "{src}", "--output", "{d}/o.avi", "--flicker-png",
      "{d}/x.png"], 2, "--flicker-hz"),
    (["--input", "{src}", "--output", "{d}/o.avi", "--flicker-tau", "9"],
     2, "--flicker-hz"),
    (["--input", "{src}", "--output-mode", "stats_only", "--denoise", "5"],
     2, "--denoise needs diff maps"),
    (["--input", "{src}", "--no-maps", "--denoise", "5"], 2,
     "--denoise needs diff maps"),
    (["--inputs", "{src}", "{src}", "--output-dir", "{d}/o", "--dft-json",
      "{d}/d.json"], 2, "--dft-json"),
    (["--input", "{src}", "--output", "{d}/o.avi", "--flicker-hz", "50"],
     1, "resolvable"),
    (["--input", "{src}", "--output", "{d}/o.avi", "--flicker-hz", "3",
      "--flicker-tau", "1"], 1, "tau_frames"),
    (["--inputs", "{src}", "{src}", "--output-dir", "{d}/o",
      "--flicker-hz", "50"], 1, "resolvable"),
    (["--input", "{d}/missing.avi", "--output", "{d}/o.avi",
      "--flicker-hz", "3"], 1, "missing.avi"),
])
def test_cli_flicker_flag_gating(tmp_path, capsys, argv, rc, msg):
    """Usage errors exit 2 and bad analysis parameters exit 1, in both
    CLIs, naming the flag or the cause."""
    src = write_clip(moving_square_clip(n=6, height=16, width=20),
                     str(tmp_path / "in.avi"), fps=10.0)
    argv = [a.format(src=src, d=tmp_path) for a in argv]
    for name, main, extra in _clis():
        assert main(argv + extra) == rc, name
        assert msg in capsys.readouterr().err, name


def test_cli_flicker_device_error(tmp_path, capsys):
    """--flicker-hz without --device and without a card: exit 1 with the
    DeviceError's message, and the probed reader is released."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    src = write_clip(moving_square_clip(n=3, height=16, width=20),
                     str(tmp_path / "in.avi"))
    rc = dips_tpu_torch.cli.main(["--input", src, "--output",
                                  str(tmp_path / "o.avi"), "--flicker-hz",
                                  "3"])
    assert rc == 1 and "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("mode", ["input", "inputs"])
def test_cli_flicker_png_without_matplotlib(tmp_path, capsys, monkeypatch,
                                            mode):
    """Without matplotlib, --flicker-png fails as in the JAX CLI: exit 1
    with the install hint, after the peak lines."""
    import sys
    src = write_clip(_blink_clip(24, 16, 20, 24.0, 6.0, 2.0),
                     str(tmp_path / "in.avi"), fps=24.0)
    argv = (["--input", src, "--output", str(tmp_path / "o.avi")]
            if mode == "input" else
            ["--inputs", src, src, "--output-dir", str(tmp_path / "o")])
    argv += ["--batch", "8", "--flicker-hz", "6", "--flicker-png",
             str(tmp_path / "f.png")]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for name, main, extra in _clis():
        assert main(argv + extra) == 1, name
        cap = capsys.readouterr()
        assert "chart rendering needs matplotlib" in cap.err, name
        assert "flicker @ 6 Hz" in cap.out, name
    assert not any(p.suffix == ".png" for p in tmp_path.iterdir())
