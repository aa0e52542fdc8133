"""The post-analysis on the engine's device maps (``DiPsEngine(
denoise_radius=)``, the run path's ``--denoise``) and the plain reference
it is held to (``dips_tpu_torch/plainref.py``), on the CPU at a small
size.

* ``stream_dips`` and ``perform_dips`` with ``denoise_radius`` against
  the plain reference applied to the oracle's maps of the same frames:
  within 1 LSB, at most 1e-3 of the bytes off.
* The engine's denoise against the old round trip (``denoise_frames`` on
  the collected, undenoised maps) bit for bit: both take the same
  per-frame transform, one frame's planes as a contiguous float32 batch.
* The comparison fails what it must: a radius off by one, the mask on
  the wrong half of the spectrum, and the bf16 control.
* ``temporal_dft`` against the reference's DFT; ``plainref.py`` imports
  nothing of the port; the denoise step's counters and span.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from dips_tpu_torch import DiPsEngine, plainref
from dips_tpu_torch.app import DiPsJob, perform_dips, stream_dips
from dips_tpu_torch.io.synthetic import moving_square_clip, write_clip
from dips_tpu_torch.ops import analysis
from dips_tpu_torch.ops.oracle import DiPsOracle
from dips_tpu_torch.properties import DiPsProperties, OutputMode
from dips_tpu_torch.utils.profiling import POST_STAGE, StageTimers

ROOT = Path(__file__).resolve().parents[1]
H, W, B, R = 96, 128, 4, 8
#: the tolerance of the port against the reference: float32 transforms
#: in another order round a few magnitudes to the other side of .5
LSB, FLIPPED = 1, 1e-3


def _frames(n=12, seed=5):
    """Seeded frames with texture and motion: a noisy background and a
    moving square (the denoise has low and high frequencies to work on)."""
    rng = np.random.default_rng(seed)
    f = moving_square_clip(n, H, W, seed=seed, square=20).astype(np.int16)
    f += rng.integers(-6, 7, f.shape, dtype=np.int16)
    return np.clip(f, 0, 255).astype(np.uint8)


def _oracle_maps(frames, props=None):
    ora = DiPsOracle(props or DiPsProperties())
    return np.stack([ora.process(f)[0] for f in frames])


def _assert_close(got, exp, lsb=LSB, flipped=FLIPPED):
    assert got.shape == exp.shape and got.dtype == exp.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - exp.astype(np.int16))
    assert d.max() <= lsb, d.max()
    assert (d > 0).mean() <= flipped, (d > 0).mean()


def _misses(got, exp):
    """True when ``got`` fails the comparison with ``exp``."""
    d = np.abs(got.astype(np.int16) - exp.astype(np.int16))
    return d.max() > LSB or (d > 0).mean() > FLIPPED


class FrameReader:
    """Frames handed over as a decoder's RGB output (the benchmark's pool
    reader): ``stream_dips`` decodes from it on its worker."""
    native_rgb = True

    def __init__(self, frames):
        self.frames = frames
        self.height, self.width = frames.shape[1:3]

    def iter_rgb_timed(self):
        for i, f in enumerate(self.frames):
            yield f, i / 30.0

    def close(self):
        pass


# -- the run path against the plain reference --------------------------------

def test_stream_dips_denoise_against_plainref():
    frames = _frames()
    job = DiPsJob(video_path="frames", batch=B, device="cpu",
                  denoise_radius=R, reader=FrameReader(frames))
    got = [(i, out, st) for i, _, out, st in stream_dips(job)]
    assert [i for i, _, _ in got] == list(range(len(frames)))
    maps = np.stack([o for _, o, _ in got])
    exp = _oracle_maps(frames)
    _assert_close(maps, plainref.denoise(exp, R))
    assert _misses(maps, exp)  # the maps were denoised
    assert job.engine.denoise_radius == R


def test_perform_dips_denoise_against_plainref(tmp_path):
    """perform_dips on a written clip: the frame callback's inputs are the
    decoded frames, its maps the denoised ones."""
    src = write_clip(_frames(9), str(tmp_path / "in.avi"))
    seen = []

    def cb(idx, inp, m, st):
        seen.append((np.array(inp), np.array(m)))

    job = DiPsJob(video_path=src, output_path=str(tmp_path / "out.avi"),
                  batch=B, device="cpu", denoise_radius=R, frame_callback=cb)
    stats = perform_dips(job)
    assert stats.shape == (9, 4) and len(seen) == 9
    inputs = np.stack([i for i, _ in seen])
    _assert_close(np.stack([m for _, m in seen]),
                  plainref.denoise(_oracle_maps(inputs), R))


# -- the engine's denoise against the old round trip -------------------------

@pytest.mark.parametrize("output,kw", [
    ("COLORIZE", {}), ("GRAYSCALE", {}), ("THRESHOLD", {}),
    ("THRESHOLD", {"packed_wire": True}), ("COLORIZE", {"ring_carry": False}),
    ("COLORIZE", {"downscale": 2})])
def test_engine_denoise_equals_the_round_trip(output, kw):
    """Bit for bit: the engine's planar maps and the collected interleaved
    ones go through the same per-frame transform (``denoise_planes``).
    The round trip's masks may come down packed; the denoised ones never
    are."""
    props = DiPsProperties(output=OutputMode[output])
    plain = DiPsEngine(props, H, W, batch=B, device="cpu", **kw)
    den = DiPsEngine(props, H, W, batch=B, device="cpu", denoise_radius=R,
                     **{k: v for k, v in kw.items() if k != "packed_wire"})
    frames = _frames(10)
    for i in range(0, 10, B):  # the last batch is short
        m, s = plain.process_batch(list(frames[i:i + B]))
        d, s2 = den.process_batch(list(frames[i:i + B]))
        np.testing.assert_array_equal(s2, s)
        np.testing.assert_array_equal(
            d, analysis.denoise_frames(torch.from_numpy(m), R).numpy())
    np.testing.assert_array_equal(den.heatmap(), plain.heatmap())


def test_denoised_maps_come_down_unpacked():
    """The engine refuses to bit-pack denoised maps; the run path asked
    for both denoises and downloads the maps unpacked."""
    props = DiPsProperties(output=OutputMode.THRESHOLD)
    with pytest.raises(ValueError, match="packed_wire"):
        DiPsEngine(props, H, W, batch=B, device="cpu", denoise_radius=R,
                   packed_wire=True)
    frames = _frames(8)
    job = DiPsJob(properties=props, video_path="frames", batch=B,
                  device="cpu", denoise_radius=R, packed_wire=True,
                  reader=FrameReader(frames))
    maps = np.stack([out for _, _, out, _ in stream_dips(job)])
    assert not job.engine.packed_wire
    plain = DiPsEngine(props, H, W, batch=B, device="cpu")
    exp = np.concatenate([plain.process_batch(list(frames[i:i + B]))[0]
                          for i in range(0, 8, B)])
    np.testing.assert_array_equal(
        maps, analysis.denoise_frames(torch.from_numpy(exp), R).numpy())


def test_engine_refuses_a_bad_radius_and_no_maps():
    with pytest.raises(ValueError, match=">= 1"):
        DiPsEngine(DiPsProperties(), H, W, device="cpu", denoise_radius=0)
    with pytest.raises(ValueError, match="denoise"):
        DiPsEngine(DiPsProperties(output=OutputMode.STATS_ONLY), H, W,
                   device="cpu", denoise_radius=R)


# -- the comparison fails what it must ---------------------------------------

def _engine_maps(frames, radius=R):
    eng = DiPsEngine(DiPsProperties(), H, W, batch=B, device="cpu",
                     denoise_radius=radius)
    return np.concatenate([eng.process_batch(list(frames[i:i + B]))[0]
                           for i in range(0, len(frames), B)])


@pytest.mark.parametrize("off", [-1, 1])
def test_a_radius_off_by_one_fails(off):
    frames = _frames(8)
    exp = plainref.denoise(_oracle_maps(frames), R)
    _assert_close(_engine_maps(frames), exp)
    assert _misses(_engine_maps(frames, R + off), exp)


def test_the_mask_on_the_wrong_half_fails(monkeypatch):
    """The square kept around the unshifted spectrum's centre (the
    highest frequencies) in place of its corners."""
    real = analysis.lowpass_mask

    def unshifted(h, w, radius, device):
        return torch.fft.fftshift(real(h, w, radius, device))

    frames = _frames(8)
    exp = plainref.denoise(_oracle_maps(frames), R)
    monkeypatch.setattr(analysis, "lowpass_mask", unshifted)
    assert _misses(_engine_maps(frames), exp)


def test_the_bf16_control_fails():
    maps = _oracle_maps(_frames(8))
    full = plainref.denoise(maps, R)
    ctl = plainref.denoise(maps, R, "bf16")
    assert _misses(ctl, full)
    d = np.abs(ctl.astype(np.int16) - full.astype(np.int16))
    assert (d > 0).mean() > 10 * FLIPPED
    with pytest.raises(ValueError):
        plainref.denoise(maps, R, "fp8")


def test_plainref_follows_the_recipe_by_hand():
    """A constant plane keeps its value (the DC bin is kept); a plane of
    the highest frequency alone goes to zero."""
    const = np.full((1, 16, 24, 1), 77, np.uint8)
    np.testing.assert_array_equal(plainref.denoise(const, 2), const)
    yy, xx = np.mgrid[:16, :24]
    check = np.where((yy + xx) % 2, 200, 0).astype(np.uint8)[None, ..., None]
    out = plainref.denoise(check, 2)
    assert np.all(out == 100)  # only the mean, 100, passes


# -- the DFT ------------------------------------------------------------------

def test_temporal_dft_against_plainref():
    series = np.random.default_rng(3).random(257).astype(np.float32)
    mag, phase = analysis.temporal_dft(series, device="cpu")
    emag, ephase = plainref.rdft(series)
    np.testing.assert_allclose(mag.numpy(), emag, rtol=1e-5,
                               atol=1e-5 * emag.max())
    live = emag > 1e-3 * emag.max()
    np.testing.assert_allclose(phase.numpy()[live], ephase[live], atol=1e-4)
    cmag, _ = plainref.rdft(series, "bf16")
    assert np.abs(cmag - emag).max() > 1e-4 * emag.max()


# -- the reference stands alone -----------------------------------------------

def test_plainref_imports_nothing_of_the_port():
    tree = ast.parse((ROOT / "dips_tpu_torch" / "plainref.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "a relative import reaches the port"
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "typing", "numpy", "torch"}, names


# -- counters and span --------------------------------------------------------

def test_the_counters_count_while_the_timers_are_on():
    eng = DiPsEngine(DiPsProperties(), H, W, batch=B, device="cpu",
                     denoise_radius=R)
    frames = _frames(10)
    eng.process_batch(list(frames[:B]))  # timers off: nothing counted
    assert eng.denoise_counts.as_dict() == {
        "batches": 0, "frames": 0, "planes": 0, "device_ms": 0.0}
    eng.timers = StageTimers()
    eng.process_batch(list(frames[B:2 * B]))
    eng.process_batch(list(frames[2 * B:2 * B + 2]))
    c = eng.denoise_counts
    assert (c.batches, c.frames, c.planes) == (2, B + 2, 3 * (B + 2))
    assert c.device_ms == 0.0  # no card: no device time
    assert eng.timers.counts[POST_STAGE] == 2
    assert "denoise: 2 batches, 6 frames, 18 planes" in str(c)


def test_the_denoise_stage_is_a_span_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile
    eng = DiPsEngine(DiPsProperties(), H, W, batch=B, device="cpu",
                     denoise_radius=R)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.process_batch(list(_frames(B)))
    names = [e.name for e in prof.events()]
    assert names.count("dips.engine.denoise") == 1
    plain = DiPsEngine(DiPsProperties(), H, W, batch=B, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plain.process_batch(list(_frames(B)))
    assert "dips.engine.denoise" not in [e.name for e in prof.events()]


def test_cli_profile_prints_the_counters(tmp_path, capsys):
    from dips_tpu_torch import cli
    src = write_clip(_frames(8), str(tmp_path / "in.avi"))
    rc = cli.main(["--input", src, "--output", str(tmp_path / "o.avi"),
                   "--batch", str(B), "--denoise", str(R), "--profile",
                   "--device", "cpu"])
    assert rc == 0
    assert "denoise: 2 batches, 8 frames, 24 planes" in capsys.readouterr().out


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_engine_denoise_on_the_card(cuda):
    """On the card: the engine's denoise equals the old round trip on the
    card bit for bit, is within the reference's tolerance of the plain
    reference, and its counters read a device time."""
    frames = _frames(8)
    plain = DiPsEngine(DiPsProperties(), H, W, batch=B, device="cuda")
    den = DiPsEngine(DiPsProperties(), H, W, batch=B, device="cuda",
                     denoise_radius=R)
    den.timers = StageTimers()
    for i in range(0, 8, B):
        m, _ = plain.process_batch(list(frames[i:i + B]))
        d, _ = den.process_batch(list(frames[i:i + B]))
        np.testing.assert_array_equal(
            d, analysis.denoise_frames(torch.from_numpy(m).to(cuda),
                                       R).cpu().numpy())
        _assert_close(d, plainref.denoise(m, R))
    c = den.denoise_counts
    assert (c.batches, c.frames, c.planes) == (2, 8, 24) and c.device_ms > 0
