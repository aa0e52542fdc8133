"""The port's fleet flicker analysis against its single-stream analyzers
and the JAX package, on the CPU.

* ``FleetFlickerAnalyzer`` against per-stream ``FlickerAnalyzer`` of the
  port, bit for bit: uniform rounds, ragged and gated rounds, per-stream
  configurations, resets; and against the JAX fleet within tolerance.
* ``run_dips_on_files(flicker=)`` against the JAX function on the same
  clips, with both input layouts, a RED chroma through the ``hwc`` layout
  (the decoder's BGR frames must reach the analyzer as RGB) and
  ``downscale``; zero maps when no frame decodes.
* The ``--inputs`` CLI's ``--flicker-hz`` / ``--flicker-png`` against the
  JAX CLI's.

The port runs with ``device="cpu"``.  Tolerances: the port's fleet
against its single analyzers bit for bit; amplitude maps against JAX
rtol 1e-5 + atol 1e-4.
"""

import os
import re

import jax  # JAX stays on the CPU: tests/conftest.py
import numpy as np
import pytest
import torch

import dips_tpu.app
import dips_tpu.cli
import dips_tpu.properties as jprops
import dips_tpu_torch.app
import dips_tpu_torch.cli
from dips_tpu.ops import analysis as jan
from dips_tpu_torch import DeviceError
from dips_tpu_torch.convert import props_from_jax
from dips_tpu_torch.ops import analysis as tan
from dips_tpu_torch.properties import ChromaFilter
from tests.test_fleet_flicker import _flicker_clip, _write_clip

torch.set_num_threads(1)

CPU = dict(device="cpu")
AMP_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(autouse=True)
def _jax_fleet_waits(monkeypatch):
    """The JAX fleet analyzer refills one host staging buffer per round
    length, possibly while the previous round's upload still reads it
    (ROADMAP.md §3); as the reference here it waits for each round's
    result before the next round is staged."""
    real = jan.FleetFlickerAnalyzer.update

    def update(self, frames_per_stream):
        real(self, frames_per_stream)
        if self._state is not None:
            jax.block_until_ready(self._state)

    monkeypatch.setattr(jan.FleetFlickerAnalyzer, "update", update)


def _fleets(n, chroma=None):
    """The port's fleet analyzer and the JAX one."""
    jc = None if chroma is None else jprops.ChromaFilter[chroma]
    tc = None if chroma is None else ChromaFilter[chroma]
    return (tan.FleetFlickerAnalyzer(n, chroma=tc, **CPU),
            jan.FleetFlickerAnalyzer(n, chroma=jc))


@pytest.mark.parametrize("chroma", [None, "RED", "BLUE"])
def test_fleet_bit_matches_single_stream(chroma):
    """Two streams, different content, same config: fleet maps ==
    per-stream analyzer maps bit for bit, and the JAX fleet's within
    tolerance."""
    fps, freq = 30.0, 5.0
    clips = [_flicker_clip(64, seed=s, spot=(4 + 3 * s, 6)) for s in (0, 1)]
    fleet, jfleet = _fleets(2, chroma)
    fleet.configure_all(freq, fps)
    jfleet.configure_all(freq, fps)
    tc = None if chroma is None else ChromaFilter[chroma]
    singles = [tan.FlickerAnalyzer(freq, fps, batch=8, chroma=tc, **CPU)
               for _ in range(2)]
    for k in range(0, 64, 8):
        fleet.update([list(c[k:k + 8]) for c in clips])
        jfleet.update([list(c[k:k + 8]) for c in clips])
        for si, c in enumerate(clips):
            singles[si].update(c[k:k + 8])
    for si in range(2):
        np.testing.assert_array_equal(fleet.amplitude(si),
                                      singles[si].amplitude())
        np.testing.assert_allclose(fleet.amplitude(si),
                                   jfleet.amplitude(si), **AMP_TOL)
    # the oscillating spot dominates each map
    for si in range(2):
        amp = fleet.amplitude(si)
        py, px = np.unravel_index(int(np.argmax(amp)), amp.shape)
        assert (4 + 3 * si <= py < 7 + 3 * si) and (6 <= px < 9)


@pytest.mark.parametrize("rounds", [
    ((4, 2), (0, 4), (3, 0), (4, 4), (1, 3)),
    ((1, 0, 2), (2, 2, 0), (0, 0, 0), (2, 1, 2), (2, 2, 2)),
])
def test_fleet_staggered_and_gated(rounds):
    """Ragged rounds (streams advance on independent cursors, one stalls,
    a round length repeats with other content in the reused staging
    buffer) still bit-match independent analyzers."""
    fps, freq = 24.0, 4.0
    s = len(rounds[0])
    clips = [_flicker_clip(40, seed=2 + si, freq=freq, fps=fps)
             for si in range(s)]
    fleet, jfleet = _fleets(s)
    taus = [None, 20.0, 9.0][:s]
    for f in (fleet, jfleet):
        for si in range(s):
            f.configure(si, freq, fps, tau_frames=taus[si])
    singles = [tan.FlickerAnalyzer(freq, fps, tau_frames=taus[si], batch=4,
                                   **CPU) for si in range(s)]
    cursors = [0] * s
    for counts in rounds:
        feeds = []
        for si, n in enumerate(counts):
            feeds.append(list(clips[si][cursors[si]:cursors[si] + n]))
            if n:
                singles[si].update(clips[si][cursors[si]:cursors[si] + n])
            cursors[si] += n
        fleet.update(feeds)
        jfleet.update(feeds)
    for si in range(s):
        singles[si].flush()
        np.testing.assert_array_equal(fleet.amplitude(si),
                                      singles[si].amplitude())
        np.testing.assert_allclose(fleet.amplitude(si),
                                   jfleet.amplitude(si), **AMP_TOL)
        assert fleet.frames_seen[si] == singles[si].frames_seen \
            == jfleet.frames_seen[si]


def test_fleet_per_stream_configs_and_reset():
    """Different (freq, fps) per stream coexist in one fleet; reset_stream
    restarts one window without touching siblings."""
    clips = [_flicker_clip(32, freq=5.0, fps=30.0, seed=4),
             _flicker_clip(32, freq=8.0, fps=60.0, seed=5)]
    fleet, jfleet = _fleets(2)
    for f in (fleet, jfleet):
        f.configure(0, 5.0, 30.0)
        f.configure(1, 8.0, 60.0)
        f.update([list(clips[0][:16]), list(clips[1][:16])])
    before = fleet.amplitude(1).copy()
    fleet.reset_stream(0)
    jfleet.reset_stream(0)
    assert fleet.frames_seen[0] == 0 and fleet.frames_seen[1] == 16
    np.testing.assert_array_equal(fleet.amplitude(1), before)
    # stream 0 restarts cleanly and matches a fresh single analyzer
    for f in (fleet, jfleet):
        f.update([list(clips[0][16:]), []])
    ref = tan.FlickerAnalyzer(5.0, 30.0, batch=16, **CPU)
    ref.update(clips[0][16:])
    np.testing.assert_array_equal(fleet.amplitude(0), ref.amplitude())
    for si in range(2):
        np.testing.assert_allclose(fleet.amplitude(si),
                                   jfleet.amplitude(si), **AMP_TOL)


def test_fleet_config_disable_and_amplitudes():
    """config(), disable() and amplitudes() as in the JAX fleet: unarmed
    and fresh streams read zero planes; unconfigured streams' frames are
    ignored."""
    clip = _flicker_clip(12, seed=6)
    fleet, jfleet = _fleets(3)
    for f in (fleet, jfleet):
        f.configure(0, 5.0, 30.0, tau_frames=10.0)
        f.configure(2, 5.0, 30.0)
        assert f.config(0) == (5.0, 30.0, 10.0)
        assert f.config(1) is None
        f.update([list(clip), list(clip), []])
    assert fleet.frames_seen == jfleet.frames_seen == [12, 0, 0]
    amps = fleet.amplitudes()
    assert amps.shape == (3, 16, 24) and amps.dtype == np.float32
    assert not amps[1:].any() and amps[0].any()
    np.testing.assert_allclose(amps, jfleet.amplitudes(), **AMP_TOL)
    fleet.disable(0)
    assert fleet.config(0) is None and fleet.frames_seen[0] == 0
    with pytest.raises(RuntimeError, match="no flicker"):
        fleet.power(0)


def test_fleet_validation():
    fleet = tan.FleetFlickerAnalyzer(2, **CPU)
    with pytest.raises(RuntimeError, match="no frames"):
        fleet.amplitudes()
    with pytest.raises(ValueError, match="freq_hz"):
        fleet.configure(0, 20.0, 30.0)  # above Nyquist
    with pytest.raises(ValueError, match="fps"):
        fleet.configure(0, 5.0, 0.0)
    with pytest.raises(ValueError, match="tau_frames"):
        fleet.configure(0, 5.0, 30.0, tau_frames=1.5)
    fleet.configure(0, 5.0, 30.0)
    with pytest.raises(RuntimeError, match="no flicker"):
        fleet.power(1)
    with pytest.raises(RuntimeError, match="no frames"):
        fleet.power(0)
    with pytest.raises(ValueError, match="expected 2 streams"):
        fleet.update([[]])
    with pytest.raises(ValueError, match="uint8 RGB"):
        fleet.update([[np.zeros((4, 5, 3), np.float32)], []])
    fleet.update([[np.zeros((4, 5, 3), np.uint8)], []])
    with pytest.raises(ValueError, match="fleet geometry"):
        fleet.update([[np.zeros((4, 6, 3), np.uint8)], []])
    with pytest.raises(ValueError, match="n_streams"):
        tan.FleetFlickerAnalyzer(0, **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(DeviceError):
            tan.FleetFlickerAnalyzer(2)


# ---------------------------------------------------------------------------
# run_dips_on_files(flicker=) and the --inputs CLI
# ---------------------------------------------------------------------------

def _clips(tmp_path, n=24, fps=20.0, h=16, w=24, colour=False):
    """Two cv2-written clips, each with a square oscillating at 4 Hz; with
    ``colour`` the square swings in the red channel only."""
    paths = []
    for k in (0, 1):
        frames = _flicker_clip(n, h=h, w=w, freq=4.0, fps=fps,
                               spot=(4 + 4 * k, 6), seed=k)
        if colour:
            still = _flicker_clip(1, h=h, w=w, amp=0, seed=k)[0]
            frames[..., 1:] = still[..., 1:]
        p = tmp_path / f"s{k}.avi"
        _write_clip(p, frames, fps)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("layout,chroma,downscale", [
    ("hwc", None, 1), ("planar", None, 1), ("hwc", "RED", 1),
    ("planar", "RED", 1), ("hwc", "BLUE", 1), ("hwc", None, 2)])
def test_run_dips_on_files_flicker_matches_jax(tmp_path, layout, chroma,
                                               downscale):
    paths = _clips(tmp_path, h=16 * downscale, w=24 * downscale,
                   colour=chroma is not None)
    props = jprops.DiPsProperties(
        output=jprops.OutputMode.STATS_ONLY,
        **({} if chroma is None
           else dict(chroma=jprops.ChromaFilter[chroma])))
    kw = dict(batch=4, flicker=dict(freq_hz=4.0), input_layout=layout,
              downscale=downscale)
    counts, maps = dips_tpu_torch.app.run_dips_on_files(
        paths, str(tmp_path / "t"), properties=props_from_jax(props),
        device="cpu", **kw)
    jcounts, jmaps = dips_tpu.app.run_dips_on_files(
        paths, str(tmp_path / "j"), properties=props, **kw)
    assert list(counts) == list(jcounts) == [24, 24]
    assert maps.shape == (2, 16 * downscale, 24 * downscale)
    assert maps.dtype == np.float32
    np.testing.assert_allclose(maps, jmaps, **AMP_TOL)
    if chroma == "BLUE":  # only red swings (MJPG's chroma bleeds a little)
        return
    for k in range(2):
        py, px = np.unravel_index(int(np.argmax(maps[k])), maps[k].shape)
        assert 4 + 4 * k <= py < 7 + 4 * k, (k, py, px)  # input rows


def test_run_dips_on_files_flicker_with_maps_and_stats(tmp_path):
    """Flicker maps come last, after the stats, with diff videos written;
    unknown flicker options are refused in both packages."""
    paths = _clips(tmp_path, n=10)
    counts, stats, maps = dips_tpu_torch.app.run_dips_on_files(
        paths, str(tmp_path / "o"), batch=4, device="cpu",
        collect_stats=True, flicker=dict(freq_hz=4.0, tau_frames=6.0))
    assert list(counts) == [10, 10] and len(stats) == 2
    assert maps.shape == (2, 16, 24)
    assert sorted(os.listdir(tmp_path / "o")) == ["s0.dips.avi",
                                                  "s1.dips.avi"]
    for run, kw in ((dips_tpu_torch.app.run_dips_on_files, CPU),
                    (dips_tpu.app.run_dips_on_files, {})):
        with pytest.raises(ValueError, match="unknown flicker options"):
            run(paths, str(tmp_path / "x"), batch=4,
                flicker=dict(freq_hz=4.0, bogus=1), **kw)


def test_run_dips_on_files_flicker_zero_frames(tmp_path, monkeypatch):
    """A flicker-armed fleet run whose inputs decode zero frames returns
    zero amplitude maps at the input geometry, as the JAX run does."""
    from dips_tpu.io import gstreamer
    from dips_tpu_torch.io import video

    class _Empty:
        height, width, fps = 16, 24, 20.0

        def __init__(self, path, backend="auto"):
            self.path = path

        def read(self):
            return None

        def iter_bgr(self):
            return iter(())

        def close(self):
            pass

    monkeypatch.setattr(gstreamer, "open_video", _Empty)
    monkeypatch.setattr(video, "VideoReader", _Empty)
    results = []
    for run, p, kw in ((dips_tpu_torch.app.run_dips_on_files,
                        dips_tpu_torch.properties, CPU),
                       (dips_tpu.app.run_dips_on_files, jprops, {})):
        results.append(run(
            ["a.avi", "b.avi"], str(tmp_path / "out"),
            properties=p.DiPsProperties(output=p.OutputMode.STATS_ONLY),
            batch=4, flicker=dict(freq_hz=4.0), **kw))
    for counts, maps in results:
        assert list(counts) == [0, 0]
        assert maps.shape == (2, 16, 24) and maps.dtype == np.float32
        assert not maps.any()


def test_cli_inputs_flicker(tmp_path, capsys):
    paths = _clips(tmp_path, n=16)
    lines = {}
    for name, main, extra in (("j", dips_tpu.cli.main, []),
                              ("t", dips_tpu_torch.cli.main,
                               ["--device", "cpu"])):
        png = tmp_path / f"{name}.png"
        rc = main(["--inputs", *paths, "--output-mode", "stats_only",
                   "--flicker-hz", "4.0", "--flicker-png", str(png),
                   "--batch", "4"] + extra)
        assert rc == 0
        out = capsys.readouterr().out
        assert out.count("flicker @ 4 Hz") == 2
        assert (tmp_path / f"{name}.0.png").exists()
        assert (tmp_path / f"{name}.1.png").exists()
        lines[name] = [re.sub(r"peak amplitude [\d.]+", "", ln)
                       for ln in out.splitlines()
                       if ln.startswith("flicker @")]
    # same streams, same peak locations and means
    assert lines["t"] == lines["j"]
