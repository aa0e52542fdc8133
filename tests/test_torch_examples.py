"""The port's examples 1-5 against the JAX package's, on the CPU.

Each case runs the JAX example (``python examples/<name>.py --cpu``, with
8 virtual host devices as its docstring says) and the port's
(``python -m dips_tpu_torch.examples.<name> --cpu``) side by side, each in
a temporary working directory of its own and under a 180 s timeout.  Both
must exit 0 and ``dips_tpu_torch.examples._compare`` must pass on their
stdout (integers and words equal, floats within one unit of the last
printed digit, each example's timing and environment fields masked with
their reasons).  The artifacts compare too: ``demo_heatmap.png`` within 1
LSB; ``demo_out.avi`` / ``scene_out.avi`` decoded to the same frame count
and shape with a PSNR of at least 40 dB (both pass through lossy MJPG, and
the maps agree within 1 LSB).

Also: every port example without ``--cpu`` exits 1 here with the
``DeviceError`` text (no fallback); every one imports as a script path;
``_compare`` itself catches a changed word, integer or float.
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from dips_tpu_torch.examples import _compare

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 180
ALL = ["single_video", "multi_stream", "fleet_telemetry", "scene_analysis",
       "pod_fleet_grid", "serving", "motion_alerts", "camera_fleet",
       "multi_host"]


def env():
    e = dict(os.environ)
    e["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    e["PYTHONPATH"] = str(ROOT) + os.pathsep + e.get("PYTHONPATH", "")
    return e


def start(argv, cwd):
    return subprocess.Popen(argv, cwd=cwd, env=env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish(proc):
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    return proc.returncode, out, err


def run_pair(name, tmp_path):
    """Both examples of ``name`` with --cpu, concurrently: (port dir, JAX
    dir) after their stdout passed ``_compare``."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    jp = start([sys.executable, str(ROOT / "examples" / f"{name}.py"),
                "--cpu"], jdir)
    tp = start([sys.executable, "-m", f"dips_tpu_torch.examples.{name}",
                "--cpu"], tdir)
    trc, tout, terr = finish(tp)
    jrc, jout, jerr = finish(jp)
    assert jrc == 0, jerr[-3000:]
    assert trc == 0, terr[-3000:]
    _compare.check(name, tout, jout)
    return tdir, jdir


def decode(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return np.stack(frames)


def assert_same_video(got, exp):
    g, e = decode(got), decode(exp)
    assert g.shape == e.shape
    mse = float(((g.astype(np.float64) - e) ** 2).mean())
    psnr = math.inf if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)
    assert psnr >= 40.0, psnr


def test_single_video(tmp_path):
    tdir, jdir = run_pair("single_video", tmp_path)
    g = cv2.imread(str(tdir / "demo_heatmap.png"), cv2.IMREAD_UNCHANGED)
    e = cv2.imread(str(jdir / "demo_heatmap.png"), cv2.IMREAD_UNCHANGED)
    assert g.shape == e.shape == (240, 320)
    assert np.abs(g.astype(np.int16) - e).max() <= 1
    assert_same_video(tdir / "demo_out.avi", jdir / "demo_out.avi")


def test_multi_stream(tmp_path):
    run_pair("multi_stream", tmp_path)


def test_fleet_telemetry(tmp_path):
    run_pair("fleet_telemetry", tmp_path)


def test_scene_analysis(tmp_path):
    tdir, jdir = run_pair("scene_analysis", tmp_path)
    assert (tdir / "scene_in.avi").read_bytes() == \
        (jdir / "scene_in.avi").read_bytes()
    assert_same_video(tdir / "scene_out.avi", jdir / "scene_out.avi")


def test_pod_fleet_grid(tmp_path):
    run_pair("pod_fleet_grid", tmp_path)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a card is present: the example would run on it")
@pytest.mark.parametrize("name", ALL)
def test_example_without_cpu_needs_a_card(name, tmp_path):
    """No fallback: without ``--cpu`` and without a card the example exits
    1 with the DeviceError text and prints nothing on stdout."""
    rc, out, err = finish(start(
        [sys.executable, "-m", f"dips_tpu_torch.examples.{name}"], tmp_path))
    assert rc == 1
    assert out == ""
    assert "error: device 'cuda' requested but torch sees no CUDA device" \
        in err
    assert list(tmp_path.iterdir()) == []  # nothing was written


@pytest.mark.parametrize("name", ALL)
def test_example_runs_as_a_script_path(name, tmp_path):
    rc, out, err = finish(start(
        [sys.executable, str(ROOT / "dips_tpu_torch" / "examples"
                             / f"{name}.py"), "--help"], tmp_path))
    assert rc == 0, err
    assert "--cpu" in out


# ---------------------------------------------------------------------------
# the comparison itself
# ---------------------------------------------------------------------------

SERVING = ("serving on port 41000 (2 sessions)\n"
           "batched: (8, 96, 128, 3) maps, mean|diff| per frame "
           "[0.     0.0003 0.0014]\n"
           "packed transport: (8, 96, 128, 1) masks (1864 changed px)\n"
           "coalesced sessions mean|diff| streams: [[0.0, "
           "0.03449999913573265]]\n"
           "metrics: 12 frames in 5 dispatches (mean fill 2.4), request p50 "
           "110.817 ms\n")


@pytest.mark.parametrize("edit,agree", [
    (("41000", "52111"), True),                      # port masked
    (("in 5 dispatches", "in 7 dispatches"), True),  # timing masked
    (("110.817 ms", "9.1 ms"), True),
    (("0.0014]", "0.0015]"), True),                  # one unit
    (("0.0014]", "0.0016]"), False),                 # two units
    (("[0.     ", "[0.0001 "), True),                # "0." takes 1e-4
    (("[0.     ", "[0.0002 "), False),
    (("1864 changed", "1865 changed"), False),       # an integer
    (("12 frames", "13 frames"), False),
    (("0.03449999913573265", "0.0345000004"), True),  # within 1e-6
    (("0.03449999913573265", "0.0344"), False),
    (("mean|diff| streams", "mean diff streams"), False),  # a word
    (("(2 sessions)\n", "(2 sessions)\nextra line\n"), False),
])
def test_compare_serving(edit, agree):
    got = SERVING.replace(*edit)
    assert got != SERVING
    assert (_compare.compare("serving", got, SERVING) == []) is agree
    if not agree:
        with pytest.raises(AssertionError, match="serving"):
            _compare.check("serving", got, SERVING)


def test_compare_processes_interleaved_and_unordered():
    """The workers' records in either order, cut apart where they share a
    line, among JAX's gloo log fragments."""
    rnd = ("[host {}] round 0: out (4, 4, 64, 96, 3), global mean|diff| "
           "(cross-host psum) = {}")
    exp = ("[host 0] joined: 8 global devices (4 local)[Gloo] Rank 5 is "
           "connected to [Gloo] Rank 73 peer ranks.  is connected to\n"
           "[host 1] joined: 8 global devices (4 local)\n\n"
           + rnd.format(0, "0.04409") + rnd.format(1, "0.04409")
           + "\n\nOK\n")
    got = ("[host 1] joined: 8 global devices (4 local)\n"
           "[host 0] joined: 8 global devices (4 local)\n"
           + rnd.format(1, "0.04409") + "\n" + rnd.format(0, "0.04410")
           + "\nOK\n")
    assert _compare.compare("multi_host", got, exp) == []
    for edit in (("4 local", "3 local"), ("OK\n", ""), ("0.04410", "0.04411"),
                 ("[host 1] round", "[host 0] round")):
        assert _compare.compare("multi_host", got.replace(*edit), exp) != []


@pytest.mark.parametrize("got,agree", [
    ("cam0@(np.int64(17), np.int64(36)) amp 31, cam2@(np.int64(1), "
     "np.int64(12)) amp 0", True),
    ("cam0@(np.int64(17), np.int64(36)) amp 32, cam2@(np.int64(1), "
     "np.int64(12)) amp 0", False),
    ("cam0@(np.int64(17), np.int64(35)) amp 30, cam2@(np.int64(1), "
     "np.int64(12)) amp 0", False),
])
def test_compare_flicker_peaks(got, agree):
    """An amplitude printed with :.0f is within 1; a peak beside a nonzero
    amplitude is exact; a still camera's (amp 0) is masked."""
    exp = ("cam0@(np.int64(17), np.int64(36)) amp 30, cam2@(np.int64(10), "
           "np.int64(58)) amp 0")
    assert (_compare.compare("fleet_telemetry", got, exp) == []) is agree


def test_every_ignored_pattern_has_a_reason():
    for name in ALL:
        spec = _compare.SPECS[name]
        rules = spec.ignore + spec.tol + ((spec.records,) if spec.records
                                          else ())
        for rule in rules:
            assert len(rule.reason) > 10, (name, rule)
