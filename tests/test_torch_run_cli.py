"""The port's single-stream CLI, raw-dump batch mode, report and trace
against the JAX package's.

* The artifact tail of ``python -m dips_tpu_torch --input ...``
  (``--stats-json``, ``--events-json``, ``--record-events`` with its
  ``segments.json``, ``--heatmap-png``, ``--auto-refresh``,
  ``--retime-vfr``) beside ``dips_tpu.cli`` on the same lossless clip,
  and ``dips_tpu_torch.report`` rendering them as ``dips_tpu.report``
  does.
* ``custom_dips_on_files`` on ``Dat_N.d`` dumps of an odd width, red and
  blue chroma (the dumps are RGB: a swapped channel would filter the
  other plane), and the CLI's ``--dat-dir``.
* ``utils.profiling.trace`` writing a Chrome trace on the CPU.
* The CLI's exit codes and first stderr lines for the flag combinations
  the JAX CLI refuses, argv by argv.
* Every new entry point defaulting to the card (``DeviceError``, exit 1).

The JAX side runs with ``--backend pallas`` / ``backend="pallas"``
(interpret mode on the CPU), the port with ``--device cpu``.  Stats atol
1e-6 with changed counts and maxima exact; COLORIZE maps within 1 LSB,
ABSDIFF exact.
"""

import contextlib
import io
import json
import os

import cv2
import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import dips_tpu.app as japp
import dips_tpu.cli as jcli
import dips_tpu.properties as jp
import dips_tpu.report as jreport
import dips_tpu_torch.app as tapp
import dips_tpu_torch.cli as tcli
import dips_tpu_torch.report as treport
from dips_tpu_torch import ChromaFilter, DeviceError
from dips_tpu_torch.convert import props_from_jax
from tests.test_torch_run import (assert_maps_close, assert_stats_close,
                                  read_avi, scene_clip, write_avi)

torch.set_num_threads(1)

H, W = 24, 40


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_avi(tmp_path_factory.mktemp("cli") / "in.avi", scene_clip())


def _stats(path):
    rows = json.load(open(path))
    return np.asarray([[r[k] for k in ("mean_diff", "mean_abs_diff",
                                       "max_abs_diff", "changed_count")]
                       for r in rows], np.float32)


RUN_ARGS = ["--batch", "4", "--encoding", "HFYU", "--record-events",
            "{d}/rec", "--pre-roll", "2", "--post-roll", "3", "--event-on",
            "0.01", "--auto-refresh", "0.6:3", "--stats-json",
            "{d}/stats.json", "--events-json", "{d}/events.json",
            "--heatmap-png", "{d}/hm.png", "--retime-vfr"]


@pytest.fixture(scope="module")
def cli_runs(scene, tmp_path_factory):
    """The same argv through both CLIs (the port's with --trace-dir and
    --profile too): {"j"/"t": (directory, stdout)}."""
    runs = {}
    base = tmp_path_factory.mktemp("runs")
    for name, main, extra in (("j", jcli.main, ["--backend", "pallas"]),
                              ("t", tcli.main,
                               ["--device", "cpu", "--trace-dir",
                                "{d}/trace", "--profile"])):
        d = base / name
        d.mkdir()
        argv = ["--input", scene, "--output", str(d / "out.avi")] + \
            [a.format(d=d) for a in RUN_ARGS + extra]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(argv) == 0
        runs[name] = (d, buf.getvalue())
    return runs


def test_cli_artifacts_match_jax(cli_runs):
    (jd, jout), (td, tout) = cli_runs["j"], cli_runs["t"]
    assert_stats_close(_stats(td / "stats.json"), _stats(jd / "stats.json"))
    assert json.load(open(td / "events.json")) == \
        json.load(open(jd / "events.json"))
    segs = [json.load(open(d / "rec" / "segments.json")) for d in (td, jd)]
    assert len(segs[0]) == len(segs[1]) == 2
    for a, b in zip(*segs):
        pa, pb = a.pop("path"), b.pop("path")
        assert os.path.dirname(pa) == str(td / "rec")
        assert os.path.basename(pa) == os.path.basename(pb)
        assert a == b
        clip = read_avi(pa)
        assert len(clip) == a["frames"]
        assert_maps_close(clip, read_avi(pb), exact=False)
    out_t, out_j = read_avi(td / "out.avi"), read_avi(jd / "out.avi")
    assert len(out_t) == 32  # a constant-rate clip: the retimer is 1:1
    assert_maps_close(out_t, out_j, exact=False)
    np.testing.assert_array_equal(cv2.imread(str(td / "hm.png")),
                                  cv2.imread(str(jd / "hm.png")))
    # the same report lines, in the same order
    keep = ("auto-refresh", "event segment", "processed", "stats written",
            "heatmap written", "motion event")
    lines = [[ln.replace(str(d), "D") for ln in out.splitlines()
              if any(k in ln for k in keep)]
             for d, out in ((td, tout), (jd, jout))]
    assert lines[0] == lines[1] and len(lines[0]) == 6
    assert "auto-refresh fired at frame(s): " in tout
    assert "StageTimers:" in tout


def test_cli_trace_names_the_run(cli_runs):
    """--trace-dir leaves one Chrome trace of the run; on the CPU its
    events are host ops (the card's kernel shows up on a card run)."""
    td, _ = cli_runs["t"]
    (name,) = os.listdir(td / "trace")
    events = json.load(open(td / "trace" / name))["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert len(events) > 10
    assert any(n.startswith("aten::") for n in names)


def test_report_renders_the_run_as_jax(cli_runs, tmp_path):
    """``dips_tpu_torch.report`` turns the port's artifacts into the same
    page as ``dips_tpu.report`` (same charts, tables, embedded heatmap)."""
    td, _ = cli_runs["t"]
    kw = dict(events_path=str(td / "events.json"),
              heatmap_path=str(td / "hm.png"), pixels=H * W,
              segments_path=str(td / "rec" / "segments.json"))
    got = treport.render_report(str(td / "stats.json"), **kw)
    assert got == jreport.render_report(str(td / "stats.json"), **kw)
    assert "Recorded segments" in got and "data:image/png;base64" in got
    out = str(tmp_path / "r.html")
    assert treport.main(["--stats-json", str(td / "stats.json"),
                         "--events-json", str(td / "events.json"),
                         "--heatmap", str(td / "hm.png"), "--segments-json",
                         str(td / "rec" / "segments.json"), "-o", out]) == 0
    assert os.path.getsize(out) > 1000
    assert treport.main(["--stats-json", str(tmp_path / "none.json")]) == 1


def _dumps(d, n, w, h, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w, 4), np.uint8)
    for i in range(n):
        f = base.copy()
        y, x = (2 + i) % (h - 6), (1 + 2 * i) % (w - 6)
        f[y:y + 6, x:x + 6, 0] = 250  # a red square
        f[y:y + 6, x + 3:x + 9, 2] = 10  # a blue one beside it
        np.concatenate([np.zeros(4, np.uint8), f.ravel()]).tofile(
            d / f"Dat_{i}.d")
    return str(d)


DAT_W, DAT_H = 27, 20  # 81 bytes a row: not a multiple of 16


@pytest.mark.parametrize("chroma", ["RED", "BLUE"])
@pytest.mark.parametrize("output", ["COLORIZE", "ABSDIFF"])
def test_custom_dips_on_files_matches_jax(tmp_path, chroma, output):
    data = _dumps(tmp_path, 11, DAT_W, DAT_H, seed=7)
    props = jp.DiPsProperties(chroma=jp.ChromaFilter[chroma],
                              output=jp.OutputMode[output], temporal_size=2)
    kw = dict(width=DAT_W, height=DAT_H, batch=4)
    exp = japp.custom_dips_on_files(data, str(tmp_path / "j.avi"),
                                    properties=props, backend="pallas",
                                    encoding=jp.Encoding.HFYU, **kw)
    got = tapp.custom_dips_on_files(data, str(tmp_path / "t.avi"),
                                    properties=props_from_jax(props),
                                    device="cpu",
                                    encoding=tapp.Encoding.HFYU, **kw)
    assert got.shape == (11, 4) and got[1:, 3].max() > 0
    assert_stats_close(got, exp)
    vt, vj = read_avi(tmp_path / "t.avi"), read_avi(tmp_path / "j.avi")
    assert vt.shape[:2] == (11, DAT_H)  # HFYU rounds the width down
    assert_maps_close(vt, vj, exact=output == "ABSDIFF")


def test_custom_dips_on_files_chroma_sees_the_right_plane(tmp_path):
    """In the median pipeline, red chroma sees the red square and blue the
    blue one, green nothing: the planes are not swapped (the dumps are
    RGB, the engine's "hwc" layout)."""
    data = _dumps(tmp_path, 6, DAT_W, DAT_H, seed=8)
    got = {}
    for c in ("RED", "BLUE", "GREEN"):
        props = tapp.DiPsProperties(chroma=ChromaFilter[c], window_size=1,
                                    temporal_size=1)
        got[c] = tapp.custom_dips_on_files(
            data, str(tmp_path / f"{c}.avi"), width=DAT_W, height=DAT_H,
            properties=props, device="cpu")
    assert got["GREEN"][1:, 3].max() == 0  # nothing moves in green
    assert got["RED"][1:, 3].min() > 0 and got["BLUE"][1:, 3].min() > 0
    assert not np.array_equal(got["RED"], got["BLUE"])


def test_cli_dat_dir_matches_jax(tmp_path, capsys):
    data = _dumps(tmp_path, 9, DAT_W, DAT_H, seed=9)
    geo = f"{DAT_W}x{DAT_H}"
    for name, main, extra in (("j", jcli.main, ["--backend", "pallas"]),
                              ("t", tcli.main, ["--device", "cpu"])):
        assert main(["--dat-dir", data, "--output",
                     str(tmp_path / f"{name}.avi"), "--dat-geometry", geo,
                     "--chroma", "r", "--encoding", "HFYU", "--batch", "4",
                     "--stats-json", str(tmp_path / f"{name}.json"),
                     "--live"] + extra) == 0
    out = capsys.readouterr().out
    assert out.count("processed 9 frames") == 2
    assert_stats_close(_stats(tmp_path / "t.json"),
                       _stats(tmp_path / "j.json"))
    assert_maps_close(read_avi(tmp_path / "t.avi"),
                      read_avi(tmp_path / "j.avi"), exact=False)


def test_custom_dips_on_files_without_dumps(tmp_path):
    with pytest.raises(tapp.VideoPathError, match="no Dat"):
        tapp.custom_dips_on_files(str(tmp_path), str(tmp_path / "o.avi"),
                                  device="cpu")


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    from dips_tpu_torch.utils.profiling import trace
    with trace(None):
        pass
    assert not os.listdir(tmp_path)
    with pytest.raises(RuntimeError, match="inside"):
        with trace(str(tmp_path / "t")):
            torch.ones(64).cumsum(0)
            raise RuntimeError("inside")
    (name,) = os.listdir(tmp_path / "t")
    events = json.load(open(tmp_path / "t" / name))["traceEvents"]
    assert any(e.get("name") == "aten::cumsum" for e in events)


@pytest.mark.parametrize("argv", [
    ["--input", "{clip}", "--record-events", "{d}/r", "--no-maps"],
    ["--input", "{clip}", "--output", "{d}/o.avi", "--output-mode",
     "stats_only"],
    ["--input", "{clip}", "--no-maps", "--retime-vfr"],
    ["--inputs", "{clip}", "{clip}", "--output-dir", "{d}",
     "--heatmap-png", "{d}/h.png"],
    ["--inputs", "{clip}", "--output-dir", "{d}", "--record-events", "r"],
    ["--inputs", "{clip}", "--output-dir", "{d}", "--dft-json", "x.json"],
    ["--input", "{clip}", "--output", "{d}/o.avi", "--subsample", "0"],
    ["--input", "{clip}", "--subsample", "2"],
    ["--thumbnail", "{d}/t.png"],
    ["--thumbnail", "{d}/t.png", "--input", "{clip}", "--stats-json", "s"],
    ["--dat-dir", "{d}"],
    ["--dat-dir", "{d}", "--output", "{d}/o.avi", "--dat-geometry", "12"],
    ["--dat-dir", "{d}", "--output", "{d}/o.avi", "--auto-refresh", "0.5"],
    ["--dat-dir", "{d}", "--output", "{d}/o.avi", "--heatmap-png", "h"],
    ["--dat-dir", "{d}", "--output", "{d}/o.avi", "--downscale", "2"],
    ["--live", "--record-events", "{d}/r"],
    ["--live", "--events-json", "{d}/e.json"],
    ["--live", "--input", "{d}/missing.avi"],
    ["--live"],
    ["--input", "{clip}", "--output", "{d}/o.avi", "--event-on", "auto",
     "--event-off", "0.1"],
    ["--input", "{clip}", "--flicker-png", "f.png"],
    ["--input", "{clip}", "--output", "{d}/o.avi", "--downscale", "0"],
    ["--input", "{clip}", "--output", "{d}/o.avi", "--auto-refresh", "x"],
    ["--input", "{clip}", "--output", "{d}/o.avi", "--roi", "1,2,3"],
    ["--input", "{clip}"],
    ["--input", "{clip}", "--output", "{d}/o.avi", "--encoding", "BOGUS"],
    ["--input", "{d}/missing.avi", "--output", "{d}/o.avi"],
    ["--input", "{clip}", "--output", "{d}/o.avi", "--record-events",
     "{d}/r", "--event-on", "0.01", "--event-off", "0.02"],
    ["--input", "{clip}", "--output", "{d}/o.avi", "--auto-refresh", "0.5",
     "--method", "per_frame"],
    ["--input", "{clip}", "--output", "{d}/o.avi", "--downscale", "3"],
    ["--thumbnail", "{d}/t.png", "--input", "{clip}"],
    ["--input", "{clip}", "--output", "{d}/s.avi", "--subsample", "5"],
], ids=lambda a: "_".join(x.strip("-").replace("{", "").replace("}", "")
                          .replace("/", "") for x in a)[:60])
def test_cli_parity_table(scene, tmp_path, capsys, argv):
    """The same argv through ``dips_tpu.cli.main`` (``--backend pallas``)
    and ``dips_tpu_torch.cli.main`` (``--device cpu``): equal exit codes
    and the same first stderr line."""
    got = []
    for name, main, extra in (("j", jcli.main, ["--backend", "pallas"]),
                              ("t", tcli.main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        args = [a.format(clip=scene, d=tmp_path) for a in argv] + extra
        rc = main(args)
        err = capsys.readouterr().err.strip().splitlines()
        got.append((rc, err[0] if err else ""))
    assert got[0] == got[1]


def test_cli_refuses_mesh_and_output_dir_outside_the_fleet(scene, tmp_path,
                                                           capsys):
    """The JAX CLI ignores --mesh and --output-dir in the single-stream
    modes; the port refuses them."""
    for flag, val in (("--mesh", "1x2"), ("--output-dir", str(tmp_path))):
        for mode in (["--input", scene, "--output", str(tmp_path / "o.avi")],
                     ["--dat-dir", str(tmp_path), "--output",
                      str(tmp_path / "o.avi")]):
            assert tcli.main(mode + [flag, val, "--device", "cpu"]) == 2
            assert f"{flag} needs the --inputs mode" in \
                capsys.readouterr().err


def test_cli_gstreamer_backend_is_not_ported(scene, tmp_path, capsys):
    """(The name dates from before the port had the backend.)
    ``--video-backend gstreamer`` decodes and encodes through GStreamer
    (the fake Gst of tests/test_gstreamer.py, fed the scene's frames):
    the stats equal the OpenCV run's."""
    import dips_tpu_torch.io.gstreamer as gst
    from tests.test_gstreamer import FakeGst
    frames = scene_clip()
    h, w = frames[0].shape[:2]
    out = {}
    for backend in ("opencv", "gstreamer"):
        fake = FakeGst(frames, w, h, num=10)
        if backend == "gstreamer":
            gst._set_gst_for_testing(fake)
        sj = str(tmp_path / f"{backend}.json")
        try:
            assert tcli.main(["--input", scene, "--output",
                              str(tmp_path / "o.avi"), "--video-backend",
                              backend, "--stats-json", sj, "--device",
                              "cpu"]) == 0
        finally:
            gst._set_gst_for_testing(None)
        out[backend] = _stats(sj)
    assert "not ported" not in capsys.readouterr().err
    assert len(fake.srcs[0].pushed) == 32 and fake.srcs[0].eos
    np.testing.assert_array_equal(out["gstreamer"], out["opencv"])


def test_new_entry_points_default_to_the_card(scene, tmp_path, capsys):
    """Without a card, every new entry point raises DeviceError by default
    and the CLI modes exit 1 with its message."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    data = _dumps(tmp_path, 3, DAT_W, DAT_H, seed=1)
    with pytest.raises(DeviceError):
        tapp.custom_dips_on_files(data, str(tmp_path / "o.avi"),
                                  width=DAT_W, height=DAT_H)
    with pytest.raises(DeviceError):
        tapp.perform_dips(tapp.DiPsJob(
            video_path=scene, output_path=str(tmp_path / "o.avi"),
            record_events=dict(dir=str(tmp_path / "r"))))
    for argv in (["--dat-dir", data, "--output", str(tmp_path / "d.avi"),
                  "--dat-geometry", f"{DAT_W}x{DAT_H}"],
                 ["--input", scene, "--output", str(tmp_path / "o.avi"),
                  "--record-events", str(tmp_path / "r"), "--retime-vfr",
                  "--auto-refresh", "0.5", "--trace-dir",
                  str(tmp_path / "tr")]):
        assert tcli.main(argv) == 1
        assert "no CUDA device" in capsys.readouterr().err
