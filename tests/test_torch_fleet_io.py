"""The port's fleet checkpoints, file run and CLI against the JAX package's.

* Fleet checkpoints (``save`` / ``load``, state dicts) saved by one package
  and resumed by the other; slot checkpoints moved between a fleet and a
  single-stream ``DiPsEngine`` of either package.
* ``run_dips_on_files`` on three cv2-written clips against the JAX
  function: counts, decoded videos, stats, events, refreshes.
* The ``--inputs`` CLI: outputs, exit codes and messages.

Inputs are made with numpy from a seed; the JAX fleet runs on a one-device
stream mesh with the Pallas backend (ring-carry, interpret mode).
Tolerances as in ``tests/test_torch_multistream.py``: raw maps exact;
emphasis maps within 1 LSB; stats atol 1e-6 with maxima and counts exact;
``gmean`` rtol 1e-6; event spans exact and their levels within 1e-6.
"""

import json

import cv2
import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import dips_tpu
import dips_tpu.cli
import dips_tpu_torch
import dips_tpu_torch.cli
from dips_tpu.models import DiPsEngine as JaxEngine
from dips_tpu.parallel import stream_mesh
from dips_tpu.properties import DiPsMethod, DiPsProperties, OutputMode
from dips_tpu_torch import DiPsEngine as TorchEngine
from dips_tpu_torch.convert import props_from_jax
from tests.conftest import make_clip
from tests.test_ring_carry import CASES
from tests.test_torch_multistream import (H, W, assert_batch_same, clips,
                                          feed_both, fleets, is_raw,
                                          torch_fleet)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("props", [CASES[1], CASES[2], CASES[4]])
def test_fleet_checkpoint_across_packages(props, tmp_path):
    """A fleet saved mid-run by one package and resumed by the other equals
    the uninterrupted run, in both directions (files and state dicts)."""
    cl = clips(12, seed=8)
    first = [list(c[:4]) for c in cl[:2]] + [list(cl[2][:3])]
    rest = [[list(c[4:8]) for c in cl[:2]] + [list(cl[2][3:7])],
            [list(c[8:12]) for c in cl]]
    jf, tf = fleets(props)
    ref = [feed_both(jf, tf, props, f) for f in [first] + rest]

    for src_kind, how in (("jax", "file"), ("torch", "file"),
                          ("jax", "dict"), ("torch", "dict")):
        jf.reset()  # one JAX fleet serves as source or destination
        src, dst = ((jf, torch_fleet(props)) if src_kind == "jax"
                    else (torch_fleet(props), jf))
        src.process_batch(first)
        dst.snapshot(stream=0)  # a pending snapshot does not survive a load
        if how == "file":
            path = str(tmp_path / f"{src_kind}.npz")
            src.save(path)
            dst.load(path)
        else:
            dst.load_state_dict(src.state_dict())
        for f, (eo, es, eg) in zip(rest, ref[1:]):
            got = dst.process_batch(f)
            assert_batch_same(props, got, (eo, es, eg))


def test_fleet_checkpoint_keeps_failures(tmp_path):
    props = CASES[3]
    cl = clips(4, seed=9)
    jf, tf = fleets(props)
    feeds = [list(cl[0]), [np.zeros((1, 1, 3), np.uint8)], list(cl[2])]
    feed_both(jf, tf, props, feeds)
    tf.save(str(tmp_path / "t.npz"))
    jf.save(str(tmp_path / "j.npz"))
    zj, zt = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        assert zj[k].shape == zt[k].shape and zj[k].dtype == zt[k].dtype, k
    np.testing.assert_array_equal(zt["tails"], zj["tails"])
    np.testing.assert_array_equal(zt["failed"], [1])
    t2 = torch_fleet(props)
    jf.load(str(tmp_path / "t.npz"))
    t2.load(str(tmp_path / "j.npz"))
    assert set(jf.failed) == set(t2.failed) == {1}


@pytest.mark.parametrize("props", [CASES[0], CASES[3], CASES[4]])
def test_slot_checkpoint_moves_between_engines(props, tmp_path):
    """A fleet slot goes into a single-stream engine of either package and
    back into a fleet of the other; every continuation equals the
    uninterrupted single-stream run.  A single-stream engine's file goes
    through a fleet slot and back byte for byte."""
    cl = clips(12, seed=11)
    pp = props_from_jax(props)
    ref = TorchEngine(pp, H, W, batch=4, device="cpu")
    ref_out, ref_stats = ref.process_frames(list(cl[1]))

    jf, tf = fleets(props)
    for f in (jf, tf):
        f.process_batch([list(c[:4]) for c in cl])
        f.process_batch([list(c[4:6]) for c in cl])
    # fleet slot -> single-stream engines (file and dict, both packages)
    tf.save_stream(1, str(tmp_path / "slot.npz"))
    jsingle = JaxEngine(props, H, W, batch=4, backend="pallas",
                        ring_carry=True)
    for single in (jsingle, TorchEngine(pp, H, W, batch=4, device="cpu")):
        single.load(str(tmp_path / "slot.npz"))
        o, s = single.process_frames(list(cl[1][6:]))
        d = np.abs(o.astype(np.int16) - ref_out[6:].astype(np.int16))
        assert d.max(initial=0) <= (0 if is_raw(props) else 1)
        np.testing.assert_allclose(s, ref_stats[6:], atol=1e-6)
    one = TorchEngine(pp, H, W, batch=4, device="cpu")
    one.load_state_dict(jf.stream_state_dict(1))
    assert_batch_same(props, one.process_batch(list(cl[1][6:10])) + (0.0,),
                      (ref_out[6:10], ref_stats[6:10], 0.0))
    # single-stream engine -> a slot of the other package's fleet, while
    # the sibling slots keep their own state
    jsingle.reset()
    jsingle.process_frames(list(cl[1][:6]))
    jsingle.save(str(tmp_path / "single.npz"))
    slot = tf.stream_state_dict(1)
    t2 = torch_fleet(props)
    for f in (t2, jf):
        f.reset()
        f.process_batch([list(c[:4]) for c in cl])
        f.process_batch([list(c[4:6]) for c in cl])
    t2.load_stream(1, str(tmp_path / "single.npz"))
    jf.load_stream_state(1, slot)
    feeds = [list(c[6:10]) for c in cl]
    got_t, got_j = t2.process_batch(feeds), jf.process_batch(feeds)
    exp = tf.process_batch(feeds)
    assert_batch_same(props, got_t, exp)
    assert_batch_same(props, got_j, exp)
    # single -> fleet slot -> single: the one-stream .npz byte for byte
    one.save(str(tmp_path / "one.npz"))
    t2.load_stream(2, str(tmp_path / "one.npz"))
    t2.save_stream(2, str(tmp_path / "back.npz"))
    with np.load(tmp_path / "one.npz") as a, \
            np.load(tmp_path / "back.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), k
    back = TorchEngine(pp, H, W, batch=4, device="cpu")
    back.load(str(tmp_path / "back.npz"))
    for k, v in one.state_dict().items():
        np.testing.assert_array_equal(back.state_dict()[k], v, err_msg=k)


# ---------------------------------------------------------------------------
# the file run and the CLI
# ---------------------------------------------------------------------------

FH, FW = 16, 200


@pytest.fixture(scope="module")
def clip_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet")
    paths = []
    for si, n in enumerate((9, 6, 11)):
        path = str(d / f"cam{si}.avi")
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10,
                             (FW, FH))
        for f in make_clip(n=n, h=FH, w=FW, seed=20 + si):
            vw.write(f[..., ::-1])
        vw.release()
        paths.append(path)
    return paths


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


@pytest.mark.parametrize("kw", [
    dict(),
    dict(output=OutputMode.ABSDIFF),
    dict(method=DiPsMethod.PER_FRAME, window_size=5,
         output=OutputMode.GRAYSCALE),
])
def test_run_dips_on_files_matches_jax(clip_paths, tmp_path, kw):
    props = DiPsProperties(refresh_markers=(4,), **kw)
    events = dict(on_threshold=0.001, min_frames=1)
    refresh = (dict(threshold=0.05, persist=2)
               if props.method == DiPsMethod.OVERALL else None)
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    exp = dips_tpu.app.run_dips_on_files(
        clip_paths, str(jdir), encoding="HFYU", properties=props, batch=4,
        backend="pallas", mesh=stream_mesh(1), events=events,
        collect_stats=True, auto_refresh=refresh)
    got = dips_tpu_torch.run_dips_on_files(
        clip_paths, str(tdir), encoding="HFYU",
        properties=props_from_jax(props), batch=4, device="cpu",
        events=events, collect_stats=True, auto_refresh=refresh)
    assert len(got) == len(exp) == (4 if refresh else 3)
    assert list(got[0]) == list(exp[0]) == [9, 6, 11]
    for ge, ee in zip(got[1], exp[1]):  # events: spans exact, levels 1e-6
        assert len(ge) == len(ee)
        for a, b in zip(ge, ee):
            a, b = a.to_dict(), b.to_dict()
            for k in ("peak", "mean"):
                assert abs(a.pop(k) - b.pop(k)) <= 1e-6
            assert a == b
    for gs, es in zip(got[2], exp[2]):
        np.testing.assert_array_equal(gs[:, 2:], es[:, 2:])
        np.testing.assert_allclose(gs[:, :2], es[:, :2], rtol=0, atol=1e-6)
    if refresh:
        assert got[3] == exp[3]
    for si in range(3):
        name = f"cam{si}.dips.avi"
        va, vb = read_video(str(tdir / name)), read_video(str(jdir / name))
        assert va.shape == vb.shape
        d = np.abs(va.astype(np.int16) - vb.astype(np.int16))
        assert d.max() <= (0 if props.output == OutputMode.ABSDIFF else 1)


def test_run_dips_on_files_names_and_checks(clip_paths, tmp_path):
    props = dips_tpu_torch.DiPsProperties(
        output=dips_tpu_torch.OutputMode.ABSDIFF)
    counts = dips_tpu_torch.run_dips_on_files(
        [clip_paths[0], clip_paths[0]], str(tmp_path / "o"),
        properties=props, batch=4, device="cpu")
    assert list(counts) == [9, 9]
    for si in range(2):
        assert len(read_video(str(tmp_path / "o" / f"cam0.{si}.dips.avi"))) \
            == 9
    other = str(tmp_path / "wide.avi")
    vw = cv2.VideoWriter(other, cv2.VideoWriter_fourcc(*"MJPG"), 10,
                         (FW + 8, FH))
    vw.write(np.zeros((FH, FW + 8, 3), np.uint8))
    vw.release()
    with pytest.raises(dips_tpu_torch.VideoPathError, match="geometry"):
        dips_tpu_torch.run_dips_on_files([clip_paths[0], other],
                                         str(tmp_path / "x"), device="cpu")
    # the GStreamer backend opens GStreamer readers and writers (the fake
    # Gst of tests/test_gstreamer.py: every input decodes to 5 frames)
    import dips_tpu_torch.io.gstreamer as gst
    from tests.test_gstreamer import FakeGst
    fake = FakeGst(list(make_clip(n=5, h=FH, w=FW, seed=9)), FW, FH, num=10)
    gst._set_gst_for_testing(fake)
    try:
        counts = dips_tpu_torch.run_dips_on_files(
            clip_paths, str(tmp_path / "g"), properties=props, batch=4,
            device="cpu", video_backend="gstreamer")
    finally:
        gst._set_gst_for_testing(None)
    assert list(counts) == [5, 5, 5]
    assert len(fake.sinks) == len(fake.srcs) == 3
    assert all(len(src.pushed) == 5 and src.eos for src in fake.srcs)
    # the ported options run (their outputs are held in
    # tests/test_torch_options.py and tests/test_torch_fleet_flicker.py)
    for kw in (dict(downscale=2), dict(input_layout="planar"),
               dict(flicker=dict(freq_hz=4.0))):
        res = dips_tpu_torch.run_dips_on_files(
            [clip_paths[0], clip_paths[0]], str(tmp_path / "y"),
            properties=props, batch=4, device="cpu", **kw)
        counts = res[0] if "flicker" in kw else res
        assert list(counts) == [9, 9]


def test_cli_inputs_matches_jax(clip_paths, tmp_path, capsys):
    args = ["--batch", "4", "--stats-json", "{d}/stats.json",
            "--events-json", "{d}/events.json", "--event-on", "0.001",
            "--auto-refresh", "0.05:2"]
    docs = {}
    for name, main, extra in (("j", dips_tpu.cli.main, []),
                              ("t", dips_tpu_torch.cli.main,
                               ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        rc = main(["--inputs", *clip_paths, "--output-dir", str(d),
                   "--encoding", "HFYU"] + [a.format(d=d) for a in args]
                  + extra)
        assert rc == 0
        out = capsys.readouterr().out
        assert "processed 3 streams (26 frames)" in out
        docs[name] = [json.load(open(d / f)) for f in ("stats.json",
                                                       "events.json")]
    (ts, te), (js, je) = docs["t"], docs["j"]
    assert list(ts) == list(js) == list(te) == list(je) == clip_paths
    for k in te:
        assert [(e["start_frame"], e["end_frame"]) for e in te[k]] == \
            [(e["start_frame"], e["end_frame"]) for e in je[k]]
    for k in ts:
        for a, b in zip(ts[k], js[k]):
            assert a["changed_count"] == b["changed_count"]
            assert a["max_abs_diff"] == b["max_abs_diff"]
            assert abs(a["mean_abs_diff"] - b["mean_abs_diff"]) <= 1e-6


@pytest.mark.parametrize("argv,rc,msg", [
    (["--inputs", "{0}"], 2, "--inputs requires --output-dir"),
    (["--inputs", "{0}", "--output-mode", "stats_only", "--output-dir",
      "{d}"], 2, "writes no diff video"),
    (["--inputs", "{0}", "--output-dir", "{d}", "--encoding", "XYZ"], 2,
     "unknown --encoding"),
    (["--inputs", "{0}", "--output-dir", "{d}", "--auto-refresh", "x"], 2,
     "bad --auto-refresh"),
    (["--inputs", "{0}", "--output-dir", "{d}", "--event-on", "auto",
      "--event-off", "0.1"], 2, "--event-off is computed in auto mode"),
    (["--inputs", "{0}", "/nonexistent.avi", "--output-dir", "{d}"], 1,
     "error:"),
    (["--input", "{0}", "--output", "{d}/o.avi", "--output-dir", "{d}"], 2,
     "--output-dir needs the --inputs mode"),
])
def test_cli_inputs_usage(clip_paths, tmp_path, capsys, argv, rc, msg):
    argv = [a.format(*clip_paths, d=tmp_path) for a in argv]
    assert dips_tpu_torch.cli.main(argv + ["--device", "cpu"]) == rc
    assert msg in capsys.readouterr().err


def test_cli_inputs_failed_stream_exits_1(clip_paths, tmp_path, capsys,
                                          monkeypatch):
    """A stream that fails mid-run is isolated: the others finish, its
    count is -1, and the CLI warns and exits 1."""
    real = dips_tpu_torch.MultiStreamEngine.process_batch

    def bad_frames(self, feeds):
        if self.frame_cursors[1] >= 4 and feeds[1]:
            feeds = list(feeds)
            feeds[1] = [np.zeros((3, 3, 3), np.uint8)]
        return real(self, feeds)

    monkeypatch.setattr(dips_tpu_torch.MultiStreamEngine, "process_batch",
                        bad_frames)
    rc = dips_tpu_torch.cli.main(["--inputs", *clip_paths, "--output-dir",
                                  str(tmp_path), "--batch", "4",
                                  "--device", "cpu"])
    assert rc == 1
    cap = capsys.readouterr()
    assert "1 stream(s) failed and were isolated" in cap.err
    assert "processed 3 streams (20 frames)" in cap.out
    assert len(read_video(str(tmp_path / "cam1.dips.avi"))) == 4
