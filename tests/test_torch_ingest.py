"""The port's ingest side of ``stream_dips`` against the JAX package's.

``decode_workers`` (chunked parallel decode over seeked readers, consumed
in order through the chunk rings) and ``pipeline_depth`` (one batch in
flight) in ``dips_tpu_torch.app.stream_dips``, on the same MJPG clip
made with numpy from a seed: every (workers, depth) run of the port, in
the hwc and the planar layout, equals ``dips_tpu.app.stream_dips`` at
(1, 1) in indices, yielded inputs, timestamps, maps and stats, in
COLORIZE w3/T4 and in ABSDIFF.  The JAX side runs with
``backend="pallas"`` (interpret mode on the CPU), the port with
``device="cpu"``.  Then the same through the real GStreamer stack (its
readers decode to RGB: the "hwc" layout, and no chunking without a
seek), the CLI's ``--decode-workers`` / ``--pipeline-depth``, and the
engines' host planarize through ``native.planarize``.

Tolerances are the repo's: maps byte-equal, stats within 1e-6 with
changed counts and maxima exact; between the port's own runs everything
is bit for bit.
"""

import contextlib
import dataclasses
import io
import json

import cv2
import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import dips_tpu.app as japp
import dips_tpu.cli as jcli
import dips_tpu.io.gstreamer as jgst
import dips_tpu.properties as jp
import dips_tpu_torch.app as tapp
import dips_tpu_torch.cli as tcli
import dips_tpu_torch.io.gstreamer as tgst
from dips_tpu_torch import native
from dips_tpu_torch.convert import props_from_jax
from dips_tpu_torch.errors import DecodeError
from dips_tpu_torch.utils.profiling import StageTimers
from tests.conftest import make_clip

torch.set_num_threads(1)

H, W, N, FPS, BATCH = 48, 64, 26, 12, 4
MODES = {
    "colorize": jp.DiPsProperties(window_size=3, temporal_size=4),
    "absdiff": jp.DiPsProperties(output=jp.OutputMode.ABSDIFF),
}
COMBOS = [(w, d) for w in (1, 2, 3, 5) for d in (1, 2)]

try:
    from dips_tpu_torch.io.gstbind import load_gst
    GST = load_gst()
except Exception:  # noqa: BLE001 - any load failure = no C stack
    GST = None


def ingest_frames(n=N, h=H, w=W, seed=41):
    """A gradient with a little noise and a moving square (MJPG encodes
    every still copy alike)."""
    frames = make_clip(n=n, h=h, w=w, seed=seed)
    yy, xx = np.mgrid[0:h, 0:w]
    grad = np.stack([yy * 3, xx * 2, (yy + xx)], -1).astype(np.uint8)
    return np.where(frames > 200, frames, grad // 2 + frames // 2)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ingest") / "in.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), FPS, (W, H))
    for f in ingest_frames():
        vw.write(np.ascontiguousarray(f[..., ::-1]))
    vw.release()
    return path


def run(app, job):
    """(indices, inputs, maps, stats) of a whole stream_dips run and the
    job's frame_pts."""
    items = list(app.stream_dips(job))
    return ([i for i, *_ in items], np.stack([x[1] for x in items]),
            np.stack([x[2] for x in items]), np.stack([x[3] for x in items]),
            list(job.frame_pts))


def assert_same_run(got, exp, exact_stats=True):
    gi, ginp, gmaps, gst, gpts = got
    ei, einp, emaps, est, epts = exp
    assert gi == ei == list(range(len(ei)))
    np.testing.assert_array_equal(ginp, einp)
    assert gpts == epts
    np.testing.assert_array_equal(gmaps, emaps)
    if exact_stats:
        np.testing.assert_array_equal(gst, est)
    else:
        np.testing.assert_array_equal(gst[:, 2:], est[:, 2:])
        np.testing.assert_allclose(gst[:, :2], est[:, :2], rtol=0,
                                   atol=1e-6)


_JAX = {}


def jax_run(path, mode, layout, backend="opencv"):
    """JAX's stream_dips at (1, 1), once per (clip, mode, layout)."""
    key = (path, mode, layout, backend)
    if key not in _JAX:
        _JAX[key] = run(japp, japp.DiPsJob(
            properties=MODES[mode], video_path=path, batch=BATCH,
            backend="pallas", input_layout=layout, yield_inputs=True,
            video_backend=backend))
    return _JAX[key]


def port_job(path, mode, layout, workers=1, depth=1, **kw):
    return tapp.DiPsJob(properties=props_from_jax(MODES[mode]),
                        video_path=path, batch=BATCH, device="cpu",
                        input_layout=layout, yield_inputs=True,
                        decode_workers=workers, pipeline_depth=depth, **kw)


@pytest.mark.parametrize("workers,depth", COMBOS)
@pytest.mark.parametrize("layout", ["hwc", "planar"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_stream_matches_jax(clip, mode, layout, workers, depth):
    """Every (decode_workers, pipeline_depth) of the port equals JAX's
    stream at (1, 1): indices, RGB inputs, timestamps, maps, stats."""
    got = run(tapp, port_job(clip, mode, layout, workers, depth))
    assert len(got[0]) == N
    assert_same_run(got, jax_run(clip, mode, layout), exact_stats=False)
    if (workers, depth) != (1, 1):
        assert_same_run(got, run(tapp, port_job(clip, mode, layout)))


@pytest.mark.parametrize("workers,depth", [(1, 1), (3, 2)])
@pytest.mark.parametrize("layout", ["hwc", "planar"])
def test_pooled_ring_pops_match_jax(clip, monkeypatch, layout, workers,
                                    depth):
    """With the pool threshold patched below every slot (four copiers,
    1 KiB chunks) each frame pops through the copy pool: the run equals
    the unpooled one and JAX's, bit for bit, and every pop is counted as
    pooled."""
    from dips_tpu_torch.utils import staging
    if not native.NATIVE_AVAILABLE:
        pytest.skip("native framepump unavailable")
    plain = run(tapp, port_job(clip, "colorize", layout, workers, depth))
    monkeypatch.setattr(staging, "POOL_ABOVE", -1)
    monkeypatch.setattr(staging, "CHUNK_BYTES", 1024)
    monkeypatch.setattr(staging, "pool_threads", lambda: 4)
    job = port_job(clip, "colorize", layout, workers, depth, profile=True)
    got = run(tapp, job)
    assert_same_run(got, plain)
    assert_same_run(got, jax_run(clip, "colorize", layout),
                    exact_stats=False)
    assert job.engine.staging.pops == job.engine.staging.pooled_pops == N


def test_ring_pop_stage_in_the_engines_timers(clip):
    """``ring_pop`` is timed once a batch into the engine's timers as they
    are when the batch is popped, so timers a caller sets mid-run (as the
    benchmark does) see it; ``pops`` counts the frames popped while they
    are set, none of them pooled below the threshold."""
    job = port_job(clip, "absdiff", "hwc", profile=True)
    assert len(list(tapp.stream_dips(job))) == N
    batches = -(-N // BATCH)
    assert job.timers.counts["ring_pop"] == batches
    assert job.engine.staging.pops == N
    assert job.engine.staging.pooled_pops == 0
    job = port_job(clip, "absdiff", "hwc")
    gen = tapp.stream_dips(job)
    for _ in range(BATCH):  # the first batch, popped with no timers
        next(gen)
    job.engine.timers = timers = StageTimers()
    assert len(list(gen)) == N - BATCH
    assert timers.counts["ring_pop"] == batches - 1
    assert job.engine.staging.pops == N - BATCH


def test_chunks_open_one_reader_each(clip, monkeypatch):
    """decode_workers=3 closes the probe reader and decodes three
    contiguous chunks, each on its own seeked reader with its own timers
    ("decode", "decode1", "decode2" and their "planarize*" twins, as in
    the JAX package); more workers than frames are clamped."""
    opened, seeks = [], []
    real = tgst.open_video

    def spy(path, backend="auto"):
        rd = real(path, backend)
        opened.append(rd)
        seek = rd.seek_frame
        rd.seek_frame = lambda i: (seeks.append(i), seek(i))[1]
        return rd

    monkeypatch.setattr(tgst, "open_video", spy)
    job = port_job(clip, "absdiff", "planar", workers=3, profile=True)
    assert len(list(tapp.stream_dips(job))) == N
    assert len(opened) == 4 and seeks == [0, 8, 16]
    stages = set(job.timers.totals)
    assert {"decode", "decode1", "decode2", "planarize", "planarize1",
            "planarize2", "device"} <= stages
    jjob = japp.DiPsJob(properties=MODES["absdiff"], video_path=clip,
                        batch=BATCH, backend="pallas", decode_workers=3,
                        input_layout="planar", profile=True)
    list(japp.stream_dips(jjob))
    assert {s for s in jjob.timers.totals if "decode" in s
            or "planarize" in s} == {s for s in stages if "decode" in s
                                     or "planarize" in s}
    opened.clear()
    short = str(clip).replace("in.avi", "short.avi")
    vw = cv2.VideoWriter(short, cv2.VideoWriter_fourcc(*"MJPG"), FPS, (W, H))
    for f in ingest_frames(n=3):
        vw.write(np.ascontiguousarray(f[..., ::-1]))
    vw.release()
    job = port_job(short, "absdiff", "hwc", workers=5, depth=2)
    assert len(list(tapp.stream_dips(job))) == 3
    assert len(opened) == 4  # the probe, then one reader a frame


class _PlainReader:
    """A reader with neither a frame count nor a seek: one worker decodes
    whatever decode_workers says."""

    native_rgb = False
    frame_count = -1
    fps = float(FPS)

    def __init__(self, frames):
        self.frames = frames
        self.height, self.width = frames[0].shape[:2]
        self.closed = False

    def iter_bgr_timed(self):
        for k, f in enumerate(self.frames):
            yield np.ascontiguousarray(f[..., ::-1]), k / FPS

    def close(self):
        self.closed = True


@pytest.mark.parametrize("depth", [1, 2])
def test_unseekable_reader_decodes_on_one_worker(depth):
    frames = ingest_frames(n=11)
    got = run(tapp, port_job("x://", "colorize", "planar", 4, depth,
                             reader=_PlainReader(frames)))
    exp = run(japp, japp.DiPsJob(properties=MODES["colorize"],
                                 video_path="x://", batch=BATCH,
                                 backend="pallas", input_layout="planar",
                                 yield_inputs=True, decode_workers=4,
                                 reader=_PlainReader(frames)))
    assert_same_run(got, exp, exact_stats=False)
    np.testing.assert_array_equal(got[1], frames)
    assert got[4] == [k / FPS for k in range(11)]


def test_a_failing_chunk_raises_and_closes_every_reader(clip, monkeypatch):
    """A decode error in a later chunk surfaces as DecodeError (chained),
    and every chunk reader is closed, as in the JAX package."""
    opened = []
    real = tgst.open_video

    def spy(path, backend="auto"):
        rd = real(path, backend)
        opened.append(rd)
        if len(opened) == 4:  # the last chunk's reader
            def boom():
                yield from ()
                raise OSError("decoder died")
            rd.iter_bgr_timed = boom
        closes = rd.close
        rd.closed = False
        rd.close = lambda: (setattr(rd, "closed", True), closes())
        return rd

    monkeypatch.setattr(tgst, "open_video", spy)
    with pytest.raises(DecodeError, match="decoder died") as ei:
        list(tapp.stream_dips(port_job(clip, "absdiff", "hwc", 3, 2)))
    assert isinstance(ei.value.__cause__, OSError)
    assert len(opened) == 4 and all(rd.closed for rd in opened)


def test_depth_two_keeps_one_batch_in_flight(clip, monkeypatch):
    """At depth 2 batch k is collected only after batch k+1 was
    dispatched; at depth 1 right after its own dispatch."""
    eng_cls = tapp.DiPsEngine
    for depth, expect in ((1, "dcdcdc"), (2, "ddcdcd")):
        calls = []

        class Spy(eng_cls):
            def dispatch_async(self, buf, n):
                calls.append("d")
                return super().dispatch_async(buf, n)

            def collect(self, handle, packed=False):
                calls.append("c")
                return super().collect(handle, packed)

        monkeypatch.setattr(tapp, "DiPsEngine", Spy)
        list(tapp.stream_dips(port_job(clip, "absdiff", "hwc", 1, depth)))
        assert "".join(calls).startswith(expect)
        assert calls.count("d") == calls.count("c") == -(-N // BATCH)


def test_auto_refresh_and_callback_at_depth_two(clip, tmp_path):
    """perform_dips at (3, 2) equals (1, 1) with a frame callback, an
    auto-refresh policy and event recording: the callback sees every
    frame in order, the written video and artifacts are the same."""
    seen = {}
    results = {}
    for workers, depth in ((1, 1), (3, 2)):
        calls = seen.setdefault((workers, depth), [])

        def cb(idx, inp, out, stats, _c=calls):
            _c.append((idx, int(inp.sum()), int(out.sum())))

        d = tmp_path / f"{workers}{depth}"
        d.mkdir()
        job = port_job(clip, "colorize", "hwc", workers, depth,
                       output_path=str(d / "o.avi"), frame_callback=cb,
                       auto_refresh=dict(threshold=0.05, persist=1),
                       record_events=dict(dir=str(d / "rec")))
        job = job.with_encoding("HFYU")
        results[(workers, depth)] = (tapp.perform_dips(job), job)
    (s1, j1), (s2, j2) = results[(1, 1)], results[(3, 2)]
    np.testing.assert_array_equal(s1, s2)
    assert seen[(1, 1)] == seen[(3, 2)] and len(seen[(1, 1)]) == N
    assert j1.frame_pts == j2.frame_pts
    assert j1.baseline_refreshes == j2.baseline_refreshes
    assert [dict(s, path=None) for s in j1.event_segments] == \
        [dict(s, path=None) for s in j2.event_segments]
    read = []
    for job in (j1, j2):
        cap = cv2.VideoCapture(job.output_path)
        frames = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(f)
        cap.release()
        read.append(np.stack(frames))
    np.testing.assert_array_equal(*read)


def test_cli_decode_workers_and_depth_match_jax(clip, tmp_path):
    """``--decode-workers 3 --pipeline-depth 2 --profile`` through both
    CLIs: the same stats and the same written video as each other and as
    the port's default run; the port's report names the chunks' decode
    stages."""
    runs = {}
    for name, main, extra in (
            ("j", jcli.main, ["--backend", "pallas", "--decode-workers",
                              "3", "--pipeline-depth", "2"]),
            ("t", tcli.main, ["--device", "cpu", "--decode-workers", "3",
                              "--pipeline-depth", "2"]),
            ("t1", tcli.main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["--input", clip, "--output", str(d / "o.avi"),
                         "--encoding", "HFYU", "--batch", str(BATCH),
                         "--output-mode", "absdiff", "--stats-json",
                         str(d / "s.json"), "--profile"] + extra) == 0
        cap = cv2.VideoCapture(str(d / "o.avi"))
        frames = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(f)
        runs[name] = (json.load(open(d / "s.json")), np.stack(frames),
                      buf.getvalue())
    assert runs["t"][0] == runs["t1"][0]
    np.testing.assert_array_equal(runs["t"][1], runs["t1"][1])
    for a, b in zip(runs["t"][0], runs["j"][0]):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == pytest.approx(b[k], abs=1e-6), k
    np.testing.assert_array_equal(runs["t"][1], runs["j"][1])
    assert len(runs["t"][1]) == N
    for stage in ("decode1", "decode2", "device", "ring_pop"):
        assert stage in runs["t"][2]
    assert f"ring: {N} pops, 0 pooled, ring_pop " in runs["t"][2]


@pytest.mark.parametrize("argv,msg", [
    (["--pipeline-depth", "3"], "invalid choice"),
    (["--decode-workers", "two"], "invalid int value")])
def test_cli_rejects_bad_values_as_jax(clip, tmp_path, capsys, argv, msg):
    base = ["--input", clip, "--output", str(tmp_path / "o.avi")]
    for main in (tcli.main, jcli.main):
        with pytest.raises(SystemExit) as ei:
            main(base + argv)
        assert ei.value.code == 2 and msg in capsys.readouterr().err


def test_defaults_match_jax():
    """The two options default to 1 in the job and the CLI, as in JAX:
    the default run is unchanged."""
    assert tapp.DiPsJob().decode_workers == japp.DiPsJob().decode_workers
    assert tapp.DiPsJob().pipeline_depth == japp.DiPsJob().pipeline_depth
    ta, ja = tcli.build_parser().parse_args([]), jcli.build_parser(
    ).parse_args([])
    assert (ta.decode_workers, ta.pipeline_depth) == \
        (ja.decode_workers, ja.pipeline_depth) == (1, 1)


# -- the engines' host planarize ---------------------------------------------

@pytest.mark.parametrize("force_fallback", [False, True])
def test_engines_planarize_through_native(force_fallback, monkeypatch):
    """The planar layout's host planarize (engine, fleet, checkpoint
    tails) runs native.planarize, and gives what the hwc layout gives,
    with the library and in the numpy fallback."""
    from dips_tpu_torch import DiPsEngine, DiPsProperties, MultiStreamEngine
    if force_fallback:
        monkeypatch.setattr(native, "_lib", None)
    calls = []
    real = native.planarize
    monkeypatch.setattr(native, "planarize",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    frames = list(ingest_frames(n=9, seed=43))
    props = DiPsProperties(window_size=3, temporal_size=4)
    out = {}
    for layout in ("planar", "hwc"):
        eng = DiPsEngine(props, H, W, batch=BATCH, device="cpu",
                         input_layout=layout)
        o, s = eng.process_frames(frames)
        fleet = MultiStreamEngine(props, H, W, 2, batch=BATCH, device="cpu",
                                  input_layout=layout)
        fo, fs, _ = fleet.process_batch([frames[:BATCH], frames[1:5]])
        out[layout] = (o, s, fo, fs, eng.state_dict()["tail"],
                       fleet.state_dict()["tails"][1])
    for a, b in zip(out["planar"], out["hwc"]):
        np.testing.assert_array_equal(a, b)
    assert len(calls) >= len(frames) + 2 * BATCH


# -- through the real GStreamer stack ----------------------------------------

@pytest.fixture
def real_gst():
    """Both packages' gates pinned to the real C stack for the test (the
    fake suites install fakes; order must not matter)."""
    if GST is None:
        pytest.skip("GStreamer C libraries not loadable")
    old = [(m._gst, m._gst_err) for m in (tgst, jgst)]
    for m in (tgst, jgst):
        m._gst, m._gst_err = GST, None
    yield
    for m, (g, e) in zip((tgst, jgst), old):
        m._gst, m._gst_err = g, e


@pytest.fixture(scope="module")
def gst_clip(tmp_path_factory):
    """A theora clip written by the port's GStreamer writer, with its
    timestamps (None when the stack does not load)."""
    if GST is None:
        return None
    old = (tgst._gst, tgst._gst_err)
    tgst._gst, tgst._gst_err = GST, None
    try:
        path = str(tmp_path_factory.mktemp("gst") / "in.ogv")
        wr = tgst.GstVideoWriter(path, FPS, W, H)
        for k, f in enumerate(ingest_frames(n=18)):
            wr.write(f, pts=k / FPS)
        wr.close()
    finally:
        tgst._gst, tgst._gst_err = old
    return path


@pytest.mark.parametrize("workers,depth", [(1, 1), (3, 2)])
@pytest.mark.parametrize("layout", ["hwc", "planar"])
def test_gstreamer_stream_matches_jax(real_gst, gst_clip, layout, workers,
                                      depth):
    """video_backend="gstreamer" on both sides: the RGB reader takes the
    "hwc" layout (no BGR swap) or is planarized without a swap; the
    port's run equals JAX's at (1, 1) (no seek: one decode worker)."""
    job = port_job(gst_clip, "colorize", layout, workers, depth,
                   video_backend="gstreamer")
    got = run(tapp, job)
    assert isinstance(job.engine, tapp.DiPsEngine)
    assert job.engine.input_layout == layout
    assert len(got[0]) == 18
    assert got[4] == pytest.approx([k / FPS for k in range(18)], abs=1e-6)
    assert_same_run(got, jax_run(gst_clip, "colorize", layout, "gstreamer"),
                    exact_stats=False)


def test_gstreamer_writer_carries_the_timestamps(real_gst, gst_clip,
                                                  tmp_path):
    """perform_dips with a GStreamer writer: no retimer, each frame's
    timestamp written, read back from the file; retime_vfr changes
    nothing there."""
    outs = {}
    for retime in (False, True):
        out = str(tmp_path / f"o{int(retime)}.ogv")
        job = port_job(gst_clip, "absdiff", "hwc", 1, 2, output_path=out,
                       video_backend="gstreamer", retime_vfr=retime)
        stats = tapp.perform_dips(job)
        assert stats.shape == (18, 4)
        rd = tgst.GstVideoReader(out)
        got = []
        while (r := rd.read_timed()) is not None:
            got.append(r)
        rd.close()
        assert [p for _, p in got] == pytest.approx(job.frame_pts, abs=1e-6)
        outs[retime] = np.stack([f for f, _ in got])
    np.testing.assert_array_equal(outs[False], outs[True])


def test_job_field_order_matches_jax():
    assert ["device" if f.name == "backend" else f.name
            for f in dataclasses.fields(japp.DiPsJob)] == \
        [f.name for f in dataclasses.fields(tapp.DiPsJob)]


def test_utils_exports_the_jax_names():
    """``dips_tpu_torch.utils`` exports what ``dips_tpu.utils`` does (the
    framepump ring's fallback takes UCircularIndex from it)."""
    import dips_tpu.utils as jutils
    import dips_tpu_torch.utils as tutils
    assert tutils.StageTimers is StageTimers
    for name in ("UCircularIndex", "StageTimers", "trace"):
        assert callable(getattr(tutils, name))
        assert callable(getattr(jutils, name))


class _RgbReader(_PlainReader):
    """A reader that decodes to RGB, as GStreamer's do."""

    native_rgb = True

    def iter_rgb_timed(self):
        for k, f in enumerate(self.frames):
            yield f, k / FPS


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("layout", ["hwc", "planar"])
@pytest.mark.parametrize("reader_cls", [_PlainReader, _RgbReader],
                         ids=["bgr", "rgb"])
def test_inputs_outlive_rotating_batch_buffers(monkeypatch, reader_cls,
                                               layout, depth):
    """Kept inputs stay the decoded frames when the engine hands its batch
    buffers out again two batches later, as the card's pinned pair is."""
    eng_cls = tapp.DiPsEngine

    class Rotating(eng_cls):
        def new_batch_buffer(self):
            if not hasattr(self, "_pair"):
                self._pair = [np.empty(self._buffer_shape, np.uint8)
                              for _ in range(2)]
                self._turn = 0
            self._turn += 1
            return self._pair[self._turn % 2]

    monkeypatch.setattr(tapp, "DiPsEngine", Rotating)
    frames = ingest_frames(n=14)
    got = run(tapp, port_job("x://", "absdiff", layout, 1, depth,
                             reader=reader_cls(frames)))
    np.testing.assert_array_equal(got[1], frames)
    assert got[0] == list(range(14))
