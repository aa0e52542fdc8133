"""The port's single-stream run path against the JAX package's.

``dips_tpu_torch.app.perform_dips`` / ``stream_dips`` (event recording,
adaptive baseline refresh, VFR retiming, ``yield_inputs``,
``decode_stall_s``, ``queue_depth``, the run artifacts and the error
types) beside ``dips_tpu.app``'s on the same clips, made with numpy from
a seed and written losslessly (HFYU).  The JAX side runs with
``backend="pallas"`` (interpret mode on the CPU), the port with
``device="cpu"`` (the kernels' plain twins).

Tolerances: ABSDIFF maps and every integer artifact exact, COLORIZE maps
within 1 LSB, stats atol 1e-6 with changed counts and maxima exact.
"""

import dataclasses
import os
import threading
import time
import unittest.mock as mock

import cv2
import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import dips_tpu.app as japp
import dips_tpu.properties as jp
import dips_tpu_torch.app as tapp
from dips_tpu_torch import (DeviceError, FrameCallbackError, OutputMode,
                            OutputPathError, VideoPathError)
from dips_tpu_torch.convert import props_from_jax
from dips_tpu_torch.errors import DecodeError
from tests.conftest import make_clip

torch.set_num_threads(1)

H, W = 24, 40
CPU = dict(device="cpu")
JAX = dict(backend="pallas")


def write_avi(path, frames, fps=10):
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"HFYU"), fps,
                         (frames[0].shape[1], frames[0].shape[0]))
    for f in frames:
        vw.write(np.ascontiguousarray(f[..., ::-1]))
    vw.release()
    return str(path)


def read_avi(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return np.stack(out) if out else np.zeros((0,), np.uint8)


def scene_clip():
    """Still noise, a moving square, still again, then a lighting flip:
    32 frames."""
    still = list(make_clip(n=6, h=H, w=W, seed=3, moving=False))
    moving = list(make_clip(n=8, h=H, w=W, seed=3, moving=True))
    lit = [np.clip(f.astype(np.int16) + 90, 0, 255).astype(np.uint8)
           for f in make_clip(n=10, h=H, w=W, seed=3, moving=False)]
    return still + moving + still[:4] + still[:4] + lit


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_avi(tmp_path_factory.mktemp("scene") / "in.avi",
                     scene_clip())


def assert_maps_close(got, exp, exact):
    assert got.shape == exp.shape
    d = np.abs(got.astype(np.int16) - exp.astype(np.int16))
    assert d.max(initial=0) <= (0 if exact else 1)


def assert_stats_close(got, exp):
    assert got.shape == exp.shape
    np.testing.assert_array_equal(got[:, 2:], exp[:, 2:])
    np.testing.assert_allclose(got[:, :2], exp[:, :2], rtol=0, atol=1e-6)


def jobs(tmp_path, src, props, **kw):
    """The JAX job and the port's for the same run (outputs under
    ``tmp_path/j`` and ``tmp_path/t``)."""
    out = []
    for pkg, job, dev in (("j", japp.DiPsJob, JAX), ("t", tapp.DiPsJob, CPU)):
        d = tmp_path / pkg
        d.mkdir(exist_ok=True)
        p = props if pkg == "j" else props_from_jax(props)
        extra = {k: (v(d) if callable(v) else v) for k, v in kw.items()}
        out.append(job(properties=p, video_path=src,
                       output_path=str(d / "out.avi"), **dev,
                       **extra).with_encoding("HFYU"))
    return out


RECORD = dict(on_threshold=0.01, metric="changed_frac", min_frames=2)


@pytest.mark.parametrize("output", ["ABSDIFF", "COLORIZE"])
def test_record_events_matches_jax(scene, tmp_path, output):
    """Segments (spans, frame counts, events, file names) equal, and each
    segment's clip decodes to the JAX one's (1 LSB in COLORIZE)."""
    props = jp.DiPsProperties(output=jp.OutputMode[output], window_size=1,
                              temporal_size=2)
    jj, tj = jobs(tmp_path, scene, props, batch=4,
                  record_events=lambda d: dict(dir=str(d / "rec"),
                                               pre_roll=2, post_roll=3,
                                               detector=RECORD))
    exp = japp.perform_dips(jj)
    got = tapp.perform_dips(tj)
    assert_stats_close(got, exp)
    js, ts = jj.event_segments, tj.event_segments
    assert len(ts) == len(js) == 2  # the moving square, the lighting flip
    for a, b in zip(ts, js):
        a, b = dict(a), dict(b)
        pa, pb = a.pop("path"), b.pop("path")
        assert os.path.basename(pa) == os.path.basename(pb)
        assert os.path.dirname(pa) == str(tmp_path / "t" / "rec")
        assert a == b
        clip_t = read_avi(pa)
        assert len(clip_t) == a["frames"]
        assert_maps_close(clip_t, read_avi(pb), exact=output == "ABSDIFF")
    assert_maps_close(read_avi(tj.output_path), read_avi(jj.output_path),
                      exact=output == "ABSDIFF")


@pytest.mark.parametrize("cfg,batch", [
    (dict(threshold=0.6, persist=3), 4),
    (dict(threshold=0.5, persist=2, cooldown=3), 4),
    # the re-pin would land after the clip: the default cooldown (persist
    # + 2 batches) keeps the policy from firing again meanwhile
    (dict(threshold=0.6, persist=3), 16)])
def test_auto_refresh_matches_jax(scene, tmp_path, cfg, batch):
    """The policy fires at the same frames and the stats after the
    re-capture agree: the re-pin lands on the next dispatched batch in
    both packages (the JAX run at pipeline_depth 1)."""
    props = jp.DiPsProperties()
    jj, tj = jobs(tmp_path, scene, props, batch=batch, auto_refresh=cfg)
    exp = japp.perform_dips(jj)
    got = tapp.perform_dips(tj)
    assert tj.baseline_refreshes == jj.baseline_refreshes
    assert tj.baseline_refreshes and tj.baseline_refreshes[0] >= 24
    assert_stats_close(got, exp)
    if batch == 16:
        assert len(tj.baseline_refreshes) == 1
    else:  # after the re-pin the lit scene diffs quiet again
        assert got[-1, 3] < 0.05 * H * W
    assert_maps_close(read_avi(tj.output_path), read_avi(jj.output_path),
                      exact=False)


class TimedReader:
    """A pre-opened reader of RGB frames with given timestamps: what a
    variable-frame-rate source decodes to."""

    native_rgb = False
    frame_count = -1
    last_pts = None

    def __init__(self, frames, pts, fps=10.0):
        self.frames, self.pts, self.fps = frames, pts, fps
        self.height, self.width = frames[0].shape[:2]
        self.path = "vfr://fake"
        self.closed = False

    def iter_bgr_timed(self):
        for f, p in zip(self.frames, self.pts):
            yield np.ascontiguousarray(f[..., ::-1]), p

    def close(self):
        self.closed = True


VFR_PTS = [0.0, 0.1, 0.2, 0.6, 0.7, 1.1, 1.3, 1.4, 1.41, 1.42, 1.9, 2.0]


@pytest.mark.parametrize("retime", [True, False])
def test_retime_vfr_matches_jax(tmp_path, retime):
    """A source with jittered timestamps, given to both packages as
    ``job.reader``: equal ``frame_pts``, and the same written schedule
    (gaps filled, the burst dropped) with equal frames."""
    frames = list(make_clip(n=len(VFR_PTS), h=H, w=W, seed=6))
    props = jp.DiPsProperties(window_size=1, temporal_size=1,
                              filter=jp.DiPsFilter.UNFILTERED)
    jj, tj = jobs(tmp_path, "vfr://fake", props, batch=4, retime_vfr=retime)
    jj.reader, tj.reader = TimedReader(frames, VFR_PTS), \
        TimedReader(frames, VFR_PTS)
    exp = japp.perform_dips(jj)
    got = tapp.perform_dips(tj)
    assert_stats_close(got, exp)
    assert tj.frame_pts == jj.frame_pts == pytest.approx(VFR_PTS)
    assert tj.reader.closed and jj.reader.closed
    vt, vj = read_avi(tj.output_path), read_avi(jj.output_path)
    assert_maps_close(vt, vj, exact=False)
    if retime:  # 2.0 s at 10 fps: 21 slots, each within half a frame
        assert len(vt) == 21
    else:
        assert len(vt) == len(VFR_PTS)


def test_cfr_clip_with_retime_is_identity(scene, tmp_path):
    """A constant-rate file: the retimer writes each frame once."""
    job = tapp.DiPsJob(video_path=scene, output_path=str(tmp_path / "o.avi"),
                       retime_vfr=True, batch=8, **CPU,
                       properties=tapp.DiPsProperties(temporal_size=2))
    stats = tapp.perform_dips(job)
    assert len(read_avi(tmp_path / "o.avi")) == stats.shape[0] == 32
    assert job.frame_pts[1] == pytest.approx(0.1, rel=1e-3)


def test_stream_dips_inputs_match_jax(scene):
    """``yield_inputs``: None (no callback) yields None; True yields the
    decoded RGB frames, equal to the JAX run's; a callback implies it."""
    props = jp.DiPsProperties(temporal_size=2)
    tj = tapp.DiPsJob(properties=props_from_jax(props), video_path=scene,
                      batch=4, **CPU)
    assert all(i is None for _, i, _, _ in tapp.stream_dips(tj))
    assert len(tj.frame_pts) == 32
    got = list(tapp.stream_dips(dataclasses.replace(tj, yield_inputs=True)))
    exp = list(japp.stream_dips(japp.DiPsJob(properties=props,
                                             video_path=scene, batch=4,
                                             yield_inputs=True, **JAX)))
    assert len(got) == len(exp) == 32
    for (gi, ginp, gout, gst), (ei, einp, eout, est) in zip(got, exp):
        assert gi == ei
        np.testing.assert_array_equal(ginp, einp)
        assert_maps_close(gout, eout, exact=False)
        assert_stats_close(gst[None], est[None])
    seen = []

    def cb(idx, inp, out, stats):
        seen.append(isinstance(inp, np.ndarray))
        return np.full_like(out, 7) if idx == 0 else None

    outs = [o for _, _, o, _ in tapp.stream_dips(tj.with_frame_callback(cb))]
    assert seen == [True] * 32 and (outs[0] == 7).all()


class _TrickleReader:
    """One frame; once ``go`` is set, a pause longer than the stall bound,
    then a second frame (the pause starts only after the first frame was
    consumed, however long its dispatch took)."""

    fps, width, height = 10.0, 16, 16
    frame_count, native_rgb, last_pts = -1, False, None

    def __init__(self, pause_s):
        self.pause_s = pause_s
        self.closed = False
        self.go = threading.Event()

    def iter_bgr_timed(self):
        yield np.zeros((16, 16, 3), np.uint8), 0.0
        self.go.wait(timeout=60)
        time.sleep(self.pause_s)
        yield np.full((16, 16, 3), 60, np.uint8), 0.1

    def close(self):
        self.closed = True


@pytest.mark.parametrize("app", [tapp, japp], ids=["port", "jax"])
def test_decode_stall_timeout_configurable(app):
    """``decode_stall_s`` bounds the wait for the decoder; None waits out
    a sparse live source.  The pre-opened reader is closed either way."""
    dev = CPU if app is tapp else JAX
    props = app.DiPsProperties(window_size=1, temporal_size=1)
    rd = _TrickleReader(pause_s=1.0)
    it = app.stream_dips(app.DiPsJob(properties=props, video_path="fake://",
                                     reader=rd, batch=1, decode_stall_s=0.2,
                                     **dev))
    next(it)
    rd.go.set()
    with pytest.raises(app.DecodeError if app is japp else DecodeError,
                       match="stalled"):
        for _ in it:
            pass
    assert rd.closed
    rd2 = _TrickleReader(pause_s=1.0)
    rd2.go.set()
    job = app.DiPsJob(properties=props, video_path="fake://", reader=rd2,
                      batch=1, decode_stall_s=None, **dev)
    assert [i for i, _, _, _ in app.stream_dips(job)] == [0, 1]
    assert rd2.closed and job.frame_pts == [0.0, 0.1]


class _CountingReader(TimedReader):
    def __init__(self, n):
        super().__init__(list(make_clip(n=n, h=16, w=16, seed=2)),
                         [k / 10 for k in range(n)])
        self.decoded = 0

    def iter_bgr_timed(self):
        for item in super().iter_bgr_timed():
            self.decoded += 1
            yield item


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_queue_depth_bounds_decode_ahead(depth):
    """The decoder runs at most ``max(2, queue_depth)`` batches ahead of
    the engine: with the consumer paused after its first batch, the
    queue is full and the decoder holds one more frame."""
    rd = _CountingReader(40)
    job = tapp.DiPsJob(properties=tapp.DiPsProperties(temporal_size=1),
                       video_path="fake://", reader=rd, batch=2,
                       queue_depth=depth, **CPU)
    it = tapp.stream_dips(job)
    next(it)
    ahead = 2 + max(2, depth) * 2 + 1
    deadline = time.monotonic() + 10
    while rd.decoded < ahead and time.monotonic() < deadline:
        time.sleep(0.05)
    time.sleep(0.3)  # a decoder not held by the bound would go on
    assert rd.decoded == ahead
    assert len(list(it)) == 39 and rd.closed


def test_mid_run_error_still_closes_open_segment(scene, tmp_path):
    """A run that dies while a segment is open closes its clip (it
    decodes, with the frames the manifest says) and still hands the run
    artifacts to the caller's job, in both packages alike."""
    props = jp.DiPsProperties(window_size=1, temporal_size=1,
                              filter=jp.DiPsFilter.UNFILTERED,
                              output=jp.OutputMode.ABSDIFF)
    jj, tj = jobs(tmp_path, scene, props, batch=3, record_events=lambda d:
                  dict(dir=str(d / "rec"), pre_roll=1, post_roll=50,
                       detector=RECORD))
    segs = []
    for app, job in ((japp, jj), (tapp, tj)):
        real = app.stream_dips

        def exploding(j, _real=real):
            for item in _real(j):
                yield item
                if item[0] >= 9:  # die while the segment is open
                    raise RuntimeError("synthetic decode failure")

        with mock.patch.object(app, "stream_dips", exploding):
            with pytest.raises(RuntimeError, match="synthetic"):
                app.perform_dips(job)
        assert len(job.event_segments) == 1
        seg = dict(job.event_segments[0])
        assert len(read_avi(seg.pop("path"))) == seg["frames"] >= 3
        assert job.engine is not None and len(job.frame_pts) == 10
        segs.append(seg)
    assert segs[0] == segs[1]


def test_run_artifacts_land_on_the_callers_job(scene, tmp_path):
    job = tapp.DiPsJob(properties=tapp.DiPsProperties(temporal_size=2),
                       video_path=scene, output_path=str(tmp_path / "o.avi"),
                       batch=8, profile=True, auto_refresh=dict(
                           threshold=0.6), record_events=dict(
                           dir=str(tmp_path / "rec"), detector=RECORD),
                       **CPU)
    stats = tapp.perform_dips(job)
    assert stats.shape == (32, 4)
    assert job.frame_geometry == (H, W) and job.engine.frame_index == 32
    assert len(job.frame_pts) == 32 and job.timers.frames == 32
    assert isinstance(job.baseline_refreshes, list)
    assert isinstance(job.event_segments, list)
    assert job.reader is None  # the caller's job keeps no reader


def test_error_types_raise_where_documented(scene, tmp_path):
    """OutputPathError without an output, FrameCallbackError chained from
    the callback's error, DeviceError for the default device without a
    card, and the configuration errors (before any file is written)."""
    with pytest.raises(OutputPathError, match="output path"):
        tapp.perform_dips(tapp.DiPsJob(video_path=scene, **CPU))
    with pytest.raises(VideoPathError):
        tapp.perform_dips(tapp.DiPsJob(output_path="o.avi", **CPU))

    def bad(idx, inp, out, stats):
        raise KeyError("boom")

    job = tapp.DiPsJob(properties=tapp.DiPsProperties(temporal_size=1),
                       video_path=scene, output_path=str(tmp_path / "o.avi"),
                       frame_callback=bad, batch=2, **CPU)
    with pytest.raises(FrameCallbackError, match="boom") as ei:
        tapp.perform_dips(job)
    assert isinstance(ei.value.__cause__, KeyError)
    if not torch.cuda.is_available():
        with pytest.raises(DeviceError):
            tapp.perform_dips(tapp.DiPsJob(
                video_path=scene, output_path=str(tmp_path / "d.avi")))
    so = tapp.DiPsProperties(output=OutputMode.STATS_ONLY)
    with pytest.raises(ValueError, match="record_events"):
        tapp.perform_dips(tapp.DiPsJob(properties=so, video_path=scene,
                                       record_events=dict(dir="r"), **CPU))
    for kw, msg in ((dict(auto_refresh=dict(threshold=0.5),
                          properties=tapp.DiPsProperties(
                              method=tapp.DiPsMethod.PER_FRAME)),
                     "per_frame"),
                    (dict(record_events=dict(dir=str(tmp_path / "r"),
                                             bogus=1)),
                     "unknown record_events keys"),
                    (dict(record_events=dict(
                        dir=str(tmp_path / "r2"),
                        detector=dict(on_threshold=0.01,
                                      off_threshold=0.02))),
                     "hysteresis")):
        with pytest.raises(ValueError, match=msg):
            tapp.perform_dips(tapp.DiPsJob(
                video_path=scene, output_path=str(tmp_path / "c.avi"),
                **CPU, **kw))


def test_perform_dips_reuses_caller_reader(scene, tmp_path, monkeypatch):
    """A pre-opened ``job.reader`` is consumed, never opened again."""
    import dips_tpu_torch.io.gstreamer as gst
    rd = gst.open_video(scene, "opencv")
    opens = []
    real = gst.open_video
    monkeypatch.setattr(gst, "open_video",
                        lambda p, b="auto": opens.append(p) or real(p, b))
    job = tapp.DiPsJob(video_path=scene, output_path=str(tmp_path / "o.avi"),
                       batch=8, reader=rd, **CPU)
    assert tapp.perform_dips(job).shape[0] == 32
    assert opens == []
    stats = tapp.perform_dips(dataclasses.replace(job, reader=None))
    assert stats.shape[0] == 32 and opens == [scene]


def test_video_backend_choice(scene, tmp_path):
    """``video_backend`` "opencv" runs; "gstreamer" decodes and encodes
    through the GStreamer reader and writer (the fake Gst of
    tests/test_gstreamer.py, fed the scene's frames: the same stats as
    the OpenCV run); anything else is a ValueError."""
    import dips_tpu_torch.io.gstreamer as gst
    from tests.test_gstreamer import FakeGst
    base = dict(video_path=scene, output_path=str(tmp_path / "o.avi"),
                batch=8, **CPU)
    exp = tapp.perform_dips(tapp.DiPsJob(video_backend="opencv", **base))
    assert exp.shape[0] == 32
    fake = FakeGst(scene_clip(), W, H, num=10)
    gst._set_gst_for_testing(fake)
    try:
        got = tapp.perform_dips(tapp.DiPsJob(video_backend="gstreamer",
                                             **base))
    finally:
        gst._set_gst_for_testing(None)
    np.testing.assert_array_equal(got, exp)
    assert len(fake.sinks) == 1 and len(fake.srcs[0].pushed) == 32
    with pytest.raises(ValueError, match="unknown video backend"):
        tapp.perform_dips(tapp.DiPsJob(video_backend="vlc", **base))
    got = tapp.run_dips_on_file(scene, str(tmp_path / "f.avi"),
                                video_backend="opencv", batch=8, **CPU)
    assert got.shape == (32, 4)


def test_builders_and_parity_hooks():
    job = (tapp.DiPsJob().with_video_path("a.avi").with_output_path("b.avi")
           .with_encoding("hfyu").with_video_backend("opencv")
           .with_properties(tapp.DiPsProperties(window_size=5)))
    assert (job.video_path, job.output_path, job.video_backend) == \
        ("a.avi", "b.avi", "opencv")
    assert job.encoding.name == "HFYU" and job.properties.window_size == 5
    assert job.device == "cuda" and job.queue_depth == 4
    assert job.decode_stall_s == 30.0 and job.yield_inputs is None
    assert job.decode_workers == job.pipeline_depth == 1
    tapp.init_frame_extractor()
    tapp.init_thumbnail_extractor()
    jfields = {f.name for f in dataclasses.fields(japp.DiPsJob)}
    tfields = {f.name for f in dataclasses.fields(tapp.DiPsJob)}
    # the port's fields: the reference's, backend spelled device
    assert tfields == (jfields - {"backend"}) | {"device"}
    assert ["device" if f.name == "backend" else f.name
            for f in dataclasses.fields(japp.DiPsJob)] == \
        [f.name for f in dataclasses.fields(tapp.DiPsJob)]
