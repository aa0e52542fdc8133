"""The port's host media modules against the JAX package's.

``dips_tpu_torch.io`` (reader and writer, ``CfrRetimer``, backend choice,
thumbnails, raw ``Dat_N.d`` dumps, subsampling, synthetic clips, the event
recorder) and ``utils/indexing.py``, each held against its ``dips_tpu``
counterpart on the same inputs made with numpy from a seed.  Lossless
(HFYU) clips are compared byte for byte; the recorder's segments, frames
and clip paths must be equal.
"""

import os

import cv2
import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest

import dips_tpu.io as jio
import dips_tpu.io.datfiles as jdat
import dips_tpu.io.eventrecorder as jrec
import dips_tpu.io.gstreamer as jgst
import dips_tpu.io.video as jvideo
import dips_tpu.ops.events as jevents
import dips_tpu.properties as jprops
import dips_tpu.utils.indexing as jidx
import dips_tpu_torch.io as tio
import dips_tpu_torch.io.datfiles as tdat
import dips_tpu_torch.io.eventrecorder as trec
import dips_tpu_torch.io.gstreamer as tgst
import dips_tpu_torch.io.video as tvideo
import dips_tpu_torch.ops.events as tevents
import dips_tpu_torch.properties as tprops
import dips_tpu_torch.utils.indexing as tidx
from dips_tpu_torch.errors import DecodeError, EncodeError, VideoPathError
from tests.conftest import make_clip

H, W = 24, 40


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A lossless 12-frame clip at 15 fps and its RGB frames."""
    frames = make_clip(n=12, h=H, w=W, seed=4)
    path = str(tmp_path_factory.mktemp("io") / "in.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"HFYU"), 15, (W, H))
    for f in frames:
        vw.write(f[..., ::-1])
    vw.release()
    return path, frames


def test_reader_matches_jax(clip):
    """Geometry, frame count, RGB ``read`` / iteration, BGR iteration and
    the per-frame timestamps equal the JAX reader's."""
    path, frames = clip
    with tvideo.VideoReader(path) as t, jvideo.VideoReader(path) as j:
        for a in ("fps", "width", "height", "frame_count"):
            assert getattr(t, a) == getattr(j, a), a
        assert t.frame_count == 12
        tr = [t.read_timed() for _ in range(4)]
        jr = [j.read_timed() for _ in range(4)]
        for (tf, tp), (jf, jp) in zip(tr, jr):
            np.testing.assert_array_equal(tf, jf)
            assert tp == jp
        np.testing.assert_array_equal(tr[0][0], frames[0])
        assert t.last_pts == j.last_pts == pytest.approx(3 / 15, rel=1e-3)
        tb = list(t.iter_bgr_timed())
        jb = list(j.iter_bgr_timed())
        assert len(tb) == len(jb) == 8
        for (tf, tp), (jf, jp) in zip(tb, jb):
            np.testing.assert_array_equal(tf, jf)
            assert tp == jp
        np.testing.assert_array_equal(tb[0][0], frames[4][..., ::-1])
        assert t.read() is None and t.read_timed() is None
    with tvideo.VideoReader(path) as t:
        t.seek_frame(5)
        np.testing.assert_array_equal(t.read(), frames[5])
        rest = list(t)
        assert len(rest) == 6
        np.testing.assert_array_equal(rest[-1], frames[-1])


def test_reader_errors_and_stream_uris(tmp_path):
    with pytest.raises(VideoPathError):
        tvideo.VideoReader(str(tmp_path / "nope.avi"))
    for uri in ("rtsp://cam/1", "SRT://x", "file:///tmp/a.avi",
                "https://h/live.m3u8", "/tmp/a.avi", "cam.avi"):
        assert tgst.is_stream_uri(uri) == jgst.is_stream_uri(uri)
    assert tgst.STREAM_SCHEMES == jgst.STREAM_SCHEMES
    # a stream URI is not held to the file system: OpenCV gets to try it
    with pytest.raises(DecodeError):
        tvideo.VideoReader("file:///nonexistent/x.avi")


def test_writer_counts_and_bgr(tmp_path, clip):
    """``write`` takes RGB, ``write_bgr`` BGR; both count frames, and the
    written file decodes to the frames given."""
    _, frames = clip
    p = str(tmp_path / "o.avi")
    with tvideo.VideoWriter(p, 10, W, H, tprops.Encoding.HFYU) as wr:
        wr.write(frames[0])
        wr.write_bgr(np.ascontiguousarray(frames[1][..., ::-1]))
        wr.write(frames[2][..., :1])  # one channel -> gray
        assert wr.frames_written == 3 and wr.path == p
        assert wr.fallback_used is None
    with tvideo.VideoReader(p) as r:
        got = list(r)
    np.testing.assert_array_equal(got[0], frames[0])
    np.testing.assert_array_equal(got[1], frames[1])
    assert (got[2] == frames[2][..., :1]).all()
    with pytest.raises(EncodeError):
        tvideo.VideoWriter(str(tmp_path / "no" / "o.avi"), 10, W, H)


def test_writer_fallback(tmp_path):
    """An encoder OpenCV lacks (H264 in this image) falls back to MJPG and
    says so on the writer, as the JAX writer does."""
    w = tvideo.VideoWriter(str(tmp_path / "o.avi"), 10, 64, 48,
                           tprops.Encoding.H264)
    with pytest.warns(RuntimeWarning):
        jw = jvideo.VideoWriter(str(tmp_path / "j.avi"), 10, 64, 48,
                                jprops.Encoding.H264)
    assert w.fallback_used == jw.fallback_used
    w.write(np.zeros((48, 64, 3), np.uint8))
    w.close()
    jw.close()
    assert os.path.getsize(tmp_path / "o.avi") > 0


def test_open_camera_missing_raises():
    with pytest.raises(DecodeError, match="camera"):
        tvideo.open_camera(97)


@pytest.mark.parametrize("backend,exc", [
    ("auto", None), ("opencv", None),
    # (the id dates from before the GStreamer backend was ported)
    pytest.param("gstreamer", "gst", id="gstreamer-NotImplementedError"),
    ("bogus", ValueError)])
def test_backend_choice(clip, tmp_path, backend, exc):
    """"auto" / "opencv" give the OpenCV reader and writer (auto without
    an auto-selectable GStreamer); "gstreamer" gives the GStreamer reader
    and writer (here over the fake Gst of tests/test_gstreamer.py);
    anything else is a ValueError, as in the JAX factory."""
    from tests.test_gstreamer import FakeGst
    path, frames = clip
    out = str(tmp_path / "o.avi")
    if exc == "gst":
        fake = FakeGst(list(frames), W, H, num=15)
        tgst._set_gst_for_testing(fake)
        try:
            with tgst.open_video(path, backend) as r:
                assert isinstance(r, tgst.GstVideoReader)
                np.testing.assert_array_equal(r.read(), frames[0])
            with tgst.open_writer(out, 10, W, H, tprops.Encoding.MJPG,
                                  backend) as wr:
                assert isinstance(wr, tgst.GstVideoWriter)
                wr.write(frames[1])
        finally:
            tgst._set_gst_for_testing(None)
        assert fake.srcs[0].eos and len(fake.srcs[0].pushed) == 1
        return
    if exc is None:
        with tgst.open_video(path, backend) as r:
            assert isinstance(r, tvideo.VideoReader) and r.read() is not None
        with tgst.open_writer(out, 10, W, H, tprops.Encoding.MJPG,
                              backend) as wr:
            assert isinstance(wr, tvideo.VideoWriter)
        return
    with pytest.raises(exc):
        tgst.open_video(path, backend)
    with pytest.raises(exc):
        tgst.open_writer(out, 10, W, H, tprops.Encoding.MJPG, backend)
    if exc is ValueError:
        with pytest.raises(ValueError):
            jgst.open_video(path, backend)
        with pytest.raises(ValueError):
            jgst.open_writer(out, 10, W, H, jprops.Encoding.MJPG, backend)


def _tags(n):
    return [np.full((2, 2, 3), i, np.uint8) for i in range(n)]


_RNG_PTS = list(np.concatenate(
    [[0.0], np.cumsum(np.random.default_rng(0).uniform(0.01, 0.2, 40))]))


@pytest.mark.parametrize("pts,fps", [
    ([i / 25.0 for i in range(10)], 25.0),    # CFR: one write a frame
    ([0.0, 0.1, 0.5], 10.0),                  # a gap holds the last frame
    ([0.0, 0.01, 0.02, 0.1], 10.0),           # a burst drops
    (_RNG_PTS, 12.0),                          # random VFR
    ([None, None, None], 30.0),               # no pts: 1:1
    ([5.0, 5.1, 5.2], 10.0),                  # a start offset pads nothing
], ids=["cfr", "gap", "burst", "random", "no_pts", "offset"])
def test_retimer_matches_jax(pts, fps):
    """The cases of ``tests/test_vfr.py`` through both retimers: the same
    schedule of frames."""
    frames = _tags(len(pts))
    got = list(tvideo.retime_cfr(zip(frames, pts), fps))
    exp = list(jvideo.retime_cfr(zip(frames, pts), fps))
    assert [int(f[0, 0, 0]) for f in got] == [int(f[0, 0, 0]) for f in exp]
    if pts == _RNG_PTS:
        assert abs(len(got) - round(pts[-1] * fps)) <= 1
    r = tvideo.CfrRetimer(fps)
    for f, p in zip(frames, pts):
        r.feed(f, p)
    assert r.written == len(exp)


def test_dat_files_match_jax(tmp_path):
    """Dump listing (numeric sort, non-'D' and non-dump files skipped)
    and RGBA -> RGB decoding equal the JAX module's."""
    w, h = 7, 5
    rng = np.random.default_rng(2)
    for n in ("Dat_2.d", "Dat_10.d", "Dat_1.d"):
        rgba = rng.integers(0, 256, (h, w, 4), np.uint8)
        np.concatenate([np.zeros(tdat.HEADER_BYTES, np.uint8),
                        rgba.ravel()]).tofile(tmp_path / n)
    (tmp_path / "skip.txt").write_text("x")
    (tmp_path / "DESIGN.md").write_text("not a dump")
    os.mkdir(tmp_path / "Dir_3")
    assert tdat.list_dat_files(str(tmp_path)) == \
        jdat.list_dat_files(str(tmp_path))
    got = list(tdat.read_dat_dir(str(tmp_path), w, h))
    exp = list(jdat.read_dat_dir(str(tmp_path), w, h))
    assert len(got) == len(exp) == 3
    for a, b in zip(got, exp):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(DecodeError):
        tdat.read_dat_frame(str(tmp_path / "DESIGN.md"), w, h)
    assert (tdat.DEFAULT_WIDTH, tdat.DEFAULT_HEIGHT) == (273, 640)


def test_subsample_matches_jax(clip, tmp_path):
    path, _ = clip
    t, j = str(tmp_path / "t.avi"), str(tmp_path / "j.avi")
    assert tio.subsample_video(path, t, keep_every=3,
                               target_seconds=2.0,
                               encoding=tprops.Encoding.HFYU) == 4
    assert jio.subsample_video(path, j, keep_every=3, target_seconds=2.0,
                               encoding=jprops.Encoding.HFYU) == 4
    with tvideo.VideoReader(t) as a, jvideo.VideoReader(j) as b:
        assert a.fps == b.fps == 2.0
        np.testing.assert_array_equal(np.stack(list(a)), np.stack(list(b)))
    for kw in (dict(keep_every=0), dict(target_seconds=0)):
        with pytest.raises(ValueError):
            tio.subsample_video(path, t, **kw)


def test_thumbnail_matches_jax(clip, tmp_path):
    path, _ = clip
    got = tio.extract_thumbnail(path, str(tmp_path / "t.png"), height=12)
    exp = jio.extract_thumbnail(path, str(tmp_path / "j.png"), height=12)
    np.testing.assert_array_equal(got, exp)
    assert got.shape == (12, 20, 3)
    up = tio.extract_thumbnail(path, str(tmp_path / "u.png"))  # enlarges
    assert up.shape == (240, 400, 3)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "t.png")),
                                  cv2.imread(str(tmp_path / "j.png")))
    with pytest.raises(EncodeError):
        tio.extract_thumbnail(path, str(tmp_path / "t.unknownext"))
    with pytest.raises(VideoPathError):
        tio.extract_thumbnail(str(tmp_path / "none.avi"),
                              str(tmp_path / "n.png"))


def test_synthetic_matches_jax(tmp_path):
    a = tio.moving_square_clip(n=5, height=20, width=30, seed=3)
    b = jio.moving_square_clip(n=5, height=20, width=30, seed=3)
    np.testing.assert_array_equal(a, b)
    p = tio.write_clip(a, str(tmp_path / "c.avi"), fps=12,
                       encoding=tprops.Encoding.HFYU)
    with tvideo.VideoReader(p) as r:
        np.testing.assert_array_equal(np.stack(list(r)), a)


def test_indexing_matches_jax():
    t, j = tidx.UCircularIndex(7, 5), jidx.UCircularIndex(7, 5)
    for step in (1, 4, 9, 0, 3):
        t += step
        j += step
        assert int(t) == int(j) and repr(t) == repr(j)
    assert t == int(j) and t == tidx.UCircularIndex(int(j), 5)
    assert [0, 1, 2, 3, 4][t] == [0, 1, 2, 3, 4][j]
    with pytest.raises(ValueError):
        tidx.UCircularIndex(0, 0)


class _Writer:
    def __init__(self, log, idx, start):
        self.log, self.idx, self.start = log, idx, start
        self.frames = []
        self.closed = False
        self.path = f"seg{idx}"

    def write(self, f):
        assert not self.closed
        self.frames.append(int(f))

    def close(self):
        self.closed = True
        self.log.append((self.idx, self.start, self.frames))


def _record(mod, detector, series, pre, post, final=None, edge=None):
    """One recorder of ``mod`` over a series of mean-|diff| values (or,
    ``edge``, (open_now, closed) annotations): the segments and each
    closed writer's (index, start, frames)."""
    log = []
    rec = mod.EventRecorder(detector, lambda i, s: _Writer(log, i, s),
                            pre_roll=pre, post_roll=post)
    if edge is not None:
        for i, (open_now, closed) in enumerate(edge):
            rec.feed_annotated(np.int64(i), open_now, closed, i)
    else:
        for i, v in enumerate(series):
            row = np.zeros(4, np.float32)
            row[1] = v
            rec.feed(np.int64(i), row, i)
    return rec.finish(final_events=final), log


_EV = {"start_frame": 5, "end_frame": 6, "frames": 2, "peak": 9.0,
       "peak_frame": 5, "mean": 9.0}


@pytest.mark.parametrize("series,pre,post,det", [
    ([0] * 5 + [20] * 3 + [0] * 6, 2, 2, {}),           # pre / post roll
    ([0] * 3 + [20] + [0, 0] + [20] + [0] * 8, 1, 3, {}),  # merged burst
    ([0] * 3 + [20] + [0] * 8 + [20] + [0] * 8, 1, 2, {}),  # two clips
    ([0] * 3 + [20, 20], 1, 5, {}),                     # open at EOS
    ([20, 20] + [0] * 5, 0, 1, {}),                     # no pre-roll
    ([0] * 20, 30, 30, {}),                             # idle
    (list(np.random.default_rng(5).random(60) * 30), 3, 2,
     dict(min_frames=2, cooldown=1)),                   # noise
], ids=["rolls", "merge", "separate", "eos", "zero_pre", "idle", "noise"])
def test_event_recorder_matches_jax(series, pre, post, det):
    """The cases of ``tests/test_eventrecorder.py`` through both
    recorders with their own detectors: equal segments and clips."""
    got = _record(trec, tevents.MotionDetector(on_threshold=10, **det),
                  series, pre, post)
    exp = _record(jrec, jevents.MotionDetector(on_threshold=10, **det),
                  series, pre, post)
    assert got == exp


@pytest.mark.parametrize("edge,final,pre,post", [
    ([(False, [])] * 4 + [(False, [_EV])] + [(False, [])] * 3, None, 4, 1),
    ([(False, [])] * 6, [_EV], 3, 2),
    ([(False, []), (True, [])], [_EV], 1, 5),
], ids=["closed_in_batch", "eos_ring", "open_at_eos"])
def test_edge_recording_matches_jax(edge, final, pre, post):
    """The recorder driven by annotations (no detector), as a camera
    client records from a serving daemon's replies."""
    got = _record(trec, None, None, pre, post, final=final, edge=edge)
    exp = _record(jrec, None, None, pre, post, final=final, edge=edge)
    assert got == exp and got[0]
    with pytest.raises(ValueError, match="feed_annotated"):
        trec.EventRecorder(None, lambda i, s: None).feed(
            np.int64(0), np.zeros(4, np.float32), 0)
