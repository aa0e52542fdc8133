"""The port's GStreamer backend (``dips_tpu_torch.io.gstreamer`` and
``io/gstbind.py``) on the JAX package's own suites.

The fake-Gst suite of ``tests/test_gstreamer.py`` (its fakes imported
from there) runs on the port's module: reader caps, fps and preroll
probing, timestamps, stride-padded rows, bus errors and stalls, stream
URIs, the appsrc writer's timestamps and errors, the factories, and the
run path (``perform_dips``, ``stream_dips``, ``run_dips_on_files``,
``extract_thumbnail``) on ``device="cpu"``, each held against the JAX
package's result where both run.  Then the real-stack round trips of
``tests/test_gstreamer_real.py`` through the in-tree ctypes binding, and
clips written by either package's ``GstVideoWriter`` read back by the
other's ``GstVideoReader`` with the same frames and timestamps.

An autouse fixture resets both packages' ``_gst`` gates after each test:
the suites install fakes, and order must not matter.
"""

import os

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import dips_tpu.io.gstreamer as jgst
import dips_tpu_torch.io.gstreamer as tgst
from dips_tpu_torch.errors import DecodeError, EncodeError, VideoPathError
from tests.test_gstreamer import FakeGst, _rgb_frames

torch.set_num_threads(1)

try:
    from dips_tpu_torch.io.gstbind import load_gst
    GST = load_gst()
except Exception:  # noqa: BLE001 - any load failure = no C stack
    GST = None

real_stack = pytest.mark.skipif(GST is None,
                                reason="GStreamer C libraries not loadable")


@pytest.fixture(autouse=True)
def reset_gates():
    old = [(m._gst, m._gst_err) for m in (tgst, jgst)]
    yield
    for m, (g, e) in zip((tgst, jgst), old):
        m._gst, m._gst_err = g, e


@pytest.fixture
def fake_gst():
    def install(frames=(), w=0, h=0, pts_list=None, num=24, **kw):
        g = FakeGst(frames, w, h, pts_list, num, **kw)
        tgst._set_gst_for_testing(g)
        return g
    return install


def _file(tmp_path, name="v.avi"):
    p = tmp_path / name
    p.write_bytes(b"x")
    return str(p)


# -- reader -------------------------------------------------------------------

def test_reader_probes_geometry_before_first_read(fake_gst, tmp_path):
    frames = _rgb_frames(3, 10, 16)
    fake_gst(frames, 16, 10, num=24)
    r = tgst.GstVideoReader(_file(tmp_path))
    assert (r.width, r.height, r.fps, r.frame_count) == (16, 10, 24.0, -1)
    got = list(r)
    assert len(got) == 3
    for g, f in zip(got, frames):
        np.testing.assert_array_equal(g, f)
    r.close()


def test_reader_timestamps_and_iterators(fake_gst, tmp_path):
    """read_timed's timestamps, a missing one as None, the BGR iterators
    and the native-RGB one."""
    frames = _rgb_frames(3, 4, 8)
    fake_gst(frames, 8, 4, pts_list=[int(0.5e9), int(1.25e9), None])
    r = tgst.GstVideoReader(_file(tmp_path))
    assert r.native_rgb
    got = list(r.iter_rgb_timed())
    assert [p for _, p in got] == [0.5, 1.25, None]
    np.testing.assert_array_equal(got[0][0], frames[0])
    fake_gst(frames, 8, 4, pts_list=[int(1e8), None, None])
    r = tgst.GstVideoReader(_file(tmp_path))
    bgr = list(r.iter_bgr_timed())
    np.testing.assert_array_equal(bgr[1][0], frames[1][..., ::-1])
    assert bgr[0][1] == pytest.approx(0.1) and bgr[1][1] is None
    fake_gst(frames, 8, 4)
    r = tgst.GstVideoReader(_file(tmp_path))
    np.testing.assert_array_equal(next(r.iter_bgr()), frames[0][..., ::-1])
    assert r.read_timed()[1] is None  # CLOCK_TIME_NONE: unknown


def test_reader_unavailable_gate(tmp_path):
    tgst._set_gst_for_testing(None)
    with pytest.raises(DecodeError, match="GStreamer unavailable"):
        tgst.GstVideoReader(_file(tmp_path))
    with pytest.raises(EncodeError, match="GStreamer unavailable"):
        tgst.GstVideoWriter(str(tmp_path / "o.avi"), 10, 8, 4)
    assert not tgst.available()


def test_reader_handles_stride_padded_rows(fake_gst, tmp_path):
    frames = _rgb_frames(2, 6, 9)  # 27 bytes a row -> stride 28
    fake_gst(frames, 9, 6, row_pad=1)
    r = tgst.GstVideoReader(_file(tmp_path))
    for got, exp in zip(iter(r), frames):
        np.testing.assert_array_equal(got, exp)


def test_reader_raises_on_pipeline_error_and_stall(fake_gst, tmp_path):
    fake_gst((), 0, 0, bus_error=True)
    with pytest.raises(DecodeError, match="pipeline error|probe"):
        tgst.GstVideoReader(_file(tmp_path, "bad.avi"))
    frames = _rgb_frames(1, 4, 8)
    fake_gst(frames, 8, 4, stalled=True)
    r = tgst.GstVideoReader("rtsp://cam/live")
    np.testing.assert_array_equal(r.read(), frames[0])
    with pytest.raises(DecodeError, match="stalled"):
        r.read()
    fake_gst(frames, 8, 4)  # a drained file ends cleanly
    r = tgst.GstVideoReader(_file(tmp_path))
    assert r.read() is not None and r.read() is None


def test_paths_are_properties_and_uris_route_by_scheme(fake_gst, tmp_path):
    frames = _rgb_frames(1, 4, 8)
    g = fake_gst(frames, 8, 4)
    evil = _file(tmp_path, 'clip " ! fakesink x=.avi')
    tgst.GstVideoReader(evil).close()
    assert evil not in g.launches[0] and "filesrc" in g.launches[0]
    w = tgst.GstVideoWriter(str(tmp_path / 'out " pwn.avi'), 29.97, 8, 4)
    assert "pwn" not in g.launches[1]
    assert "framerate=2997/100" in g.launches[1]
    w.close()
    uri = 'rtsp://cam.local:8554/stream " ! fakesink'
    r = tgst.GstVideoReader(uri)
    assert "uridecodebin" in g.launches[2] and "drop=true" in g.launches[2]
    assert r._pipeline.get_by_name("src").props["uri"] == uri
    r.close()
    tgst.GstVideoReader("file:///data/clip.mp4").close()
    assert "drop=false" in g.launches[3]


def test_uri_helpers_match_jax():
    assert tgst.STREAM_SCHEMES == jgst.STREAM_SCHEMES
    assert tgst.LIVE_SCHEMES == jgst.LIVE_SCHEMES
    for u in ("rtsp://h/s", "RTSP://h/s", "srt://h:1", "udp://0:5000",
              "http://h/a.m3u8", "File:///x.avi", "/data/x.avi", "x.avi",
              "rtsp:/x", "httpx://h"):
        assert tgst.is_stream_uri(u) == jgst.is_stream_uri(u), u
        assert tgst.is_live_uri(u) == jgst.is_live_uri(u), u


# -- writer -------------------------------------------------------------------

def test_writer_propagates_pts_and_duration(fake_gst, tmp_path):
    g = fake_gst()
    w = tgst.GstVideoWriter(str(tmp_path / "o.avi"), 10.0, 8, 4)
    frames = _rgb_frames(3, 4, 8)
    w.write(frames[0])
    w.write(frames[1], pts=0.7, duration=0.3)
    w.write(frames[2])
    w.write(np.full((4, 8, 1), 7, np.uint8))  # one plane: broadcast
    w.close()
    src = g.srcs[0]
    assert src.eos and len(src.pushed) == 4
    assert [b.pts for b in src.pushed] == [0, int(0.7e9), int(0.2e9),
                                           int(0.3e9)]
    assert src.pushed[1].duration == int(0.3e9)
    np.testing.assert_array_equal(
        np.frombuffer(src.pushed[0].data, np.uint8).reshape(4, 8, 3),
        frames[0])
    assert (np.frombuffer(src.pushed[3].data, np.uint8) == 7).all()
    assert "avimux" in g.launches[0]


def test_writer_surfaces_encode_errors(fake_gst, tmp_path):
    fake_gst(src_flow="FLUSHING")
    w = tgst.GstVideoWriter(str(tmp_path / "o.avi"), 10, 8, 4)
    with pytest.raises(EncodeError, match="push-buffer"):
        w.write(np.zeros((4, 8, 3), np.uint8))
    fake_gst(writer_error=True)
    w = tgst.GstVideoWriter(str(tmp_path / "o2.avi"), 10, 8, 4)
    w.write(np.zeros((4, 8, 3), np.uint8))
    with pytest.raises(EncodeError, match="encode failed"):
        w.close()


# -- factories and the run path ----------------------------------------------

def test_factories(fake_gst, tmp_path, monkeypatch):
    """"gstreamer" opens the GStreamer reader and writer; "auto" reads
    through GStreamer when it is available (a PyGObject-like fake) and
    writes through OpenCV; anything else is a ValueError."""
    from dips_tpu_torch.io.video import VideoWriter
    from dips_tpu_torch.properties import Encoding
    fake_gst(_rgb_frames(1, 4, 8), 8, 4)
    p = _file(tmp_path)
    assert isinstance(tgst.open_video(p, "gstreamer"), tgst.GstVideoReader)
    assert tgst.available()
    assert isinstance(tgst.open_video(p, "auto"), tgst.GstVideoReader)
    with pytest.raises(ValueError, match="unknown video backend"):
        tgst.open_video(p, "nope")
    w = tgst.open_writer(str(tmp_path / "a.avi"), 10, 8, 4, Encoding.MJPG,
                         "gstreamer")
    assert isinstance(w, tgst.GstVideoWriter)
    w.close()
    w = tgst.open_writer(str(tmp_path / "b.avi"), 10, 8, 4, Encoding.MJPG,
                         "auto")
    assert isinstance(w, VideoWriter)
    w.close()


@pytest.mark.parametrize("layout", ["hwc", "planar"])
def test_perform_dips_matches_jax_through_the_fake(fake_gst, tmp_path,
                                                   layout):
    """perform_dips with video_backend="gstreamer" in both packages, on
    the same fake frames: the same stats, and the same bytes pushed into
    the writer with the same timestamps (the RGB reader takes the "hwc"
    layout without a swap: a swap would change every map)."""
    from dips_tpu.app import DiPsJob as JJob, perform_dips as jperform
    from dips_tpu.properties import DiPsProperties as JProps
    from dips_tpu_torch.app import DiPsJob, perform_dips
    from dips_tpu_torch.convert import props_from_jax
    h, w = 8, 16
    frames = _rgb_frames(7, h, w, seed=7)
    pts = [int(k * 0.07e9) for k in range(7)]
    props = JProps(window_size=1, temporal_size=1)
    pushed, stats = {}, {}
    for pkg in ("t", "j"):
        g = FakeGst(frames, w, h, pts_list=pts, num=20)
        (tgst if pkg == "t" else jgst)._set_gst_for_testing(g)
        kw = dict(video_path=_file(tmp_path, f"in_{pkg}.avi"),
                  output_path=str(tmp_path / f"out_{pkg}.avi"), batch=3,
                  video_backend="gstreamer", input_layout=layout,
                  retime_vfr=True)
        if pkg == "t":
            stats[pkg] = perform_dips(DiPsJob(
                properties=props_from_jax(props), device="cpu",
                pipeline_depth=2, **kw))
        else:
            stats[pkg] = jperform(JJob(properties=props, backend="pallas",
                                       **kw))
        pushed[pkg] = [(bytes(b.data), b.pts) for b in g.srcs[0].pushed]
    assert len(pushed["t"]) == 7 and pushed["t"] == pushed["j"]
    assert [p for _, p in pushed["t"]] == pts
    np.testing.assert_allclose(stats["t"], stats["j"], rtol=0, atol=1e-6)


def test_run_dips_on_files_through_the_fake(fake_gst, tmp_path):
    """The fleet run opens GStreamer readers and writers for each input."""
    from dips_tpu_torch.app import run_dips_on_files
    from dips_tpu_torch.properties import DiPsProperties
    g = fake_gst(_rgb_frames(4, 8, 16, seed=11), 16, 8, num=20)
    paths = [_file(tmp_path, n) for n in ("a.avi", "b.avi")]
    counts = run_dips_on_files(
        paths, str(tmp_path / "out"), device="cpu", batch=2,
        properties=DiPsProperties(window_size=1, temporal_size=1),
        video_backend="gstreamer")
    assert list(counts) == [4, 4]
    assert len(g.sinks) == 2 and len(g.srcs) == 2
    assert all(len(src.pushed) == 4 and src.eos for src in g.srcs)


def test_thumbnail_through_gstreamer_and_uri(fake_gst, tmp_path):
    from dips_tpu_torch.io.thumbnail import extract_thumbnail
    fake_gst(_rgb_frames(1, 40, 60, seed=3), 60, 40)
    out = str(tmp_path / "t.png")
    thumb = extract_thumbnail("rtsp://cam.local/stream", out, height=20)
    assert thumb.shape == (20, 30, 3) and os.path.exists(out)


# -- the real stack ------------------------------------------------------------

def _frames(n=8, h=48, w=64):
    """Smooth gradient frames (theora-friendly) with per-frame motion."""
    out = []
    for i in range(n):
        y, x = np.mgrid[0:h, 0:w]
        out.append(np.stack([(x * 3 + i * 17) % 256, (y * 4) % 256,
                             np.full((h, w), 60 + i * 9)],
                            -1).astype(np.uint8))
    return out


@pytest.fixture
def real_gst():
    for m in (tgst, jgst):
        m._gst, m._gst_err = GST, None


def _write(mod, path, frames, fps=10.0):
    w = mod.GstVideoWriter(path, fps=fps, width=frames[0].shape[1],
                           height=frames[0].shape[0])
    for i, f in enumerate(frames):
        w.write(f, pts=i / fps)
    w.close()
    return w


def _read(mod, path):
    rd = mod.GstVideoReader(path)
    geo = (rd.width, rd.height, rd.fps)
    got = []
    while (r := rd.read_timed()) is not None:
        got.append(r)
    rd.close()
    return geo, got


@real_stack
def test_registry_probe_matches_jax(real_gst):
    from dips_tpu.io.gstbind import load_gst as jload
    jg = jload()
    assert GST.version == jg.version and GST.version.startswith(
        "GStreamer 1.")
    for e in ("appsink", "videotestsrc", "avimux", "theoraenc",
              "definitely_not_an_element_xyz"):
        assert GST.element_available(e) == jg.element_available(e), e


@real_stack
def test_real_round_trip(real_gst, tmp_path):
    """appsrc encode -> file -> decodebin decode: geometry and fps from
    the real preroll caps, exact timestamps, close pixels (theora)."""
    path = str(tmp_path / "rt.ogv")
    frames = _frames(10)
    w = _write(tgst, path, frames)
    if not GST.element_available("avimux"):
        assert w.fallback_used == "theora+ogg"
    assert w.frames_written == 10 and os.path.getsize(path) > 0
    geo, got = _read(tgst, path)
    assert geo == (64, 48, pytest.approx(10.0)) and len(got) == 10
    assert [p for _, p in got] == pytest.approx(
        [i / 10.0 for i in range(10)], abs=1e-6)
    err = np.abs(got[0][0].astype(int) - frames[0].astype(int)).mean()
    assert err < 12


@real_stack
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_clips_cross_the_packages(real_gst, tmp_path, writer):
    """A clip written by either package's GstVideoWriter reads back
    through both packages' GstVideoReader with the same frames and
    timestamps."""
    path = str(tmp_path / f"{writer}.ogv")
    _write(tgst if writer == "port" else jgst, path, _frames(9))
    (tgeo, tgot), (jgeo, jgot) = _read(tgst, path), _read(jgst, path)
    assert tgeo == jgeo and len(tgot) == len(jgot) == 9
    assert [p for _, p in tgot] == [p for _, p in jgot]
    for (a, _), (b, _) in zip(tgot, jgot):
        np.testing.assert_array_equal(a, b)
    # the two writers write the same file
    other = str(tmp_path / "other.ogv")
    _write(jgst if writer == "port" else tgst, other, _frames(9))
    _, ogot = _read(tgst, other)
    for (a, pa), (b, pb) in zip(tgot, ogot):
        np.testing.assert_array_equal(a, b)
        assert pa == pb


@real_stack
def test_real_reader_missing_and_corrupt_files(real_gst, tmp_path):
    with pytest.raises(VideoPathError):
        tgst.GstVideoReader(str(tmp_path / "nope.ogv"))
    junk = tmp_path / "junk.ogv"
    junk.write_bytes(b"this is not a media file" * 64)
    with pytest.raises(DecodeError):
        tgst.GstVideoReader(str(junk))


@real_stack
def test_auto_stays_opencv_without_optin(real_gst, tmp_path, monkeypatch):
    """The ctypes binding is explicit-only: "auto" keeps OpenCV unless
    DIPS_GST_CTYPES=1, in both packages."""
    import cv2
    from dips_tpu_torch.io.video import VideoReader
    monkeypatch.delenv("DIPS_GST_CTYPES", raising=False)
    assert not tgst.available() and not jgst.available()
    p = str(tmp_path / "a.avi")
    wr = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"MJPG"), 10, (32, 16))
    for f in _frames(3, 16, 32):
        wr.write(f[:, :, ::-1])
    wr.release()
    r = tgst.open_video(p, "auto")
    assert isinstance(r, VideoReader)
    r.close()
    monkeypatch.setenv("DIPS_GST_CTYPES", "1")
    assert tgst.available() and jgst.available()


@real_stack
def test_perform_dips_on_the_real_stack_matches_jax(real_gst, tmp_path):
    """Real GStreamer in and out on both packages: the same stats, and
    diff videos that decode back to the same frames and timestamps."""
    from dips_tpu.app import DiPsJob as JJob, perform_dips as jperform
    from dips_tpu.properties import DiPsProperties as JProps
    from dips_tpu_torch.app import DiPsJob, perform_dips
    from dips_tpu_torch.convert import props_from_jax
    src = str(tmp_path / "in.ogv")
    _write(tgst, src, _frames(8))
    props = JProps(temporal_size=2)
    kw = dict(video_path=src, batch=4, video_backend="gstreamer")
    got = perform_dips(DiPsJob(properties=props_from_jax(props),
                               output_path=str(tmp_path / "t.ogv"),
                               device="cpu", decode_workers=3,
                               pipeline_depth=2, **kw))
    exp = jperform(JJob(properties=props, output_path=str(tmp_path / "j.ogv"),
                        backend="pallas", **kw))
    np.testing.assert_array_equal(got[:, 2:], exp[:, 2:])
    np.testing.assert_allclose(got[:, :2], exp[:, :2], rtol=0, atol=1e-6)
    (_, tgot), (_, jgot) = (_read(tgst, str(tmp_path / "t.ogv")),
                            _read(tgst, str(tmp_path / "j.ogv")))
    assert len(tgot) == len(jgot) == 8
    for (a, pa), (b, pb) in zip(tgot, jgot):
        assert pa == pb
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
