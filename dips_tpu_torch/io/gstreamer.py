"""Optional GStreamer media backend (parity with the reference's primary
media layer, dips/src/frame_extractor.rs:38-290).

The reference builds ``filesrc -> decodebin -> queue -> videoconvert ->
videoscale -> appsink(RGBA, sync=false)`` for ingest and ``appsrc ->
videoconvert -> avimux -> filesink`` for egress with PTS/duration
propagation (frame_extractor.rs:151-183, 242-262); this backend mirrors
both via PyGObject when present, and falls back to the in-tree ctypes
binding (:mod:`.gstbind`) when the C libraries exist without ``gi`` —
this image's exact situation, so ``--video-backend gstreamer`` runs the
REAL stack here.  Everything stays gated: :func:`available` reports the
backend state, and the classes raise ``DecodeError`` / ``EncodeError``
with a clear message when the stack is missing entirely.

Backend selection nuance: ``available()`` (what ``open_video('auto')``
consults) is true for PyGObject installs but treats the ctypes binding
as EXPLICIT-ONLY by default (opt in to auto with ``DIPS_GST_CTYPES=1``):
this image ships only the base plugin set (no avidemux/qtdemux/jpeg), so
auto-routing every local .avi through GStreamer would break decodes that
OpenCV handles fine.  An explicit ``backend="gstreamer"`` always uses
whichever binding loads.

The OpenCV backend (io/video.py) is the default either way; tests
exercise these code paths through a fake-Gst shim
(:func:`_set_gst_for_testing`) plus a real-stack suite
(tests/test_gstreamer_real.py) that runs whenever the C libraries load.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from ..errors import DecodeError, EncodeError, VideoPathError

_gst = None
_gst_err: Optional[str] = None


def _load():
    global _gst, _gst_err
    if _gst is not None or _gst_err is not None:
        return _gst
    try:
        import gi
        gi.require_version("Gst", "1.0")
        gi.require_version("GstApp", "1.0")
        from gi.repository import Gst, GstApp  # noqa: F401
        Gst.init(None)
        _gst = Gst
        return _gst
    except Exception as e:  # ImportError, ValueError from require_version
        gi_err = e
    try:
        # no PyGObject: bind the C libraries directly (gstbind.py) — the
        # real stack, same facade surface
        from .gstbind import load_gst
        _gst = load_gst()
    except Exception as e2:
        _gst_err = (f"GStreamer unavailable: gi: {gi_err}; "
                    f"ctypes: {e2}")
    return _gst


def _set_gst_for_testing(fake) -> None:
    """Install a fake Gst module (or None to reset the gate) so the reader/
    writer code paths run in CI without the real stack."""
    global _gst, _gst_err
    _gst = fake
    _gst_err = None if fake is not None else "GStreamer unavailable: reset"


def _is_ctypes_backend() -> bool:
    return getattr(_gst, "BINDING", None) == "ctypes"


def available() -> bool:
    """True when the GStreamer backend should be AUTO-selected: PyGObject
    installs always; the ctypes binding only with ``DIPS_GST_CTYPES=1``
    (explicit ``backend="gstreamer"`` bypasses this gate — see the module
    docstring for why auto keeps OpenCV on base-plugin-only images)."""
    import os
    if _load() is None:
        return False
    if _is_ctypes_backend() and os.environ.get(
            "DIPS_GST_CTYPES", "0") in ("", "0"):
        return False
    return True


#: URI schemes routed through ``uridecodebin`` — network cameras / streams
#: (rtsp, srt, udp/rtp, http(s) e.g. HLS) plus explicit file:// URIs.
STREAM_SCHEMES = ("rtsp://", "rtsps://", "rtp://", "udp://", "srt://",
                  "rtmp://", "http://", "https://", "file://")
#: schemes whose sources are LIVE (sender-paced): a slow consumer must
#: drop stale frames rather than stall the sender.  Non-live URIs
#: (file://, http(s) progressive/HLS VOD) keep every frame — decode
#: blocks on the appsink queue instead (same as local files).
LIVE_SCHEMES = ("rtsp://", "rtsps://", "rtp://", "udp://", "srt://",
                "rtmp://")


def is_stream_uri(path: str) -> bool:
    """True when ``path`` is a media URI rather than a local file path
    (schemes are case-insensitive, RFC 3986)."""
    return path.lower().startswith(STREAM_SCHEMES)


def is_live_uri(path: str) -> bool:
    """True for sender-paced (live) sources — see LIVE_SCHEMES."""
    return path.lower().startswith(LIVE_SCHEMES)


def _parse_fps(caps_struct) -> Optional[float]:
    """framerate fraction from a caps structure; PyGObject returns
    (ok, numerator, denominator)."""
    try:
        res = caps_struct.get_fraction("framerate")
    except Exception:
        return None
    try:
        ok, num, den = res
    except (TypeError, ValueError):
        return None
    if ok and den:
        return num / den
    return None


class GstVideoReader:
    """RGB uint8 frame iterator over a GStreamer decode graph.

    Interface-compatible with io.video.VideoReader (fps/width/height/read/
    iteration/close) so the application layer can swap backends; geometry
    and fps are probed from the preroll sample at construction, BEFORE the
    first ``read()`` (the app layer sizes the engine from ``.height``).
    ``last_pts`` carries the most recent buffer's presentation timestamp in
    seconds (the reference propagates PTS through appsrc,
    frame_extractor.rs:242-262).
    """

    #: frames decode natively as RGB: the planarizer skips the BGR swap
    native_rgb = True
    #: pull timeout before checking the bus for a pipeline error (ns)
    _PULL_TIMEOUT_NS = 10 * 10**9

    def __init__(self, path: str):
        import os
        uri = is_stream_uri(path)
        if not uri and not os.path.exists(path):
            raise VideoPathError(f"input video not found: {path}")
        gst = _load()
        if gst is None:
            raise DecodeError(_gst_err or "GStreamer unavailable")
        # appsink caps mirror the reference: RGB, unthrottled (sync=false,
        # ref frame_extractor.rs:147).  The location/uri is set as an
        # element property, NOT interpolated into the launch string —
        # quotes in a filename must not be able to rewrite the pipeline.
        # URIs (network cameras: rtsp/srt/http...) go through uridecodebin,
        # which resolves the scheme-appropriate source + demux/decoder.
        # Only LIVE sources drop stale frames when the consumer falls
        # behind (the sender can't be stalled); non-live URIs (file://,
        # http VOD) must deliver every frame, like the filesrc branch.
        if uri:
            drop = "true" if is_live_uri(path) else "false"
            self._pipeline = gst.parse_launch(
                'uridecodebin name=src ! queue ! videoconvert '
                '! video/x-raw,format=RGB ! appsink name=sink sync=false '
                f'max-buffers=8 drop={drop}')
            self._pipeline.get_by_name("src").set_property("uri", path)
        else:
            self._pipeline = gst.parse_launch(
                'filesrc name=src ! decodebin ! queue ! videoconvert '
                '! video/x-raw,format=RGB ! appsink name=sink sync=false '
                'max-buffers=8 drop=false')
            self._pipeline.get_by_name("src").set_property("location", path)
        self._sink = self._pipeline.get_by_name("sink")
        self._sink.set_property("emit-signals", False)
        self._gst = gst
        self.path = path
        self.fps = 30.0
        self.width = 0
        self.height = 0
        self.frame_count = -1
        self.last_pts: Optional[float] = None
        self._pipeline.set_state(gst.State.PLAYING)
        # probe geometry/fps from the preroll sample so callers can size
        # buffers before the first read.  Any probe failure must tear the
        # PLAYING pipeline down — a raised __init__ leaves no handle to
        # close() later, and a leaked live pipeline keeps decoder threads
        # and network sockets alive for the process lifetime.
        try:
            pre = self._pull("pull-preroll", "try-pull-preroll")
            if pre is not None:
                self._apply_caps(pre.get_caps().get_structure(0))
            if self.width <= 0 or self.height <= 0:
                raise DecodeError(f"could not probe geometry of {path}")
        except BaseException:
            self.close()
            raise

    def _pull(self, signal: str, try_signal: str):
        """Pull a sample with a timeout.  A None result is disambiguated:
        pipeline ERROR raises; real EOS returns None; a pull TIMEOUT with
        the source still alive raises DecodeError instead of silently
        finalizing the run as a successful end-of-stream (a stalled rtsp
        camera must not truncate the output and report success)."""
        try:
            sample = self._sink.emit(try_signal, self._PULL_TIMEOUT_NS)
        except TypeError:  # sink without the try-pull action (old/fake)
            return self._sink.emit(signal)
        if sample is None:
            self._raise_on_bus_error()
            if not self._sink_at_eos():
                raise DecodeError(
                    f"source stalled: no sample within "
                    f"{self._PULL_TIMEOUT_NS / 1e9:g}s and no EOS")
        return sample

    def _sink_at_eos(self) -> bool:
        """Whether the appsink has seen end-of-stream (appsink 'eos'
        property).  Sinks without the property report EOS — the legacy
        interpretation of a None pull."""
        try:
            return bool(self._sink.get_property("eos"))
        except Exception:
            return True

    def _raise_on_bus_error(self) -> None:
        gst = self._gst
        bus = getattr(self._pipeline, "get_bus", lambda: None)()
        if bus is None:
            return
        msg = bus.timed_pop_filtered(0, gst.MessageType.ERROR)
        if msg is not None:
            err = msg.parse_error()
            raise DecodeError(f"GStreamer pipeline error: {err}")

    def _apply_caps(self, caps) -> None:
        w, h = caps.get_value("width"), caps.get_value("height")
        if w and h:
            self.width, self.height = int(w), int(h)
        fps = _parse_fps(caps)
        if fps:
            self.fps = fps

    def read(self) -> Optional[np.ndarray]:
        gst = self._gst
        sample = self._pull("pull-sample", "try-pull-sample")
        if sample is None:
            return None
        self._apply_caps(sample.get_caps().get_structure(0))
        buf = sample.get_buffer()
        pts = getattr(buf, "pts", None)
        # Gst.CLOCK_TIME_NONE is 2**64-1; treat it as unknown.  Unknown
        # means last_pts = None for THIS frame — a stale previous value
        # would read as a duplicate timestamp and make the CFR retimer
        # drop the frame (None is the documented passthrough signal).
        if pts is not None and 0 <= pts < 2**63:
            self.last_pts = pts / 1e9
        else:
            self.last_pts = None
        ok, info = buf.map(gst.MapFlags.READ)
        if not ok:
            raise DecodeError("buffer map failed")
        try:
            # RGB video buffers are row-padded to 4-byte stride alignment:
            # slice each row to w*3 before reshaping
            flat = np.frombuffer(info.data, np.uint8)
            row = self.width * 3
            stride = flat.size // self.height
            if stride < row or stride * self.height != flat.size:
                raise DecodeError(
                    f"buffer size {flat.size} inconsistent with "
                    f"{self.width}x{self.height} RGB")
            frame = flat.reshape(self.height, stride)[:, :row].reshape(
                self.height, self.width, 3).copy()
        finally:
            buf.unmap(info)
        return frame

    def read_timed(self):
        """(frame, pts_seconds) — pts is None when the buffer carries no
        timestamp (consumers treat None as constant-rate passthrough)."""
        f = self.read()
        if f is None:
            return None
        return f, self.last_pts

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            f = self.read()
            if f is None:
                return
            yield f

    def iter_bgr(self) -> Iterator[np.ndarray]:
        for f in self:
            yield f[..., ::-1]

    def iter_bgr_timed(self) -> Iterator[tuple]:
        """(BGR frame, pts_seconds) pairs for the VFR-aware streaming path."""
        while True:
            r = self.read_timed()
            if r is None:
                return
            f, pts = r
            yield f[..., ::-1], pts

    def iter_rgb_timed(self) -> Iterator[tuple]:
        """(RGB frame, pts_seconds) in the reader's NATIVE channel order —
        the zero-copy path (``native_rgb``): the planarizer consumes RGB
        directly instead of reversing to BGR and swapping back."""
        while True:
            r = self.read_timed()
            if r is None:
                return
            yield r

    def close(self) -> None:
        self._pipeline.set_state(self._gst.State.NULL)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class GstVideoWriter:
    """RGB uint8 frames -> AVI via ``appsrc -> videoconvert -> avimux ->
    filesink`` with PTS/duration propagation (ref frame_extractor.rs:151-183:
    the reference pushes each processed frame back through appsrc preserving
    its timestamps).  Interface-compatible with io.video.VideoWriter."""

    def __init__(self, path: str, fps: float, width: int, height: int,
                 encoding=None):
        gst = _load()
        if gst is None:
            raise EncodeError(_gst_err or "GStreamer unavailable")
        self._gst = gst
        self.path = path
        self.fps = float(fps) or 30.0
        self.width, self.height = int(width), int(height)
        self.frames_written = 0
        self.fallback_used = None
        # rational fps so NTSC-style rates (29.97 -> 30000/1001) are not
        # mislabelled in the caps (buffer PTS carry the exact times anyway)
        from fractions import Fraction
        fr = Fraction(self.fps).limit_denominator(1001)
        num, den = max(fr.numerator, 1), max(fr.denominator, 1)
        # The reference muxes raw RGB into AVI (frame_extractor.rs:176).
        # Base-plugin-only installs (this image) have no avimux: fall back
        # to theoraenc+oggmux when those exist (a real, playable encode;
        # recorded in ``fallback_used``) rather than failing the write.
        mux = 'videoconvert ! avimux'
        probe = getattr(gst, "element_available", None)
        if probe is not None and not probe("avimux"):
            if probe("theoraenc") and probe("oggmux"):
                mux = 'videoconvert ! theoraenc ! oggmux'
                self.fallback_used = "theora+ogg"
            else:
                raise EncodeError(
                    "GStreamer has neither avimux nor theoraenc+oggmux "
                    "in its plugin registry; use the OpenCV writer")
        # filesink location is set as a property (never interpolated — see
        # the reader) and the caps string contains only validated integers
        self._pipeline = gst.parse_launch(
            f'appsrc name=src format=time is-live=false block=true '
            f'caps=video/x-raw,format=RGB,width={self.width},'
            f'height={self.height},framerate={num}/{den} '
            f'! {mux} ! filesink name=out')
        self._pipeline.get_by_name("out").set_property("location", path)
        self._src = self._pipeline.get_by_name("src")
        self._pipeline.set_state(gst.State.PLAYING)

    def write(self, frame_rgb: np.ndarray, pts: Optional[float] = None,
              duration: Optional[float] = None) -> None:
        gst = self._gst
        frame_rgb = np.ascontiguousarray(frame_rgb, np.uint8)
        if frame_rgb.ndim == 2 or frame_rgb.shape[-1] == 1:
            frame_rgb = np.broadcast_to(
                frame_rgb.reshape(self.height, self.width, 1),
                (self.height, self.width, 3))
            frame_rgb = np.ascontiguousarray(frame_rgb)
        buf = gst.Buffer.new_wrapped(frame_rgb.tobytes())
        if pts is None:
            pts = self.frames_written / self.fps
        if duration is None:
            duration = 1.0 / self.fps
        buf.pts = buf.dts = int(pts * 1e9)
        buf.duration = int(duration * 1e9)
        ret = self._src.emit("push-buffer", buf)
        # surface pipeline failure at the write that hit it (a broken
        # filesink flushes the pipeline; FlowReturn goes non-OK) — the
        # OpenCV writer raises for the same condition
        ok_ret = getattr(self._gst, "FlowReturn", None)
        if ret is not None and ok_ret is not None and ret != ok_ret.OK:
            raise EncodeError(f"appsrc push-buffer failed: {ret}")
        self.frames_written += 1

    def close(self) -> None:
        self._src.emit("end-of-stream")
        bus = self._pipeline.get_bus()
        err = None
        if bus is not None:
            # wait for EOS to flush the muxer (5 s cap, like the reference's
            # thumbnail bus timeout); an ERROR arriving instead of EOS is a
            # failed encode and must not pass silently
            try:
                msg = bus.timed_pop_filtered(
                    5 * 10**9, self._gst.MessageType.EOS
                    | self._gst.MessageType.ERROR)
                if (msg is not None and getattr(msg, "type", None)
                        == self._gst.MessageType.ERROR):
                    err = msg.parse_error()
            except Exception:
                pass
        self._pipeline.set_state(self._gst.State.NULL)
        if err is not None:
            raise EncodeError(f"GStreamer encode failed: {err}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_video(path: str, backend: str = "auto"):
    """Backend-selecting reader factory: 'opencv', 'gstreamer', or 'auto'
    (GStreamer when importable — it is the reference's primary ingest —
    otherwise OpenCV, which is always present in this distribution).
    Media URIs (``rtsp://`` cameras, ``srt://``, HLS over http(s), ...)
    decode through uridecodebin on the GStreamer backend; OpenCV falls
    back to its FFmpeg network support for them."""
    from .video import VideoReader
    if backend == "gstreamer":
        return GstVideoReader(path)
    if backend == "opencv":
        return VideoReader(path)
    if backend == "auto":
        return GstVideoReader(path) if available() else VideoReader(path)
    raise ValueError(f"unknown video backend {backend!r}")


def open_writer(path: str, fps: float, width: int, height: int,
                encoding, backend: str = "auto"):
    """Backend-selecting writer factory (mirrors :func:`open_video`).
    'auto' prefers OpenCV (its encoders honour ``encoding``); 'gstreamer'
    muxes raw RGB into AVI with PTS propagation."""
    from .video import VideoWriter
    if backend == "gstreamer":
        return GstVideoWriter(path, fps, width, height, encoding)
    if backend in ("opencv", "auto"):
        return VideoWriter(path, fps, width, height, encoding)
    raise ValueError(f"unknown video backend {backend!r}")
