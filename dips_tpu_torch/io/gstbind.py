"""ctypes GStreamer binding: the real C stack without PyGObject.

This image ships GStreamer 1.22 core + base plugins
(``libgstreamer-1.0.so.0``, ``libgstapp-1.0.so.0``, the ``app``/
``playback``/``videoconvertscale``/``ogg``/``theora`` plugins) but NOT the
PyGObject (``gi``) Python bindings, and the environment is offline so they
cannot be installed.  This module binds the C API the ``io/gstreamer.py``
backend actually uses — ``gst_parse_launch`` pipelines, app-sink pulls,
app-src pushes, buffer map/fill, caps introspection, bus polling — straight
through ``ctypes`` and exposes it behind a ``gi.repository.Gst``-shaped
facade, so the reader/writer code runs UNMODIFIED against real GStreamer.

Scope: exactly the surface ``GstVideoReader``/``GstVideoWriter`` consume
(see their reference citations: dips/src/frame_extractor.rs:38-290).  The
blocking app-sink pull API replaces PyGObject's action signals one-to-one
(``emit("try-pull-sample", t)`` -> ``gst_app_sink_try_pull_sample``), so no
GLib main loop and no C callbacks are needed.

Struct field access (buffer pts/dts/duration, message type) uses the
public, ABI-stable layouts from ``gstbuffer.h``/``gstmessage.h`` — these
are part of GStreamer's 1.x ABI contract (the C macros ``GST_BUFFER_PTS``
etc. compile to exactly these offsets).
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

_C = ctypes

# GstClockTime is guint64; GST_CLOCK_TIME_NONE = (guint64) -1
CLOCK_TIME_NONE = 2**64 - 1


class _GstMiniObject(_C.Structure):
    # gstminiobject.h (ABI-stable since 1.0)
    _fields_ = [("type", _C.c_size_t),        # GType
                ("refcount", _C.c_int),
                ("lockstate", _C.c_int),
                ("flags", _C.c_uint),
                ("copy", _C.c_void_p),
                ("dispose", _C.c_void_p),
                ("free", _C.c_void_p),
                ("priv_uint", _C.c_uint),
                ("priv_pointer", _C.c_void_p)]


class _GstBuffer(_C.Structure):
    # gstbuffer.h: mini_object, pool, pts, dts, duration, offset, offset_end
    _fields_ = [("mini_object", _GstMiniObject),
                ("pool", _C.c_void_p),
                ("pts", _C.c_uint64),
                ("dts", _C.c_uint64),
                ("duration", _C.c_uint64),
                ("offset", _C.c_uint64),
                ("offset_end", _C.c_uint64)]


class _GstMessage(_C.Structure):
    # gstmessage.h: mini_object, type, timestamp, src, seqnum (+ private)
    _fields_ = [("mini_object", _GstMiniObject),
                ("type", _C.c_uint),
                ("timestamp", _C.c_uint64),
                ("src", _C.c_void_p),
                ("seqnum", _C.c_uint32)]


class _GstMapInfo(_C.Structure):
    # gstmemory.h GstMapInfo
    _fields_ = [("memory", _C.c_void_p),
                ("flags", _C.c_uint),
                ("data", _C.c_void_p),
                ("size", _C.c_size_t),
                ("maxsize", _C.c_size_t),
                ("user_data", _C.c_void_p * 4),
                ("reserved", _C.c_void_p * 4)]


class _GError(_C.Structure):
    _fields_ = [("domain", _C.c_uint32),
                ("code", _C.c_int),
                ("message", _C.c_char_p)]


def _lib(name: str):
    path = ctypes.util.find_library(name)
    if path is None:
        # find_library needs ldconfig/gcc; fall back to the soname directly
        path = f"lib{name}.so.0"
    # RTLD_LOCAL (the default): each library resolves its own DT_NEEDED
    # deps.  RTLD_GLOBAL leaked glib/gobject symbols process-wide and
    # crashed matplotlib's font stack on import (symbol clash -> abort).
    return _C.CDLL(path)


class _Api:
    """Resolved C entry points (one instance per process)."""

    def __init__(self):
        self.glib = _lib("glib-2.0")
        self.gobject = _lib("gobject-2.0")
        self.gst = _lib("gstreamer-1.0")
        self.gstapp = _lib("gstapp-1.0")

        g = self.gst

        def f(lib, name, res, args):
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
            return fn

        P, I, U64, SZ, B = (_C.c_void_p, _C.c_int, _C.c_uint64,
                            _C.c_size_t, _C.c_int)
        S = _C.c_char_p
        self.init = f(g, "gst_init", None, [P, P])
        self.parse_launch = f(g, "gst_parse_launch", P,
                              [S, _C.POINTER(_C.POINTER(_GError))])
        self.set_state = f(g, "gst_element_set_state", I, [P, I])
        self.get_by_name = f(g, "gst_bin_get_by_name", P, [P, S])
        self.get_bus = f(g, "gst_element_get_bus", P, [P])
        self.bus_pop = f(g, "gst_bus_timed_pop_filtered", P, [P, U64, I])
        self.msg_parse_error = f(g, "gst_message_parse_error", None,
                                 [P, _C.POINTER(_C.POINTER(_GError)),
                                  _C.POINTER(S)])
        self.sample_get_caps = f(g, "gst_sample_get_caps", P, [P])
        self.sample_get_buffer = f(g, "gst_sample_get_buffer", P, [P])
        self.caps_get_structure = f(g, "gst_caps_get_structure", P, [P, _C.c_uint])
        self.structure_get_int = f(g, "gst_structure_get_int", B,
                                   [P, S, _C.POINTER(I)])
        self.structure_get_fraction = f(g, "gst_structure_get_fraction", B,
                                        [P, S, _C.POINTER(I), _C.POINTER(I)])
        self.buffer_map = f(g, "gst_buffer_map", B,
                            [P, _C.POINTER(_GstMapInfo), I])
        self.buffer_unmap = f(g, "gst_buffer_unmap", None,
                              [P, _C.POINTER(_GstMapInfo)])
        self.buffer_new_allocate = f(g, "gst_buffer_new_allocate", P,
                                     [P, SZ, P])
        self.buffer_fill = f(g, "gst_buffer_fill", SZ, [P, SZ, P, SZ])
        self.mini_object_unref = f(g, "gst_mini_object_unref", None, [P])
        self.object_unref = f(g, "gst_object_unref", None, [P])
        self.factory_find = f(g, "gst_element_factory_find", P, [S])
        self.version_string = f(g, "gst_version_string", S, [])

        a = self.gstapp
        self.sink_pull_preroll = f(a, "gst_app_sink_pull_preroll", P, [P])
        self.sink_try_pull_preroll = f(a, "gst_app_sink_try_pull_preroll",
                                       P, [P, U64])
        self.sink_pull_sample = f(a, "gst_app_sink_pull_sample", P, [P])
        self.sink_try_pull_sample = f(a, "gst_app_sink_try_pull_sample",
                                      P, [P, U64])
        self.sink_is_eos = f(a, "gst_app_sink_is_eos", B, [P])
        self.src_push_buffer = f(a, "gst_app_src_push_buffer", I, [P, P])
        self.src_end_of_stream = f(a, "gst_app_src_end_of_stream", I, [P])

        go = self.gobject
        self.ref_sink = f(go, "g_object_ref_sink", P, [P])
        # g_object_set/get are varargs: argtypes are set per call
        self.g_object_set = go.g_object_set
        self.g_object_set.restype = None
        self.g_error_free = f(self.glib, "g_error_free", None,
                              [_C.POINTER(_GError)])
        self.g_free = f(self.glib, "g_free", None, [P])


_api: Optional[_Api] = None


def _require() -> _Api:
    global _api
    if _api is None:
        _api = _Api()
    return _api


# ---------------------------------------------------------------------------
# gi.repository.Gst-shaped facade (the subset io/gstreamer.py consumes)
# ---------------------------------------------------------------------------

class _Enum:
    def __init__(self, **kv):
        self.__dict__.update(kv)


class Structure:
    """GstStructure view (transfer-none pointer owned by its caps)."""

    def __init__(self, ptr):
        self._ptr = ptr

    def get_value(self, name: str):
        v = _C.c_int()
        if _require().structure_get_int(self._ptr, name.encode(),
                                        _C.byref(v)):
            return int(v.value)
        return None

    def get_fraction(self, name: str):
        n, d = _C.c_int(), _C.c_int()
        ok = _require().structure_get_fraction(self._ptr, name.encode(),
                                               _C.byref(n), _C.byref(d))
        return bool(ok), int(n.value), int(d.value)


class Caps:
    def __init__(self, ptr):
        self._ptr = ptr

    def get_structure(self, i: int) -> Structure:
        return Structure(_require().caps_get_structure(self._ptr, i))


class _MapInfoView:
    """The (ok, info) ``info`` object: ``.data`` is a zero-copy ctypes
    array over the mapped bytes (np.frombuffer-compatible)."""

    def __init__(self, raw: _GstMapInfo):
        self._raw = raw
        self.size = int(raw.size)
        self.data = (_C.c_ubyte * self.size).from_address(raw.data) \
            if raw.data and self.size else b""


class Buffer:
    """GstBuffer facade.  Owns one ref unless handed to push-buffer
    (which takes ownership)."""

    def __init__(self, ptr, owned: bool):
        self._ptr = ptr
        self._owned = owned

    # -- construction (writer path) --------------------------------------
    @staticmethod
    def new_wrapped(data: bytes) -> "Buffer":
        api = _require()
        ptr = api.buffer_new_allocate(None, len(data), None)
        if not ptr:
            raise MemoryError("gst_buffer_new_allocate failed")
        api.buffer_fill(ptr, 0, data, len(data))
        return Buffer(ptr, owned=True)

    # -- timestamps (struct fields; the GST_BUFFER_PTS macro offsets) ----
    @property
    def _struct(self) -> _GstBuffer:
        return _C.cast(self._ptr, _C.POINTER(_GstBuffer)).contents

    @property
    def pts(self) -> int:
        return int(self._struct.pts)

    @pts.setter
    def pts(self, v: int) -> None:
        self._struct.pts = int(v)

    @property
    def dts(self) -> int:
        return int(self._struct.dts)

    @dts.setter
    def dts(self, v: int) -> None:
        self._struct.dts = int(v)

    @property
    def duration(self) -> int:
        return int(self._struct.duration)

    @duration.setter
    def duration(self, v: int) -> None:
        self._struct.duration = int(v)

    # -- mapping (reader path) -------------------------------------------
    def map(self, flags: int):
        raw = _GstMapInfo()
        ok = _require().buffer_map(self._ptr, _C.byref(raw), int(flags))
        return bool(ok), _MapInfoView(raw) if ok else None

    def unmap(self, info: _MapInfoView) -> None:
        _require().buffer_unmap(self._ptr, _C.byref(info._raw))

    def _release_to_c(self):
        """Hand ownership to a transfer-full C call (push-buffer)."""
        self._owned = False
        return self._ptr

    def __del__(self):
        if getattr(self, "_owned", False) and self._ptr:
            try:
                _require().mini_object_unref(self._ptr)
            except Exception:
                pass


class Sample:
    """Transfer-full GstSample from an app-sink pull."""

    def __init__(self, ptr):
        self._ptr = ptr

    def get_caps(self) -> Caps:
        return Caps(_require().sample_get_caps(self._ptr))

    def get_buffer(self) -> Buffer:
        # transfer-none: the sample keeps ownership (facade must outlive
        # the buffer view — the reader's usage pattern does)
        return Buffer(_require().sample_get_buffer(self._ptr), owned=False)

    def __del__(self):
        if getattr(self, "_ptr", None):
            try:
                _require().mini_object_unref(self._ptr)
            except Exception:
                pass


class _ParsedError:
    def __init__(self, text: str):
        self._text = text

    def __str__(self):
        return self._text

    def __repr__(self):
        return f"GstError({self._text!r})"


class Message:
    def __init__(self, ptr):
        self._ptr = ptr
        self.type = int(_C.cast(ptr, _C.POINTER(_GstMessage)).contents.type)

    def parse_error(self):
        api = _require()
        err = _C.POINTER(_GError)()
        dbg = _C.c_char_p()
        api.msg_parse_error(self._ptr, _C.byref(err), _C.byref(dbg))
        text = ""
        if err:
            text = (err.contents.message or b"").decode("utf-8", "replace")
            api.g_error_free(err)
        if dbg.value:
            text += f" [{dbg.value.decode('utf-8', 'replace')}]"
            api.g_free(_C.cast(dbg, _C.c_void_p))
        return _ParsedError(text or "unknown GStreamer error")

    def __del__(self):
        if getattr(self, "_ptr", None):
            try:
                _require().mini_object_unref(self._ptr)
            except Exception:
                pass


class Bus:
    def __init__(self, ptr):
        self._ptr = ptr

    def timed_pop_filtered(self, timeout_ns: int, types: int):
        ptr = _require().bus_pop(self._ptr, int(timeout_ns), int(types))
        return Message(ptr) if ptr else None

    def __del__(self):
        if getattr(self, "_ptr", None):
            try:
                _require().object_unref(self._ptr)
            except Exception:
                pass


class Element:
    """GstElement facade; app-sink/src action 'signals' dispatch to the
    direct C API (no GLib main loop, no callbacks)."""

    def __init__(self, ptr):
        self._ptr = ptr

    def set_property(self, name: str, value) -> None:
        api = _require()
        n = name.encode()
        if isinstance(value, bool):
            api.g_object_set(_C.c_void_p(self._ptr), _C.c_char_p(n),
                             _C.c_int(int(value)), _C.c_void_p(None))
        elif isinstance(value, int):
            api.g_object_set(_C.c_void_p(self._ptr), _C.c_char_p(n),
                             _C.c_int64(value), _C.c_void_p(None))
        elif isinstance(value, str):
            api.g_object_set(_C.c_void_p(self._ptr), _C.c_char_p(n),
                             _C.c_char_p(value.encode()), _C.c_void_p(None))
        else:
            raise TypeError(f"unsupported property type for {name!r}: "
                            f"{type(value).__name__}")

    def get_property(self, name: str):
        if name == "eos":  # the one property the reader polls
            return bool(_require().sink_is_eos(self._ptr))
        raise AttributeError(f"get_property({name!r}) not bound")

    def emit(self, signal: str, *args):
        api = _require()
        if signal == "pull-preroll":
            ptr = api.sink_pull_preroll(self._ptr)
            return Sample(ptr) if ptr else None
        if signal == "try-pull-preroll":
            ptr = api.sink_try_pull_preroll(self._ptr, int(args[0]))
            return Sample(ptr) if ptr else None
        if signal == "pull-sample":
            ptr = api.sink_pull_sample(self._ptr)
            return Sample(ptr) if ptr else None
        if signal == "try-pull-sample":
            ptr = api.sink_try_pull_sample(self._ptr, int(args[0]))
            return Sample(ptr) if ptr else None
        if signal == "push-buffer":
            buf: Buffer = args[0]
            return int(api.src_push_buffer(self._ptr, buf._release_to_c()))
        if signal == "end-of-stream":
            return int(api.src_end_of_stream(self._ptr))
        raise ValueError(f"unbound signal {signal!r}")

    def __del__(self):
        if getattr(self, "_ptr", None):
            try:
                _require().object_unref(self._ptr)
            except Exception:
                pass


class Pipeline:
    def __init__(self, ptr):
        self._ptr = ptr

    def get_by_name(self, name: str) -> Optional[Element]:
        ptr = _require().get_by_name(self._ptr, name.encode())
        return Element(ptr) if ptr else None

    def set_state(self, state: int) -> int:
        return int(_require().set_state(self._ptr, int(state)))

    def get_bus(self) -> Optional[Bus]:
        ptr = _require().get_bus(self._ptr)
        return Bus(ptr) if ptr else None

    def __del__(self):
        if getattr(self, "_ptr", None):
            try:
                _require().set_state(self._ptr, GstModule.State.NULL)
                _require().object_unref(self._ptr)
            except Exception:
                pass


class GstModule:
    """The ``Gst``-shaped module object ``io/gstreamer.py`` consumes."""

    # gstelement.h GstState
    State = _Enum(VOID_PENDING=0, NULL=1, READY=2, PAUSED=3, PLAYING=4)
    # gstmessage.h GstMessageType (flags)
    MessageType = _Enum(EOS=1 << 0, ERROR=1 << 1)
    # gstmemory.h GstMapFlags
    MapFlags = _Enum(READ=1 << 0, WRITE=1 << 1)
    # gstpad.h GstFlowReturn
    FlowReturn = _Enum(OK=0, FLUSHING=-2, EOS=-3, ERROR=-5)
    CLOCK_TIME_NONE = CLOCK_TIME_NONE
    Buffer = Buffer
    #: marks the backend for logging/tests ("ctypes" vs PyGObject)
    BINDING = "ctypes"

    def __init__(self):
        api = _require()
        api.init(None, None)
        self.version = api.version_string().decode()

    @staticmethod
    def init(_argv=None) -> None:
        _require().init(None, None)

    def parse_launch(self, description: str) -> Pipeline:
        api = _require()
        err = _C.POINTER(_GError)()
        ptr = api.parse_launch(description.encode(), _C.byref(err))
        msg = None
        if err:
            msg = (err.contents.message or b"").decode("utf-8", "replace")
            api.g_error_free(err)
        if not ptr:
            raise RuntimeError(f"gst_parse_launch failed: {msg}")
        # parse_launch returns a floating ref; sink it so the facade owns it
        api.ref_sink(ptr)
        return Pipeline(ptr)

    @staticmethod
    def element_available(factory_name: str) -> bool:
        """True when the plugin registry has this element (e.g. 'avimux')."""
        api = _require()
        ptr = api.factory_find(factory_name.encode())
        if ptr:
            api.object_unref(ptr)
            return True
        return False


def load_gst() -> GstModule:
    """Load the C stack and return the Gst-shaped module facade.
    Raises (OSError/AttributeError) when the libraries are absent."""
    return GstModule()
