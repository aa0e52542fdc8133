"""Media backend selection.

Counterpart of the selection half of ``dips_tpu/io/gstreamer.py``:
:data:`STREAM_SCHEMES`, :func:`is_stream_uri` and the factories
:func:`open_video` / :func:`open_writer`.  The port decodes and encodes
with OpenCV (``io/video.py``): "auto" and "opencv" resolve to its reader
and writer, "gstreamer" raises ``NotImplementedError`` (the GStreamer
reader and writer are not ported), anything else ``ValueError``.
"""

from __future__ import annotations

#: URI schemes of network cameras / streams and explicit file:// URIs
STREAM_SCHEMES = ("rtsp://", "rtsps://", "rtp://", "udp://", "srt://",
                  "rtmp://", "http://", "https://", "file://")


def is_stream_uri(path: str) -> bool:
    """True when ``path`` is a media URI rather than a local file path
    (schemes are case-insensitive, RFC 3986)."""
    return path.lower().startswith(STREAM_SCHEMES)


def _check_backend(backend: str) -> None:
    if backend == "gstreamer":
        raise NotImplementedError("the gstreamer video backend is not "
                                  "ported: the port decodes with OpenCV")
    if backend not in ("auto", "opencv"):
        raise ValueError(f"unknown video backend {backend!r}")


def open_video(path: str, backend: str = "auto"):
    """Backend-selecting reader factory: "auto" / "opencv" give
    :class:`~dips_tpu_torch.io.video.VideoReader`."""
    from .video import VideoReader
    _check_backend(backend)
    return VideoReader(path)


def open_writer(path: str, fps: float, width: int, height: int,
                encoding, backend: str = "auto"):
    """Backend-selecting writer factory (mirrors :func:`open_video`)."""
    from .video import VideoWriter
    _check_backend(backend)
    return VideoWriter(path, fps, width, height, encoding)
