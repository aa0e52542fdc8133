"""Error types for dips_tpu.

The reference exposes a small hierarchy of typed errors for missing
configuration and pipeline failures (``dips/src/lib.rs:172-231``:
``VideoPathError`` / ``FrameCallbackError`` / ``OutputPathError`` /
``DiPsError``).  We mirror that surface with Python exceptions, and add
per-stream error isolation (SURVEY.md §5: "a failed stream in a batch must
not kill the batch") via :class:`StreamError`.
"""

from __future__ import annotations


class DiPsError(Exception):
    """Base error for all dips_tpu failures (ref: dips/src/lib.rs:219-231)."""


class VideoPathError(DiPsError):
    """Input video path missing or unreadable (ref: dips/src/lib.rs:172-186)."""


class OutputPathError(DiPsError):
    """Output path missing or unwritable (ref: dips/src/lib.rs:204-217)."""


class FrameCallbackError(DiPsError):
    """A user frame callback failed (ref: dips/src/lib.rs:188-202)."""


class DecodeError(DiPsError):
    """Video decode failed mid-stream (ref bus-error teardown:
    dips/src/frame_extractor.rs:304-307)."""


class EncodeError(DiPsError):
    """Video encode/write failed (ref: VideoWriter construction,
    dips_alt/src/lib.rs:611-619)."""


class DeviceError(DiPsError):
    """Accelerator initialisation/dispatch failed (ref: adapter/device
    acquisition panics, dips_alt/src/gpu_controller.rs:52)."""


class ReplyLost(DiPsError):
    """A reconnecting serving client found its in-flight frames WERE
    processed by the server (the stream cursor advanced) but the reply
    died with the connection.  The frames are accounted for — resending
    would double-process them — so their outputs are irrecoverable; the
    caller skips them and keeps streaming.
    """

    def __init__(self, n_frames: int):
        self.n_frames = int(n_frames)
        super().__init__(
            f"{n_frames} frame(s) were processed but their reply was lost "
            f"with the connection; outputs skipped, stream continues")


class StreamError(DiPsError):
    """Wraps a failure of one stream inside a multi-stream batch.

    Unlike the reference (which panics on camera/device failures,
    dips_alt/src/lib.rs:143), batch runs collect per-stream failures and
    report them without aborting sibling streams.
    """

    def __init__(self, stream_id: int | str, cause: BaseException):
        self.stream_id = stream_id
        self.cause = cause
        super().__init__(f"stream {stream_id!r} failed: {cause!r}")
