"""dips_tpu_torch — DiPs (video frame-difference pixels) on PyTorch and CUDA.

The port of ``dips_tpu`` to one NVIDIA H100: the same streaming engine and
multi-stream fleet engine (and its multi-process form), properties and
checkpoints, with the ring-carry device steps as CUDA kernels written by
hand (``csrc/``), and the run path around them (``app.py``, ``cli.py``,
``live.py``).  On the CPU the
kernels' plain PyTorch twins run.  This package never imports jax, and
imports without OpenCV (``extract_thumbnail`` resolves on first use).
"""

from .errors import (DecodeError, DeviceError, DiPsError, EncodeError,
                     FrameCallbackError, OutputPathError, ReplyLost,
                     StreamError, VideoPathError)
from .properties import (ChromaFilter, DiPsFilter, DiPsMethod, DiPsProperties,
                         Encoding, OutputMode)
from .models import DiPsEngine
from .parallel import (MultiHostStreamEngine, MultiStreamEngine,
                       init_multihost, stream_mesh)
from .app import (DiPsJob, custom_dips_on_files, init_frame_extractor,
                  init_thumbnail_extractor, perform_dips, run_dips_app,
                  run_dips_on_file, run_dips_on_files, stream_dips)
from .ops.events import MotionDetector, MotionEvent, detect_events

__all__ = [
    "ChromaFilter", "DecodeError", "DeviceError", "DiPsEngine", "DiPsError",
    "DiPsFilter", "DiPsJob", "DiPsMethod", "DiPsProperties", "EncodeError",
    "Encoding", "FrameCallbackError", "MotionDetector", "MotionEvent",
    "MultiHostStreamEngine", "MultiStreamEngine", "OutputMode",
    "OutputPathError", "ReplyLost", "StreamError", "VideoPathError",
    "custom_dips_on_files", "detect_events", "extract_thumbnail",
    "init_frame_extractor", "init_multihost", "init_thumbnail_extractor",
    "perform_dips", "run_dips_app", "run_dips_on_file", "run_dips_on_files",
    "stream_dips", "stream_mesh",
]


def __getattr__(name):
    # the thumbnail extractor imports cv2 at its top: resolved on use
    if name == "extract_thumbnail":
        from .io.thumbnail import extract_thumbnail
        return extract_thumbnail
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
