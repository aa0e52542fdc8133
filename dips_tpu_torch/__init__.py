"""dips_tpu_torch — DiPs (video frame-difference pixels) on PyTorch and CUDA.

The port of ``dips_tpu`` to one NVIDIA H100: the same streaming engine and
multi-stream fleet engine, properties and checkpoints, with the ring-carry
device steps as CUDA kernels written by hand (``csrc/``).  On the CPU the
kernels' plain PyTorch twins run.  This package never imports jax.
"""

from .errors import (DecodeError, DeviceError, DiPsError, EncodeError,
                     FrameCallbackError, OutputPathError, StreamError,
                     VideoPathError)
from .properties import (ChromaFilter, DiPsFilter, DiPsMethod, DiPsProperties,
                         Encoding, OutputMode)
from .models import DiPsEngine
from .parallel import MultiStreamEngine
from .app import (DiPsJob, perform_dips, run_dips_on_file, run_dips_on_files,
                  stream_dips)

__all__ = [
    "ChromaFilter", "DecodeError", "DeviceError", "DiPsEngine", "DiPsError",
    "DiPsFilter", "DiPsJob", "DiPsMethod", "DiPsProperties", "EncodeError",
    "Encoding", "FrameCallbackError", "MultiStreamEngine", "OutputMode",
    "OutputPathError", "StreamError", "VideoPathError", "perform_dips",
    "run_dips_on_file", "run_dips_on_files", "stream_dips",
]
