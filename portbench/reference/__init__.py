"""The benchmark's plain reference: DiPs pixel arithmetic in NumPy.

A frozen, self-contained copy of the oracle arithmetic that the port is
held to (OVERALL method; the ABSDIFF and the COLORIZE pipelines), with the
streaming replay that works a stream's carried state out again from its
frames.  It imports nothing of the program under test.
"""

from .dips import Params, StreamReplay, params_from_config, pool_planes

__all__ = ["Params", "StreamReplay", "params_from_config", "pool_planes"]
