from .grid2d import grid_mesh  # noqa: F401
from .mesh import Mesh  # noqa: F401
from .multistream import MultiStreamEngine, stream_mesh  # noqa: F401
from .rowsharded import (make_rowsharded_ring_step,  # noqa: F401
                         make_rowsharded_step)
from .multihost import (init_multihost, MultiHostInfo,  # noqa: F401
                        MultiHostStreamEngine)
