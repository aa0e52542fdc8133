from .grid2d import grid_mesh  # noqa: F401
from .mesh import Mesh  # noqa: F401
from .multistream import MultiStreamEngine, stream_mesh  # noqa: F401
