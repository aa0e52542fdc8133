from .indexing import UCircularIndex  # noqa: F401
from .profiling import StageTimers, trace  # noqa: F401
