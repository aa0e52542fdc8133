from .multistream import MultiStreamEngine  # noqa: F401
