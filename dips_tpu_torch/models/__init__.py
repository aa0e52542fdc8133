from .pipeline import DiPsEngine  # noqa: F401
