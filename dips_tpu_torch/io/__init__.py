"""Host media I/O: readers, writers, thumbnails, raw dumps, subsampling,
synthetic clips and event recording.

The names of ``dips_tpu/io/__init__.py`` resolve on first use (a module
``__getattr__``), so ``import dips_tpu_torch`` does not need OpenCV.
"""

_EXPORTS = {
    "VideoReader": "video", "VideoWriter": "video", "open_camera": "video",
    "extract_thumbnail": "thumbnail", "read_dat_dir": "datfiles",
    "subsample_video": "subsample", "moving_square_clip": "synthetic",
    "write_clip": "synthetic",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                   name)
