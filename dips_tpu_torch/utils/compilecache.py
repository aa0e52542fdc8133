"""Persistent kernel build cache.

Counterpart of ``dips_tpu/utils/compilecache.py``.  The JAX package keeps
XLA's compiled executables across restarts; the port's compiled code is
its CUDA kernel library, which ``ops/_build.py`` builds at first use with
``nvcc`` into ``BUILD_ROOT/<key>/`` (``<key>`` hashes the sources, the
flags, the block geometry, nvcc's version and the card's compute
capability).  By default ``BUILD_ROOT`` is ``build/dips_tpu_torch/`` in
the checkout; pointing it at a directory that outlives the checkout makes
every restart after the first load the built library instead of running
``nvcc`` again (about 20 s for the full library on 8 cores).

Frontends expose it as ``--compile-cache [DIR]``; the ``DIPS_COMPILE_CACHE``
environment variable provides a default, so fleet deployments can turn it
on without touching unit files.  A library already loaded in this process
stays loaded; builds after the call go to the new directory.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

_DEFAULT_DIR = os.path.join("~", ".cache", "dips_tpu_torch", "kernels")


def default_cache_dir() -> str:
    """The cache directory used when none is given: the
    ``DIPS_COMPILE_CACHE`` environment variable, else
    ``~/.cache/dips_tpu_torch/kernels``."""
    return os.environ.get("DIPS_COMPILE_CACHE") or _DEFAULT_DIR


def enable_compile_cache(path: Optional[str] = None) -> str:
    """Build and load the kernels under ``path`` (default
    :func:`default_cache_dir`) from now on; returns the absolute
    directory."""
    from ..ops import _build

    resolved = os.path.abspath(os.path.expanduser(path or default_cache_dir()))
    os.makedirs(resolved, exist_ok=True)
    _build.BUILD_ROOT = Path(resolved)
    return resolved


def add_compile_cache_flag(parser) -> None:
    """Install ``--compile-cache [DIR]`` on an argparse parser."""
    parser.add_argument(
        "--compile-cache", nargs="?", const="", default=None, metavar="DIR",
        help="build the CUDA kernels under DIR and keep them there (default "
             "$DIPS_COMPILE_CACHE or ~/.cache/dips_tpu_torch/kernels) so "
             "restarts skip the nvcc build")


def apply_compile_cache_flag(args) -> Optional[str]:
    """Honor the flag installed by :func:`add_compile_cache_flag`.

    Returns the cache dir when enabled, else None.  ``--compile-cache``
    with no value uses the default directory; the flag absent but
    ``DIPS_COMPILE_CACHE`` set in the environment also enables it (fleet
    opt-in without CLI changes)."""
    val = getattr(args, "compile_cache", None)
    if val is None and not os.environ.get("DIPS_COMPILE_CACHE"):
        return None
    return enable_compile_cache(val or None)
