"""Raw instrument-dump ingestion ("Dat_N.d" batch mode).

Parity with ``custom_dips_on_files`` (dips_alt/src/lib.rs:693-900): a
directory of raw RGBA dumps named ``Dat_<N>.d``, each with a 4-byte header,
sorted by numeric suffix; non-'D' files are skipped.  The reference hardcodes
273x640 (lib.rs:788-789) — here geometry is a parameter with those defaults.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Iterator, List

import numpy as np

from ..errors import DecodeError

log = logging.getLogger("dips_tpu.datfiles")

DEFAULT_WIDTH = 273    # ref: dips_alt/src/lib.rs:788
DEFAULT_HEIGHT = 640   # ref: dips_alt/src/lib.rs:789
HEADER_BYTES = 4       # ref: skips [4..], dips_alt/src/lib.rs:793

_NUM = re.compile(r"(\d+)")


def list_dat_files(data_dir: str) -> List[str]:
    """Regular files starting with 'D', sorted by their numeric suffix
    (ref sort: dips_alt/src/lib.rs:753-768; directories and other
    non-regular entries are skipped like the reference's skip branch)."""
    names = [n for n in os.listdir(data_dir)
             if n.startswith("D")
             and os.path.isfile(os.path.join(data_dir, n))]

    def key(n: str) -> int:
        m = _NUM.search(n)
        return int(m.group(1)) if m else -1

    return [os.path.join(data_dir, n) for n in sorted(names, key=key)]


def read_dat_frame(path: str, width: int = DEFAULT_WIDTH,
                   height: int = DEFAULT_HEIGHT) -> np.ndarray:
    """One raw dump -> RGB uint8 (height, width, 3).

    The payload after the 4-byte header is RGBA8; alpha is dropped.
    """
    data = np.fromfile(path, np.uint8)
    payload = data[HEADER_BYTES:]
    expect = width * height * 4
    if payload.size < expect:
        raise DecodeError(
            f"{path}: {payload.size} payload bytes < {expect} "
            f"({width}x{height} RGBA)")
    rgba = payload[:expect].reshape(height, width, 4)
    return np.ascontiguousarray(rgba[..., :3])


def read_dat_dir(data_dir: str, width: int = DEFAULT_WIDTH,
                 height: int = DEFAULT_HEIGHT) -> Iterator[np.ndarray]:
    """Frames from every dump in the directory.  A 'D' file that is not a
    dump (a stray Desktop.ini, or the run's own output landing in the
    data dir) is skipped with a warning — one alien file must not abort
    the whole batch (the reference likewise skips non-matching files)."""
    for p in list_dat_files(data_dir):
        try:
            frame = read_dat_frame(p, width, height)
        except DecodeError as e:
            log.warning("skipping non-dump file: %s", e)
            continue
        yield frame
