"""Build the two framepump host libraries once, before any test process
imports them.

Both ``dips_tpu/native`` and ``dips_tpu_torch/native`` run ``make`` when
they are imported, and the ``.so`` is not in git, so a fresh checkout
builds it at the first import.  Under pytest-xdist every worker imports
the packages while it collects, so several ``g++`` processes used to
write the same file at once, and a worker that loaded the half-written
file ran with ``NATIVE_AVAILABLE = False``.  This file sits at the root of
the repository, so pytest loads it in the controlling process before the
workers start; ``pytest_configure`` builds both libraries there, each
under an exclusive lock on its directory (the lock the port's own import
takes), and the workers' ``make`` then finds them up to date and writes
nothing.  A missing toolchain is not an error here: the packages' own
imports report it as they always did.
"""

import fcntl
import os
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NATIVE_DIRS = (ROOT / "dips_tpu" / "native", ROOT / "dips_tpu_torch" / "native")


def _make_locked(directory: Path) -> None:
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        subprocess.run(["make", "-C", str(directory), "-s"],
                       capture_output=True, timeout=300, check=False)
    except (OSError, subprocess.SubprocessError):
        pass
    finally:
        os.close(fd)  # releases the lock


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: already built
        return
    if os.environ.get("DIPS_TPU_NO_NATIVE"):
        return
    for directory in NATIVE_DIRS:
        _make_locked(directory)
