"""``python -m dips_tpu_torch._dryrun N``: every mesh path of the port on
N CPU cells, in a process of its own under a timeout."""

import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n", [8, 3])
def test_dryrun_prints_ok(n):
    res = subprocess.run([sys.executable, "-m", "dips_tpu_torch._dryrun",
                          str(n)], cwd=_REPO, capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().splitlines()[-1] == "DRYRUN-OK"
