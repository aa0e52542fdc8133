"""The port's serving examples (6-8) against the JAX package's, on the CPU.

``serving``, ``motion_alerts`` and ``camera_fleet``: the JAX example and
the port's with ``--cpu``, side by side in working directories of their
own, each under a 180 s timeout; both exit 0 and their stdout passes
``dips_tpu_torch.examples._compare`` (the port, the daemon's request /
dispatch / fill counts, the request p50 and ``hello``'s backend masked,
each with its reason).  The port's daemons run on ``device="cpu"``.
"""

import pytest

from tests.test_torch_examples import run_pair


@pytest.mark.parametrize("name", ["serving", "motion_alerts",
                                  "camera_fleet"])
def test_serving_example(name, tmp_path):
    run_pair(name, tmp_path)
