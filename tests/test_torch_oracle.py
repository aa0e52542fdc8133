"""The port's numpy oracle (``dips_tpu_torch/ops/oracle.py``, a verbatim
copy pinned in tests/test_torch_spec.py) against the JAX package's, and
the port's engines against it, on the CPU.

Cases: the acceptance check's (``validate.CASES`` on ``validate._clip``,
24 x 140) and tests/test_engine_vs_oracle.py's (on ``conftest.make_clip``,
12 x 140).  The two oracles agree exactly: maps, stats and heatmap.  The
port's ``DiPsEngine`` (``device="cpu"``: the kernels' plain twins), in the
ring-carry and the tail protocol, meets test_engine_vs_oracle.py's
contract against the port's oracle: maps within 1 LSB (rare flips where
the math is min/max only), stats atol 1e-5 / rtol 1e-4, changed counts
within 1% of the pixels; and the raw modes' maps and counts exactly.
"""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from dips_tpu import validate as jax_validate
from dips_tpu.ops.oracle import DiPsOracle as JaxOracle
from dips_tpu.properties import DiPsProperties as JaxProps
from dips_tpu.properties import OutputMode as JaxMode
from dips_tpu_torch import DiPsEngine
from dips_tpu_torch.convert import props_from_jax
from dips_tpu_torch.ops.oracle import DiPsOracle
from tests.conftest import make_clip
from tests.test_engine_vs_oracle import CASES as ENGINE_CASES
from tests.test_engine_vs_oracle import assert_close

torch.set_num_threads(1)

#: (id, JAX properties, exact, clip maker)
CASES = [(name, props, exact, jax_validate._clip)
         for name, props, exact in jax_validate.CASES] + [
    (f"{m.name}/{o.name}/{f.name}/w{w}/t{t}/{c.name}",
     JaxProps(method=m, output=o, filter=f, window_size=w, temporal_size=t,
              chroma=c), exact, make_clip)
    for m, o, f, w, t, c, exact in ENGINE_CASES]
IDS = [c[0] for c in CASES]
RAW = (JaxMode.ABSDIFF, JaxMode.THRESHOLD)


@pytest.mark.parametrize("name,jp,exact,clip", CASES, ids=IDS)
def test_oracle_equals_the_jax_oracle(name, jp, exact, clip):
    frames = clip()
    jo, po = JaxOracle(jp), DiPsOracle(props_from_jax(jp))
    (je, js), (pe, ps) = jo.run(frames), po.run(frames)
    np.testing.assert_array_equal(pe, je)
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(po.heatmap, jo.heatmap)


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "tail"])
@pytest.mark.parametrize("name,jp,exact,clip", CASES, ids=IDS)
def test_engine_meets_the_oracle(name, jp, exact, clip, ring):
    frames = clip()
    props = props_from_jax(jp)
    o = DiPsOracle(props)
    exp_out, exp_stats = o.run(frames)
    if exp_out.ndim == 3:
        exp_out = exp_out[..., None]
    eng = DiPsEngine(props, frames.shape[1], frames.shape[2], batch=5,
                     device="cpu", ring_carry=ring)
    got_out, got_stats = eng.process_frames(list(frames))
    assert_close(exp_out, exp_stats, got_out, got_stats, exact,
                 frames.shape[1] * frames.shape[2])
    if jp.output in RAW:
        np.testing.assert_array_equal(got_out, exp_out)
        np.testing.assert_array_equal(got_stats[:, 3], exp_stats[:, 3])
    np.testing.assert_allclose(eng.heatmap(), o.heatmap, atol=1e-3)
