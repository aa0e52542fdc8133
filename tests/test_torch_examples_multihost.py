"""The port's multi-host example (9) against the JAX package's, on the CPU.

The JAX example joins two processes with ``jax.distributed`` (4 virtual
CPU devices each); the port's joins two with ``torch.distributed`` over
gloo (4 CPU cells each).  Both exit 0 within 180 s, and their stdout
passes ``dips_tpu_torch.examples._compare``: the two workers' lines are
cut apart where they share a line, JAX's gloo connection log is dropped,
and the lines compare as a multiset (the workers print in either order).
"""

from tests.test_torch_examples import run_pair


def test_multi_host(tmp_path):
    run_pair("multi_host", tmp_path)
