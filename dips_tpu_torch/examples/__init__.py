"""The JAX package's nine examples (``examples/*.py``) on the port.

Each has its counterpart's name, story, geometry, seeds, frame counts and
printed lines; only the device handling differs.  With no flag an example
runs on the card and, without one, exits 1 with the ``DeviceError`` (there
is no fallback); ``--cpu`` runs every engine, server and analyzer on
``device="cpu"`` (the kernels' plain twins) and, where the JAX example
spread itself over 8 virtual devices, on 8 CPU cells.  None sets
``XLA_FLAGS`` or imports jax.

    python -m dips_tpu_torch.examples.single_video [--cpu]
    python dips_tpu_torch/examples/single_video.py [--cpu]

``_compare.py`` holds two runs' printed lines against each other (the
port's against the JAX example's, or a card run against a ``--cpu`` run).
"""

import sys


def example_device(cpu: bool) -> str:
    """"cpu" under ``--cpu``, else the card ("cuda:N"); without a card
    this raises :class:`DeviceError`."""
    if cpu:
        return "cpu"
    from dips_tpu_torch.models.pipeline import resolve_device
    return str(resolve_device("cuda"))


def run(main) -> int:
    """``main()``'s exit code (None is 0); a ``DeviceError`` is printed on
    stderr and exits 1, as the port's CLI does."""
    from dips_tpu_torch.errors import DeviceError
    try:
        rc = main()
    except DeviceError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0 if rc is None else rc
