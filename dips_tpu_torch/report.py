"""Chart rendering support for the CLI's PNG outputs (``--flicker-png``).

Counterpart of ``dips_tpu/report.py``, as far as the port needs it:
:func:`_require_matplotlib`, a verbatim copy (``tests/test_torch_spec.py``
pins it).  matplotlib is optional; without it the PNG flags fail with the
message below.
"""


def _require_matplotlib():
    try:
        import matplotlib
    except ImportError:
        raise RuntimeError(
            "chart rendering needs matplotlib — install the extra: "
            "pip install 'dips-tpu[report]'") from None
    matplotlib.use("Agg")
    return matplotlib
