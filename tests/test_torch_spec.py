"""The port's copies of the pure-Python spec modules stay pinned to the
originals, and the port imports without jax.

``dips_tpu_torch`` carries its own copies of ``properties``, ``errors`` and
``ops/networks`` because importing any ``dips_tpu`` module imports jax
(``dips_tpu/__init__.py``).  These tests hold each copy to its original,
byte for byte and by behaviour.
"""

import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import pytest
import torch

import dips_tpu.ops.networks as jax_networks
import dips_tpu.properties as jax_props
import dips_tpu_torch.ops.networks as port_networks
import dips_tpu_torch.properties as port_props
from dips_tpu_torch.convert import props_from_jax

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("rel", ["properties.py", "errors.py",
                                 "ops/networks.py"])
def test_spec_copy_is_verbatim(rel):
    assert (ROOT / "dips_tpu_torch" / rel).read_bytes() == \
        (ROOT / "dips_tpu" / rel).read_bytes()


PROPS_KW = [
    {},
    dict(window_size=4, temporal_size=99, sigmoid_horizontal_scalar=0.2,
         change_threshold=0),
    dict(method="PER_FRAME", output="GRAYSCALE", filter="INVERSE_SIGMOID",
         chroma="GREEN", window_size=7, refresh_markers=(9, 3, 3)),
    dict(output="THRESHOLD", roi=(1, 2, 10, 20), change_threshold=300),
    dict(output="STATS_ONLY"),
    dict(output="ABSDIFF", emit_maps=False, temporal_size=0),
]


def _kw(mod, kw):
    enums = {"method": mod.DiPsMethod, "output": mod.OutputMode,
             "filter": mod.DiPsFilter, "chroma": mod.ChromaFilter}
    return {k: enums[k][v] if k in enums else v for k, v in kw.items()}


@pytest.mark.parametrize("kw", PROPS_KW)
def test_properties_behave_alike(kw):
    jp = jax_props.DiPsProperties(**_kw(jax_props, kw))
    pp = port_props.DiPsProperties(**_kw(port_props, kw))
    assert props_from_jax(jp) == pp
    for name in ("window_size", "temporal_size", "sigmoid_horizontal_scalar",
                 "change_threshold", "refresh_markers", "out_channels",
                 "colorize", "emit_maps"):
        assert getattr(jp, name) == getattr(pp, name), name
    for h, w in ((12, 140), (1080, 1920)):
        assert jp.roi_bounds(h, w) == pp.roi_bounds(h, w)
        assert jp.analysis_pixels(h, w) == pp.analysis_pixels(h, w)


def test_enum_values_match():
    for name in ("DiPsMethod", "OutputMode", "DiPsFilter", "ChromaFilter",
                 "Encoding"):
        j, p = getattr(jax_props, name), getattr(port_props, name)
        assert [(m.name, m.value) for m in j] == \
            [(m.name, m.value) for m in p]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 9, 16, 25, 49])
def test_networks_match(n):
    assert port_networks.median_network(n) == jax_networks.median_network(n)
    assert port_networks.sorting_network(n) == \
        jax_networks.sorting_network(n)


@pytest.mark.parametrize("w", [3, 5, 7])
def test_window_plans_match(w):
    assert port_networks.column_median_plan(w) == \
        jax_networks.column_median_plan(w)


def test_network_header_covers_every_window_and_ring():
    from dips_tpu_torch.ops import _build
    src = _build.network_header()
    for w in (3, 5, 7):
        assert f"int wmed{w}(" in src
    for t in range(1, _build.MAX_T + 1):
        assert f"case {t}:" in src
    # every comparator of the w=7 plan is emitted
    col, merge, target = port_networks.column_median_plan(7)
    body = src[src.index("int wmed7("):]
    body = body[:body.index("\n}\n")]
    n_ops = body.count("min(") + body.count("max(")
    assert n_ops == 7 * 2 * len(col) + sum(nm + nx for _, _, nm, nx in merge)
    assert body.rstrip().endswith(f"return v{target};")


def test_port_imports_without_jax():
    """Import every module of the port with jax made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import dips_tpu_torch\n"
        "for m in pkgutil.walk_packages(dips_tpu_torch.__path__, "
        "'dips_tpu_torch.'):\n"
        "    if m.name != 'dips_tpu_torch.__main__':\n"
        "        importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'dips_tpu' or "
        "k.startswith(('dips_tpu.', 'jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_imports_nothing_of_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    for line in src.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            assert "jax" not in s and "dips_tpu." not in s \
                and not s.endswith(" dips_tpu"), s


@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_engine_refuses_a_missing_card(device):
    from dips_tpu_torch import DiPsEngine, DiPsProperties, DeviceError
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(DeviceError):
        DiPsEngine(DiPsProperties(), 12, 140, device=device)


@pytest.mark.parametrize("kwargs", [dict(ring_carry=False),
                                    dict(packed_wire=True),
                                    dict(downscale=2),
                                    dict(input_layout="planar")])
def test_unported_engine_options_raise(kwargs):
    from dips_tpu_torch import DiPsEngine, DiPsProperties
    with pytest.raises(NotImplementedError):
        DiPsEngine(DiPsProperties(), 12, 140, device="cpu", **kwargs)


@pytest.mark.parametrize("name", ["approx_median", "quirk_compat"])
def test_unported_median_modes_raise(name):
    from dips_tpu_torch.ops import cuda_fused
    props = port_props.DiPsProperties(**{name: True})
    raw = torch.zeros((2, 3, 16, 256), dtype=torch.uint8)
    plane = torch.zeros((16, 256))
    with pytest.raises(NotImplementedError):
        cuda_fused.batch_step_ring(props, 12, 140, raw,
                                   torch.zeros((4, 16, 256)), plane.clone(),
                                   plane.clone(), torch.zeros(2, dtype=bool),
                                   plane.clone(), torch.ones(2, dtype=bool),
                                   0, 1)
