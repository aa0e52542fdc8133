"""The port's copies of the pure-Python spec modules stay pinned to the
originals, and the port imports without jax.

``dips_tpu_torch`` carries its own copies of ``properties``, ``errors`` and
``ops/networks`` because importing any ``dips_tpu`` module imports jax
(``dips_tpu/__init__.py``).  These tests hold each copy to its original,
byte for byte and by behaviour.
"""

import difflib
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
                                 "ops/networks.py", "ops/refresh.py",
                                 "serve/protocol.py", "serve/metrics.py",
                                 "serve/client.py", "serve/sessions.py",
                                 "serve/__main__.py", "utils/webhook.py",
                                 "loadgen.py", "utils/indexing.py",
                                 "io/synthetic.py", "io/datfiles.py",
                                 "io/subsample.py", "io/thumbnail.py",
                                 "io/eventrecorder.py", "io/gstbind.py",
                                 "io/gstreamer.py", "utils/__init__.py",
                                 "native/Makefile", "ops/oracle.py"])
def test_spec_copy_is_verbatim(rel):
    assert (ROOT / "dips_tpu_torch" / rel).read_bytes() == \
        (ROOT / "dips_tpu" / rel).read_bytes()


def test_events_copy_is_verbatim_but_its_import():
    """``ops/events.py`` takes STAT_NAMES from the port's
    ``ops/reference.py`` (the original's ``ops/oracle`` imports jax);
    every other line is the original's."""
    port = (ROOT / "dips_tpu_torch/ops/events.py").read_text().splitlines()
    orig = (ROOT / "dips_tpu/ops/events.py").read_text().splitlines()
    assert len(port) == len(orig)
    diff = [(a, b) for a, b in zip(port, orig) if a != b]
    assert diff == [("from .reference import STAT_NAMES",
                     "from .oracle import STAT_NAMES")]


def test_serve_analytics_copy_is_verbatim_but_its_device():
    """``serve/analytics.py`` builds a session's flicker analyzer on the
    session engine's device (the port's analyzers default to the card);
    every other line is the original's."""
    port = (ROOT / "dips_tpu_torch/serve/analytics.py").read_text()
    orig = (ROOT / "dips_tpu/serve/analytics.py").read_text()
    port, orig = port.splitlines(), orig.splitlines()
    assert len(port) == len(orig)
    diff = [(a.strip(), b.strip()) for a, b in zip(port, orig) if a != b]
    assert diff == [("batch=eng.batch, device=eng.device)",
                     "batch=eng.batch)")]


@pytest.mark.parametrize("rel", ["serve/server.py", "serve/coalesce.py",
                                 "serve/daemon.py", "serve/__init__.py",
                                 "report.py", "live.py", "gui.py",
                                 "native/__init__.py",
                                 "native/framepump.cpp"])
def test_serve_near_copy_differs_only_by_its_listed_lines(rel):
    """The port's near-copies of JAX modules (the serving modules, the
    report, the live preview, the Tk frontend and the framepump binding)
    differ from the originals only by the lines listed in
    ``tests/forks/<module>.diff`` (``difflib.unified_diff`` without
    context): ``backend`` becoming ``device``, NUM_STATS / STAT_NAMES from
    ``ops/reference``, the coalescer's mesh on the server's device, each
    coalesced slot's results copied out of the fleet's download, the
    reply's stall deadline, the daemon's error exit, the GUI's card check,
    the port's command and logger names, the framepump build under a
    directory lock, the framepump's gather copier on a pool of host
    threads (``fp_copy_pieces``, ``copy_pieces``), and their comments.  A change on either side that the list
    does not hold fails here; a deliberate one rewrites the list."""
    orig = (ROOT / "dips_tpu" / rel).read_text().splitlines(keepends=True)
    port = (ROOT / "dips_tpu_torch" / rel).read_text().splitlines(
        keepends=True)
    got = "".join(difflib.unified_diff(orig, port, f"dips_tpu/{rel}",
                                       f"dips_tpu_torch/{rel}", n=0))
    listed = ROOT / "tests" / "forks" / (rel.replace("/", "_") + ".diff")
    assert got == listed.read_text()


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
        assert f"void csort{w}(" in src and f"int wmerge{w}(" in src
    assert "wmed" not in src  # the per-pixel column sorts are gone
    for t in range(1, _build.MAX_T + 1):
        assert f"case {t}:" in src
    # every comparator of the w=7 plan is emitted, the column sort once
    col, merge, target = port_networks.column_median_plan(7)

    def body(name):
        b = src[src.index(f" {name}("):]
        return b[:b.index("\n}\n")]

    def n_ops(b):
        return b.count("min(") + b.count("max(")

    assert n_ops(body("csort7")) == 2 * len(col)
    assert n_ops(body("wmerge7")) == sum(nm + nx for _, _, nm, nx in merge)
    assert body("wmerge7").rstrip().endswith(f"return v{target};")


def test_port_imports_without_jax():
    """Import every module of the port with jax made unimportable
    (``native/libframepump.so``, which pkgutil lists as a module, is the
    C library that ``native`` loads with ctypes)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import dips_tpu_torch\n"
        "for m in pkgutil.walk_packages(dips_tpu_torch.__path__, "
        "'dips_tpu_torch.'):\n"
        "    if not m.name.endswith(('.__main__', '.libframepump')):\n"
        "        importlib.import_module(m.name)\n"
        "from dips_tpu_torch.parallel.multistream import MultiStreamEngine\n"
        "from dips_tpu_torch.app import run_dips_on_files\n"
        "bad = sorted(k for k in sys.modules if k == 'dips_tpu' or "
        "k.startswith(('dips_tpu.', 'jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


#: every module of the port, its examples included (one case each)
PORT_MODULES = sorted(p.relative_to(ROOT / "dips_tpu_torch").as_posix()
                      for p in (ROOT / "dips_tpu_torch").rglob("*.py"))


@pytest.mark.parametrize("rel", PORT_MODULES)
def test_module_imports_nothing_of_jax(rel):
    """No module of the port, examples included, imports jax or the JAX
    package."""
    src = (ROOT / "dips_tpu_torch" / rel).read_text()
    for line in src.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            assert "jax" not in s and "dips_tpu." not in s \
                and not s.endswith(" dips_tpu"), s


def test_serve_imports_no_jax_module():
    """``import dips_tpu_torch.serve`` (and the load generator, and the
    run path: the app, CLI, live preview, GUI, report and every ``io``
    module) loads no module of jax or of the JAX package, with both
    installed."""
    code = ("import sys\n"
            "import dips_tpu_torch.serve, dips_tpu_torch.loadgen\n"
            "import dips_tpu_torch.app, dips_tpu_torch.cli\n"
            "import dips_tpu_torch.live, dips_tpu_torch.gui\n"
            "import dips_tpu_torch.report, dips_tpu_torch.utils.indexing\n"
            "import dips_tpu_torch.utils.profiling\n"
            "import dips_tpu_torch.native, dips_tpu_torch.doctor\n"
            "import dips_tpu_torch.autotune, dips_tpu_torch.ops.tuning\n"
            "import dips_tpu_torch.utils.compilecache\n"
            "from dips_tpu_torch.io import (video, gstreamer, synthetic,\n"
            "    datfiles, subsample, thumbnail, eventrecorder, gstbind)\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'dips_tpu')))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_require_matplotlib_copy_is_verbatim():
    """``report._require_matplotlib`` is the original's source and
    behaves alike, with matplotlib and without it."""
    import inspect

    import dips_tpu.report as jax_report
    import dips_tpu_torch.report as port_report
    assert inspect.getsource(port_report._require_matplotlib) == \
        inspect.getsource(jax_report._require_matplotlib)
    code = ("import sys\n"
            "sys.modules['matplotlib'] = None\n"
            "from dips_tpu_torch.report import _require_matplotlib\n"
            "try:\n"
            "    _require_matplotlib()\n"
            "except RuntimeError as e:\n"
            "    print(e)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "chart rendering needs matplotlib" in res.stdout
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return
    assert port_report._require_matplotlib().get_backend().lower() == "agg"


def test_chip_smoke_imports_nothing_of_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    for line in src.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            assert "jax" not in s and "dips_tpu." not in s \
                and not s.endswith(" dips_tpu"), s


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_engine_refuses_a_missing_card(device):
    """No CPU fallback: without a card the default device raises too."""
    from dips_tpu_torch import DiPsEngine, DiPsProperties, DeviceError
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    kw = {} if device is None else dict(device=device)
    with pytest.raises(DeviceError):
        DiPsEngine(DiPsProperties(), 12, 140, **kw)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_fleet_refuses_a_missing_card(device):
    from dips_tpu_torch import DeviceError, DiPsProperties, MultiStreamEngine
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    kw = {} if device is None else dict(device=device)
    with pytest.raises(DeviceError):
        MultiStreamEngine(DiPsProperties(), 12, 140, 3, **kw)


def test_job_defaults_to_the_card():
    from dips_tpu_torch.app import DiPsJob
    from dips_tpu_torch.cli import build_parser
    assert DiPsJob().device == "cuda"
    assert build_parser().parse_args([]).device == "cuda"


def test_cli_without_a_card_fails(tmp_path, capsys):
    """No --device and no card: exit 1 with the DeviceError's message, on
    the file and the fleet paths."""
    import cv2
    import dips_tpu_torch.cli
    from tests.conftest import make_clip
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    src = str(tmp_path / "in.avi")
    vw = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"MJPG"), 10, (32, 16))
    for f in make_clip(n=3, h=16, w=32):
        vw.write(f[..., ::-1])
    vw.release()
    for argv in (["--input", src, "--output", str(tmp_path / "out.avi")],
                 ["--inputs", src, src, "--output-dir", str(tmp_path)]):
        assert dips_tpu_torch.cli.main(argv) == 1
        assert "no CUDA device" in capsys.readouterr().err


#: the engine options ported in the options slice, each with a use the
#: JAX engines refuse (ValueError in both packages)
OPTION_MISUSE = {"packed_wire": dict(packed_wire=True),
                 "downscale": dict(downscale=3),
                 "input_layout": dict(input_layout="bogus")}


@pytest.mark.parametrize("kwargs", [dict(packed_wire=True),
                                    dict(downscale=2),
                                    dict(input_layout="planar")])
def test_unported_engine_options_raise(kwargs):
    """Once unported (NotImplementedError), these options now build an
    engine and raise only where the JAX engine raises: packed_wire off
    THRESHOLD, a downscale that does not divide the geometry, an unknown
    layout."""
    from dips_tpu.models import DiPsEngine as JaxEngine
    from dips_tpu_torch import DiPsEngine, DiPsProperties, OutputMode
    props = DiPsProperties(output=OutputMode.THRESHOLD)
    eng = DiPsEngine(props, 12, 140, device="cpu", **kwargs)
    assert (eng.in_height, eng.in_width) == (12, 140)
    assert (eng.height, eng.width) == (
        (6, 70) if kwargs.get("downscale") else (12, 140))
    bad = OPTION_MISUSE[next(iter(kwargs))]
    with pytest.raises(ValueError):
        JaxEngine(jax_props.DiPsProperties(), 12, 140, backend="xla", **bad)
    with pytest.raises(ValueError):
        DiPsEngine(DiPsProperties(), 12, 140, device="cpu", **bad)


@pytest.mark.parametrize("kwargs", [dict(packed_wire=True),
                                    dict(downscale=2),
                                    dict(input_layout="planar")])
def test_unported_fleet_options_raise(kwargs):
    """As the engine's: the fleet takes the options and refuses their
    misuse with ValueError, as the JAX fleet does."""
    from dips_tpu_torch import DiPsProperties, MultiStreamEngine, OutputMode
    props = DiPsProperties(output=OutputMode.THRESHOLD)
    fleet = MultiStreamEngine(props, 12, 140, 3, device="cpu", **kwargs)
    assert fleet.height == (6 if kwargs.get("downscale") else 12)
    with pytest.raises(ValueError):
        MultiStreamEngine(DiPsProperties(), 12, 140, 3, device="cpu",
                          **OPTION_MISUSE[next(iter(kwargs))])


@pytest.mark.parametrize("kwargs", [dict(flicker=dict(freq_hz=5.0)),
                                    dict(downscale=2),
                                    dict(input_layout="planar")])
def test_unported_fleet_run_options_raise(kwargs):
    """Fleet flicker, ``downscale`` and the planar layout are ported: the
    run gets as far as opening the (missing) input."""
    from dips_tpu_torch import VideoPathError, run_dips_on_files
    with pytest.raises(VideoPathError):
        run_dips_on_files(["a.avi"], "out", device="cpu", **kwargs)


@pytest.mark.parametrize("name", ["approx_median", "quirk_compat"])
def test_unported_median_modes_raise(name):
    """Both spatial modes are ported: the step runs (the plain twin on the
    CPU) and counts nothing, and the two modes together raise, as the
    properties do in both packages."""
    from dips_tpu_torch.ops import cuda_fused
    props = port_props.DiPsProperties(**{name: True})
    raw = torch.zeros((2, 3, 16, 256), dtype=torch.uint8)
    plane = torch.zeros((16, 256))
    before = cuda_fused.launch_counts()
    out = cuda_fused.batch_step_ring(props, 12, 140, raw,
                                     torch.zeros((4, 16, 256)), plane.clone(),
                                     plane.clone(), torch.zeros(2, dtype=bool),
                                     plane.clone(), torch.ones(2, dtype=bool),
                                     0, 1)
    assert out[0].shape == (2, 3, 16, 256)
    assert cuda_fused.launch_counts() == before
    assert cuda_fused.spatial_mode(props) == name
    with pytest.raises(ValueError):
        port_props.DiPsProperties(approx_median=True, quirk_compat=True)
    with pytest.raises(ValueError):
        jax_props.DiPsProperties(approx_median=True, quirk_compat=True)


@pytest.mark.parametrize("name", ["unpack_mask", "pack_mask_host",
                                  "unpack_mask_host"])
def test_wire_host_twins_are_verbatim(name):
    """The port's numpy twins of ``ops/wire.py`` behave as the originals:
    ``pack_mask_host`` and ``unpack_mask_host`` are their source, line for
    line; ``unpack_mask`` (a faster broadcast) gives the same bytes."""
    import inspect

    import numpy as np

    import dips_tpu.ops.wire as jax_wire
    import dips_tpu_torch.ops.wire as port_wire
    if name == "unpack_mask":
        p = np.random.default_rng(1).integers(0, 256, (3, 1, 5, 40),
                                              np.uint8)
        np.testing.assert_array_equal(port_wire.unpack_mask(p),
                                      jax_wire.unpack_mask(p))
    else:
        assert inspect.getsource(getattr(port_wire, name)) == \
            inspect.getsource(getattr(jax_wire, name))
    m = np.random.default_rng(0).integers(0, 3, (2, 13, 40)).astype(np.uint8)
    packed = port_wire.pack_mask_host(m)
    np.testing.assert_array_equal(packed, jax_wire.pack_mask_host(m))
    np.testing.assert_array_equal(port_wire.unpack_mask_host(packed, 13),
                                  jax_wire.unpack_mask_host(packed, 13))


def test_stage_timers_copy_is_verbatim():
    """``utils/profiling.StageTimers`` is the original class's source, and
    it reports the same stages."""
    import inspect

    import dips_tpu.utils.profiling as jax_prof
    import dips_tpu_torch.utils.profiling as port_prof
    assert inspect.getsource(port_prof.StageTimers) == \
        inspect.getsource(jax_prof.StageTimers)
    timers = port_prof.StageTimers()
    with timers.stage("d2h"):
        pass
    timers.add_frames(3)
    summary = timers.summary()
    assert summary["d2h"]["calls"] == 1
    assert summary["_overall"]["frames"] == 3
    assert str(timers).startswith("StageTimers:")


def test_pool_frame_host_matches_original():
    """``reference.pool_frame_host`` against the JAX package's, on random
    frames for k = 1..4 and on a hand-computed case (round half to
    even)."""
    import numpy as np

    from dips_tpu.ops import reference as jref
    from dips_tpu_torch.ops import reference as tref
    rng = np.random.default_rng(1)
    for k in (1, 2, 3, 4):
        f = rng.integers(0, 256, (6 * k, 10 * k, 3), np.uint8)
        np.testing.assert_array_equal(tref.pool_frame_host(f, k),
                                      jref.pool_frame_host(f, k))
    f = np.zeros((2, 2, 3), np.uint8)
    f[..., 0] = [[10, 20], [30, 40]]          # mean 25
    f[..., 1] = [[1, 0], [0, 0]]              # mean 0.25 -> 0
    f[..., 2] = [[1, 1], [0, 0]]              # mean 0.5 -> 0 (half to even)
    assert list(tref.pool_frame_host(f, 2)[0, 0]) == [25, 0, 0]


def test_port_imports_without_cv2():
    """OpenCV stays a lazy import: the package, the run path, the CLI and
    the live preview import with cv2 made unimportable, and the cv2
    names of ``io`` resolve only when used."""
    code = ("import sys\n"
            "sys.modules['cv2'] = None\n"
            "import dips_tpu_torch, dips_tpu_torch.io\n"
            "import dips_tpu_torch.app, dips_tpu_torch.cli\n"
            "import dips_tpu_torch.live, dips_tpu_torch.gui\n"
            "import dips_tpu_torch.io.video, dips_tpu_torch.io.gstreamer\n"
            "import dips_tpu_torch.io.eventrecorder\n"
            "assert 'cv2' not in [k for k, v in sys.modules.items() if v]\n"
            "for mod, name in ((dips_tpu_torch, 'extract_thumbnail'),\n"
            "                  (dips_tpu_torch.io, 'extract_thumbnail')):\n"
            "    try:\n"
            "        getattr(mod, name)\n"
            "    except ImportError:\n"
            "        pass\n"
            "    else:\n"
            "        raise SystemExit(name + ' resolved without cv2')\n"
            "print(sorted(dips_tpu_torch.io.__all__))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    import dips_tpu.io as jio
    assert res.stdout.strip() == str(sorted(
        n for n in dir(jio) if not n.startswith("_") and callable(
            getattr(jio, n))))
    import dips_tpu_torch
    import dips_tpu_torch.io.thumbnail as thumb
    assert dips_tpu_torch.extract_thumbnail is thumb.extract_thumbnail
    assert dips_tpu_torch.io.VideoReader is \
        dips_tpu_torch.io.video.VideoReader
    with pytest.raises(AttributeError):
        dips_tpu_torch.io.nothing_here


@pytest.mark.parametrize("name", ["CfrRetimer", "retime_cfr"])
def test_retimer_copy_is_verbatim(name):
    """``io/video.CfrRetimer`` and ``retime_cfr`` are the originals'
    source."""
    import inspect

    import dips_tpu.io.video as jvideo
    import dips_tpu_torch.io.video as tvideo
    assert inspect.getsource(getattr(tvideo, name)) == \
        inspect.getsource(getattr(jvideo, name))


def test_exports_cover_the_jax_package():
    """The package exports the JAX package's names, but the version; its
    ``parallel`` has every name that ``dips_tpu/parallel/__init__.py``
    imports."""
    import ast

    import dips_tpu
    import dips_tpu_torch
    import dips_tpu_torch.parallel
    missing = set(dips_tpu.__all__) - set(dips_tpu_torch.__all__)
    assert missing == {"__version__"}
    for name in dips_tpu_torch.__all__:
        assert getattr(dips_tpu_torch, name) is not None, name
    tree = ast.parse((ROOT / "dips_tpu/parallel/__init__.py").read_text())
    names = {a.asname or a.name for node in ast.walk(tree)
             if isinstance(node, ast.ImportFrom) for a in node.names}
    assert {"make_sharded_step", "make_sharded_ring_step"} <= names
    for name in sorted(names):
        assert callable(getattr(dips_tpu_torch.parallel, name, None)), name


@pytest.mark.parametrize("rel,names", [
    ("autotune.py", ["find_largest_fitting", "_bh_candidates",
                     "_two_point_fit", "main"]),
    ("ops/tuning.py", ["cache_path", "_load", "invalidate", "_device_kind",
                       "device_entry", "save"]),
    ("utils/compilecache.py", ["default_cache_dir", "enable_compile_cache",
                               "add_compile_cache_flag",
                               "apply_compile_cache_flag"])])
def test_tuning_modules_carry_the_jax_names(rel, names):
    """The tuning slice's modules exist beside their JAX counterparts and
    carry the names whose meaning carries over, as callables; the tuner is
    a script of the package, as ``dips-autotune`` is of the JAX one."""
    import importlib
    mod = "." + rel[:-3].replace("/", ".")
    port = importlib.import_module(mod, "dips_tpu_torch")
    orig = importlib.import_module(mod, "dips_tpu")
    for name in names:
        assert callable(getattr(orig, name)), name
        assert callable(getattr(port, name)), name
    toml = (ROOT / "pyproject.toml").read_text()
    assert 'dips-torch-autotune = "dips_tpu_torch.autotune:main"' in toml
    assert 'dips-autotune = "dips_tpu.autotune:main"' in toml
