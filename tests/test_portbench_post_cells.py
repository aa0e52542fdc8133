"""The benchmark's post-analysis cell (``colorize_4k_denoise.stream16``,
driver ``run_stream``) and the colourised fleet (``colorize_1080p.fleet8``)
at a test size on the CPU, through the harness, with the port's plain
kernel twins: the result line's keys, ``correct`` on a sound run, and not
correct with the timed path broken (an undenoised map, and the faults of
``portbench/tests/faults.py``) or with the bf16 control in the program's
place."""

import pytest

from portbench import control, control_post
from portbench import run as harness
from portbench.tests.faults import FAULTS, plant
from portbench.tests.smallcells import small

POST = "colorize_4k_denoise.stream16"
FLEET = "colorize_1080p.fleet8"
#: a radius below the test size's half-width, so the low-pass does work
RADIUS = 8


def small_post(**kw):
    cell, cfg = small(POST, **kw)
    cfg["post"] = dict(cfg["post"], denoise_radius=RADIUS)
    return cell, cfg


def run_cell(name, trace=False, seconds=1.0, seed=2 ** 33 + 7):
    import time
    harness.pin_environment()
    cell, cfg = (small_post(height=64, width=96) if name == POST
                 else small(name))
    return harness.execute(name, seed, seconds, trace, device="cpu",
                           cell=cell, config=cfg, t0=time.perf_counter())


def test_post_cell_line_and_checks():
    line = run_cell(POST)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
    assert set(line["checks"]) == {"maps_lsb", "flip_share", "stats_gap",
                                   "heat_gap", "base_gap", "dft_gap"}
    assert line["attempted"] > 0 and line["failed"] == 0


def test_post_cell_traced_line():
    """The CPU has no device trace and no device time: the denoise's
    metrics are left out, not read from the host; the engine's host side
    (``engine.dispatch_ms``) is read from its stage timers."""
    line = run_cell(POST, trace=True, seconds=1.5)
    assert line["correct"] is True, line["checks"]
    assert "breakdown" in line
    assert set(line["metrics"]) <= {"engine.dispatch_ms", "copy.d2h_ms",
                                    "median_ring_roofline",
                                    "device.idle_share", "engine.denoise_ms",
                                    "denoise_fft_roofline"}
    # the engine's own stage timers are read on any device
    assert "engine.dispatch_ms" in line["metrics"]
    assert "engine.denoise_ms" not in line["metrics"]
    assert "denoise_fft_roofline" not in line["metrics"]


def test_an_undenoised_map_is_not_correct(monkeypatch):
    from dips_tpu_torch.ops import analysis
    monkeypatch.setattr(analysis, "denoise_planes",
                        lambda planes, mask: planes.contiguous())
    line = run_cell(POST)
    assert line["correct"] is False
    assert line["checks"]["maps_lsb"]["value"] > 1


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", [POST, FLEET])
def test_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    plant(monkeypatch.setattr, fault)
    line = run_cell(cell)
    assert line["correct"] is False, line["checks"]


def test_fleet_cell_is_correct():
    line = run_cell(FLEET)
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == {"maps_lsb", "stats_gap", "heat_gap",
                                   "base_gap", "missing"}


def test_controls_are_not_correct():
    cell, cfg = small_post(height=96, width=128, batch=8)
    for seed in (11, 12):
        r = control_post.readings(cell, cfg, seed, frames=32)
        assert r["correct"] is False, r
        assert r["flip_share"] > cell["limits"]["flip_share"]
        # each step alone in bf16 fails too: the denoise of the
        # reference's own maps, and the DFT of the control's own series
        assert r["alone_flip_share"] > cell["limits"]["flip_share"]
        assert r["dft_gap"] > cell["limits"]["dft_gap"]
    c, g = small(FLEET, height=96, width=160, batch=8)
    r = control.readings(c, g, 13, frames=64, streams=2)
    assert r["correct"] is False and r["maps_lsb"] > c["limits"]["maps_lsb"]


def test_the_post_reference_at_full_precision_is_correct():
    cell, cfg = small_post(height=96, width=128, batch=8)
    r = control_post.readings(cell, cfg, 5, frames=32, precision="full")
    assert r["correct"] is True, r


def test_transform_bytes_by_hand():
    from portbench.roofline_post import denoise_transforms
    r = denoise_transforms(2160, 3840, 48)
    # (4 + 4) forward (the half spectrum) + (8 + 8) inverse bytes a
    # pixel, 48 4K planes
    assert r["bytes"] == 24 * 2160 * 3840 * 48 == 9_555_148_800
    assert r["least_s"] == pytest.approx(9_555_148_800 / 3.35e12)
    assert r["bound"] == "bytes"


def test_readers_leave_the_metrics_out_without_counters():
    """On an engine without denoise counters (the parent's round trip) the
    two readers return None, with or without cuFFT kernels in the trace."""
    from portbench.record import Run
    cell, cfg = harness.cell_files(POST)
    run = Run(cell=cell, config=cfg, timers={"totals": {}, "counts": {}},
              device_iv=[("void regular_fft<2160u>(x)", 0.0, 500.0)],
              trace_lo=0.0, trace_hi=1000.0, trace_batches=1)
    assert harness.read_metric("engine.denoise_ms", run) is None
    assert harness.read_metric("denoise_fft_roofline", run) is None
    run.timers["denoise"] = {"batches": 2, "frames": 32, "planes": 96,
                             "device_ms": 70.0}
    assert harness.read_metric("engine.denoise_ms", run) == 35.0
    # the least time of the counted planes over the traced cuFFT time
    got = harness.read_metric("denoise_fft_roofline", run)
    assert got == pytest.approx(100 * 24 * 2160 * 3840 * 96 / 3.35e12
                                / 500e-6)


@pytest.mark.parametrize("name,match", [
    ("void regular_fft<2160u, EPT<6u, 10u>, 2u, 2u, (padding_t)14>(k)", True),
    ("void vector_fft<3840u, EPT<15u>, 1u, 0u, (padding_t)14>(k)", True),
    ("void at::native::_fft_conjugate_copy_kernel<float>(x)", False),
    ("void (anonymous namespace)::median_ring_kernel<3, 0, false>(a, b)",
     False),
    ("abs_kernel_vectorized2_kernel", False),
    ("Memcpy DtoH (Device -> Pinned)", False)])
def test_cufft_kernels_by_name(name, match):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "roof", harness.PKG / "metrics" / "denoise_fft_roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.is_cufft(name) is match
