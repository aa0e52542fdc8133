"""The benchmark's downscaled cell (``colorize_4k_ds2.stream16``, driver
``engine_stream_pooled``) at a test size on the CPU, through the harness,
with the port's plain kernel twins: ``correct`` on a sound run, not
correct with the decimation broken (a rounding flipped, a frame left
unpooled; or, from the second batch on, a rounding flipped or the frames
shifted by one, which spare the baseline) or with the bf16 control in the
program's place; the counts of
``roofline_pool`` by hand; the cell's two readers with nothing to read;
and the files as ``BENCHMARK.json`` lists them."""

import ast
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import control
from portbench import run as harness
from portbench.frames import make_pool
from portbench.record import Run
from portbench.reference.pool import pool_frame, pool_frames
from portbench.roofline import HBM_BYTES_PER_S
from portbench.roofline_pool import pool_launch

ROOT = Path(__file__).resolve().parents[1]
CELL = "colorize_4k_ds2.stream16"
#: the cell's lists in BENCHMARK.json
LISTED = ("frames_per_s", "engine.dispatch_ms", "copy.d2h_ms",
          "median_ring_roofline", "device.idle_share", "engine.pool_ms",
          "pool_prep_roofline")


def small(height=48, width=80, batch=4):
    """(cell, config) of the cell at a test size: the analysis size and
    the input size k times it."""
    cell, cfg = harness.cell_files(CELL)
    cell = json.loads(json.dumps(cell))
    k = int(cfg["downscale"])
    cfg = dict(cfg, height=height, width=width, batch=batch,
               input_height=k * height, input_width=k * width)
    cell["traffic"].update(object_px=[6, 16], trace_after_s=0.2)
    return cell, cfg


def run_cell(trace=False, seconds=1.0, seed=2 ** 33 + 11):
    harness.pin_environment()
    cell, cfg = small()
    return harness.execute(CELL, seed, seconds, trace, device="cpu",
                           cell=cell, config=cfg, t0=time.perf_counter())


def test_sound_run_is_correct():
    line = run_cell()
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
    assert set(line["checks"]) == {"maps_lsb", "stats_gap", "heat_gap",
                                   "base_gap"}
    assert line["attempted"] > 0 and line["failed"] == 0


def test_traced_line_leaves_out_what_the_cpu_cannot_read():
    """No device trace and no device time on the CPU: the kernel's share
    and the pool's device time are left out, the engine's host side is
    read from its stage timers."""
    line = run_cell(trace=True, seconds=1.5)
    assert line["correct"] is True, line["checks"]
    assert "engine.dispatch_ms" in line["metrics"]
    assert "engine.pool_ms" not in line["metrics"]
    assert "pool_prep_roofline" not in line["metrics"]


def _box_mean(frames, out, k, rounding=torch.round):
    """The box mean written into the planar rows, rounded by
    ``rounding``."""
    h, w = frames.shape[-3] // k, frames.shape[-2] // k
    s = frames.reshape(frames.shape[:-3] + (h, k, w, k, 3)).sum(
        dim=(-4, -2), dtype=torch.int32)
    v = rounding(s.to(torch.float32) * float(np.float32(1 / (k * k))))
    out[..., :h, :w] = v.to(torch.uint8).movedim(-1, -3)
    return out


def _flipped(frames, out, k, swap_rb=False):
    """The box mean rounded half up in place of half to even."""
    return _box_mean(frames, out, k, lambda v: torch.floor(v + 0.5))


def _unpooled(frames, out, k, swap_rb=False):
    """The frame's top-left corner, not its box mean."""
    h, w = frames.shape[-3] // k, frames.shape[-2] // k
    out[..., :h, :w] = frames[..., :h, :w, :].movedim(-1, -3)
    return out


def _shifted(frames, out, k, swap_rb=False):
    """Each row pooled from the frame before it (a frame offset off by
    one; the first row from the batch's last frame)."""
    return _box_mean(frames.roll(1, dims=0), out, k)


def _plant(monkeypatch, pool, sound_calls=0):
    """The engine made in the run takes ``pool(frames, out, k, swap_rb)``
    as its box mean (its plain prep's, on the CPU), after its first
    ``sound_calls`` batches pooled soundly."""
    from dips_tpu_torch.ops import reference
    real, calls = reference.make_layout_prep, [0]

    def make(layout, height, width, hp, wp, downscale=1):
        swap, prep = real(layout, height, width, hp, wp, downscale=downscale)
        if downscale == 1:
            return swap, prep

        def planted(x, out):
            calls[0] += 1
            if calls[0] <= sound_calls:
                return prep(x, out=out)
            return pool(x, out, downscale, swap)
        return swap, planted

    monkeypatch.setattr(reference, "make_layout_prep", make)


@pytest.mark.parametrize("fault", [_flipped, _unpooled],
                         ids=["rounding_flipped", "unpooled"])
def test_a_broken_pool_is_not_correct(monkeypatch, fault):
    _plant(monkeypatch, fault)
    line = run_cell()
    assert line["correct"] is False, line["checks"]
    assert line["checks"]["base_gap"]["value"] > 0


@pytest.mark.parametrize("fault", [_flipped, _shifted],
                         ids=["rounding_flipped", "frames_shifted"])
def test_a_pool_broken_after_the_first_batch_is_not_correct(monkeypatch,
                                                            fault):
    """The first batch, which pins the baseline, pooled soundly and every
    later one broken: ``base_gap`` reads 0, and the maps, stats and
    heatmap checks catch it."""
    _plant(monkeypatch, fault, sound_calls=1)
    line = run_cell()
    checks = line["checks"]
    assert line["correct"] is False, checks
    assert checks["base_gap"]["value"] == 0, checks
    assert checks["heat_gap"]["value"] > checks["heat_gap"]["limit"]
    assert any(checks[n]["value"] > checks[n]["limit"]
               for n in ("maps_lsb", "stats_gap")), checks


def test_control_is_not_correct(monkeypatch):
    """The reference at bf16 in the program's place, on the cell's pooled
    frames, fails the cell's limits."""
    cell, cfg = small(height=96, width=160, batch=8)
    k = int(cfg["downscale"])
    monkeypatch.setattr(control, "make_pool", lambda seed, h, w, traffic:
                        pool_frames(make_pool(seed, k * h, k * w, traffic),
                                    k))
    for seed in (21, 22):
        r = control.readings(cell, cfg, seed, frames=64)
        assert r["correct"] is False, r
        assert r["maps_lsb"] > cell["limits"]["maps_lsb"]
        full = control.readings(cell, cfg, seed, frames=64,
                                precision="full")
        assert full["correct"] is True, full


def test_frozen_pool_rounds_half_to_even():
    f = np.zeros((2, 6, 3), np.uint8)
    f[:, 0:2, 0] = [[1, 1], [0, 0]]      # 0.5 -> 0
    f[:, 2:4, 0] = [[3, 3], [0, 0]]      # 1.5 -> 2
    f[:, 4:6, 1] = [[255, 255], [255, 253]]  # 254.5 -> 254
    out = pool_frame(f, 2)
    assert out.shape == (1, 3, 3)
    assert [int(out[0, 0, 0]), int(out[0, 1, 0]), int(out[0, 2, 1])] == [
        0, 2, 254]
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (3, 18, 30, 3), np.uint8)
    got = pool_frames(frames, 3)
    assert got.shape == (3, 6, 10, 3)
    exact = frames.astype(np.float64).reshape(3, 6, 3, 10, 3, 3).mean(
        axis=(2, 4))
    assert np.abs(got - exact).max() <= 0.5


def test_roofline_pool_counts_by_hand():
    """4K at k = 2, B = 16: 12 bytes read and 3 written, 3 x (3 adds + a
    multiply + a rounding) operations, an output pixel."""
    c = pool_launch(1080, 1920, 2, 16)
    px = 16 * 1080 * 1920
    assert c["bytes"] == 15 * px == 497_664_000
    assert c["ops"] == 15 * px
    assert c["bound"] == "bytes"
    assert c["least_s"] == pytest.approx(497_664_000 / 3.35e12)
    c3 = pool_launch(2, 5, 3, 1)
    assert (c3["bytes"], c3["ops"]) == (10 * (27 + 3), 10 * 3 * 10)
    assert c3["least_s"] == pytest.approx(300 / HBM_BYTES_PER_S)


def _reader(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"m_{name.replace('.', '_')}",
        ROOT / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_readers_read_nothing_without_counters_or_kernel():
    cell, cfg = harness.cell_files(CELL)
    pool_ms, roofline = _reader("engine.pool_ms"), _reader(
        "pool_prep_roofline")
    run = Run(cell=cell, config=cfg)
    assert pool_ms(run) is None and roofline(run) is None
    run.timers = {"totals": {"dispatch": 1.0}, "counts": {"dispatch": 4}}
    assert pool_ms(run) is None  # a program without pool_counts
    run.timers["pool"] = {"batches": 0, "frames": 0, "planes": 0,
                          "device_ms": 0.0}
    assert pool_ms(run) is None
    run.timers["pool"] = {"batches": 4, "frames": 64, "planes": 192,
                          "device_ms": 1.0}
    assert pool_ms(run) == 0.25
    run.device_iv = [("median_ring_kernel", 10.0, 30.0),
                     ("elementwise_kernel", 30.0, 40.0)]
    run.trace_lo, run.trace_hi = 0.0, 100.0
    assert roofline(run) is None  # the plain chain: no pool kernel
    run.device_iv += [("void pool_prep_kernel(...)", 40.0, 340.0),
                      ("void pool_prep_kernel(...)", 400.0, 600.0)]
    least = pool_launch(1080, 1920, 2, 16)["least_s"]
    run.trace_hi = 1000.0
    assert roofline(run) == pytest.approx(100 * least / 250e-6)


def test_the_cell_as_benchmark_json_lists_it():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, cfg = harness.cell_files(CELL)
    entry, = [w for w in bench["workloads"] if w["name"] == CELL]
    assert (entry["config"], entry["traffic"], entry["chips"]) == (
        "colorize_4k_ds2", "stream16", 1)
    conf, = [c for c in bench["configs"] if c["name"] == "colorize_4k_ds2"]
    assert conf["reduced"] == cfg["reduced"] == []
    assert conf["source"] == cfg["source"]
    assert (cfg["input_height"], cfg["input_width"]) == (
        cfg["downscale"] * cfg["height"], cfg["downscale"] * cfg["width"])
    metrics = bench["end_to_end"] + bench["per_layer"]
    listed = {m["name"] for m in metrics if CELL in m.get("workloads", [])}
    assert listed == set(LISTED)
    assert [m for m in harness.metric_entries(bench, CELL, False)] == [
        m for m in bench["end_to_end"] if m["name"] in ("frames_per_s",
                                                        "setup_s")]


def test_the_frozen_pool_imports_numpy_alone():
    path = ROOT / "portbench" / "reference" / "pool.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "numpy"}, names
