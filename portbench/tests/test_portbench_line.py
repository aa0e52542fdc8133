"""The last line of a run: exactly the contract's keys, the cell's
metrics, the checks last; and a run on the card (marked)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.tests.smallcells import run_small

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_line_of_an_untraced_run():
    line = run_small("absdiff_1080p.stream16")
    assert list(line) == KEYS
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == {"maps_lsb", "stats_gap", "heat_gap",
                                   "base_gap"}
    json.dumps(line)


def test_line_of_a_traced_run():
    line = run_small("colorize_1080p.stream16", trace=True, seconds=1.5)
    assert list(line) == KEYS[:5] + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    # per-layer metrics only; the CPU has no device trace to read
    assert set(line["metrics"]) <= {"engine.dispatch_ms", "copy.d2h_ms",
                                    "median_ring_roofline",
                                    "device.idle_share"}
    assert "engine.dispatch_ms" in line["metrics"]


def test_no_card_no_result():
    """Without a CUDA device the command prints no result and fails."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                        "absdiff_1080p.stream16", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_unknown_cell_no_result():
    p = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                        "no_such.cell", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.gpu
def test_a_cell_on_the_card(card):
    p = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                        "absdiff_1080p.stream16", "--seed", "7",
                        "--seconds", "2", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["kind"] == card
