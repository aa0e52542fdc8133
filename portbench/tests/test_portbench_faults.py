"""The check has to fail what it exists to catch.

The control (the reference in the next precision below the
configuration's, in the program's place) comes out as not correct; and a
run with the timed path broken underneath comes out as not correct, once
for each fault a cell can have: a step that returns its state unchanged,
half of the batch left out, an answer altered where it is produced.  (No
cell spans several chips, so none has an exchange between chips to leave
out.)  The same runs unbroken come out as correct.  All at a test size on
the CPU, through the harness, with the port's plain kernel twins.
"""

import pytest

from portbench.control import readings
from portbench.drivers import serve_cams
from portbench.tests.smallcells import run_small, small
from portbench.tests.faults import FAULTS, plant

ENGINE_CELLS = ("absdiff_1080p.stream16", "colorize_1080p.stream16",
                "absdiff_1080p.fleet8")
SERVE_CELL = "colorize_1080p.cams8"


@pytest.mark.parametrize("cell", ENGINE_CELLS)
def test_sound_run_is_correct(cell):
    assert run_small(cell)["correct"] is True


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", ENGINE_CELLS)
def test_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    plant(monkeypatch.setattr, fault)
    line = run_small(cell)
    assert line["correct"] is False, line["checks"]


def test_serving_sound_run_is_correct():
    assert run_small(SERVE_CELL, seconds=1.5)["correct"] is True


@pytest.mark.parametrize("fault", FAULTS)
def test_serving_broken_in_the_daemon_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(serve_cams, "DAEMON_MODULE",
                        "portbench.tests.broken_daemon")
    monkeypatch.setenv("PORTBENCH_FAULT", fault)
    line = run_small(SERVE_CELL, seconds=1.5)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", ENGINE_CELLS + (SERVE_CELL,))
def test_control_is_not_correct(cell):
    c, cfg = small(cell, height=96, width=160, batch=8)
    for seed in (11, 12, 13):
        r = readings(c, cfg, seed, frames=64, streams=2)
        assert r["correct"] is False, r
        assert r["maps_lsb"] > c["limits"]["maps_lsb"]


def test_the_reference_at_full_precision_is_correct():
    c, cfg = small("colorize_1080p.stream16", height=96, width=160, batch=8)
    r = readings(c, cfg, 5, frames=64, streams=1, precision="full")
    assert r["correct"] is True, r
