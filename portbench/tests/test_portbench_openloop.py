"""The serving cell's open loop: the schedule does not slip when the
server stalls, and every request is timed from the moment it was due."""

import time

import numpy as np
import pytest

from portbench.drivers.serve_cams import Camera, phases
from portbench.frames import rng_of


class FakeClient:
    """Replies at once, but stalls once for ``stall_s`` on request
    ``stall_at`` (counted from the first request of the window)."""

    def __init__(self, warm: int, stall_at: int, stall_s: float):
        self.n, self.warm = 0, warm
        self.stall_at, self.stall_s = stall_at, stall_s
        self.sent_at = []

    def process(self, frame):
        self.sent_at.append(time.perf_counter())
        k = self.n - self.warm
        self.n += 1
        if k == self.stall_at:
            time.sleep(self.stall_s)
        return np.zeros((1, 2, 2, 3), np.uint8), np.zeros((1, 4), np.float32)


def drive(period, seconds, stall_at, stall_s, phase=0.0, warm=2):
    client = FakeClient(warm, stall_at, stall_s)
    cam = Camera(client, lambda i: i, warm, 1, rng_of(0))
    cam.start()
    assert cam.warmed.wait(5)
    t_open = time.perf_counter()
    cam.schedule = (t_open, phase, period, t_open + seconds)
    cam.go.set()
    cam.join(10)
    assert not cam.is_alive() and cam.error is None
    return cam, client, t_open


def test_every_due_request_is_sent_once():
    period, seconds = 0.05, 1.0
    cam, client, _ = drive(period, seconds, stall_at=3, stall_s=0.4)
    due = int(np.ceil(seconds / period))
    assert len(cam.late_ms) == due == len(cam.reply_ms)
    assert client.n == due + 2 and cam.sent == due + 2


def test_a_stall_counts_against_the_requests_behind_it():
    period = 0.05
    cam, client, t_open = drive(period, 1.0, stall_at=3, stall_s=0.4)
    # request 4 was due at 0.2 s and could leave only once request 3
    # (due at 0.15 s) returned after its 0.4 s stall
    assert cam.late_ms[4] == pytest.approx(350, abs=60)
    assert cam.reply_ms[3] == pytest.approx(400, abs=60)
    assert cam.reply_ms[4] == pytest.approx(350, abs=60)
    # the schedule did not move: once caught up, requests leave on time
    sent = np.asarray(client.sent_at[2:]) - t_open
    assert sent[-1] == pytest.approx(period * (len(sent) - 1), abs=0.03)
    assert max(cam.late_ms[-5:]) < 30


def test_requests_leave_on_their_due_times():
    period, phase = 0.04, 0.013
    cam, client, t_open = drive(period, 0.6, stall_at=-1, stall_s=0,
                                phase=phase)
    sent = np.asarray(client.sent_at[2:]) - t_open
    want = phase + period * np.arange(len(sent))
    assert np.abs(sent - want).max() < 0.02
    assert len(sent) == int(np.ceil((0.6 - phase) / period))


def test_phases_are_one_set_dealt_by_the_seed():
    traffic = {"cameras": 8, "phase_seed": 7}
    a, b = phases(traffic, 1, 0.25), phases(traffic, 2, 0.25)
    assert sorted(a) == sorted(b) and not np.array_equal(a, b)
    assert np.all((a >= 0) & (a < 0.25))
    assert np.array_equal(a, phases(traffic, 1, 0.25))
