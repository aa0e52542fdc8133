"""Cameras served by the port's daemon, open loop.

The run starts ``dips_tpu_torch.serve`` in a child process (under
``serve_daemon``, which adds the device trace and the report), on a port
the daemon picks and prints, and stops it at the end.  Each camera is a
named ``DiPsClient`` session that sends one frame a request at a fixed
rate, from a phase of its own: request k of camera c is due at
``open + phase_c + k * period``.  A camera waits for each reply before it
sends again (a session's frames are processed in order), so a request
sent late because the one before it was slow is still timed from the
moment it was due: a stall counts against every request queued behind it.

Traffic parameters: the frame pool's; ``cameras``; ``rate_fps`` (all
cameras together); ``phase_seed`` (the set of phases is drawn from it,
the same for every run; the run's seed deals them to the cameras);
``warmup_requests`` each camera sends in set-up; ``coalesce``,
``batch`` and ``coalesce_window_ms`` for the daemon; ``keep`` replies a
camera, drawn from the seed, and its last one are checked;
``trace_after_s`` and ``trace_s`` place the traced stretch (in the
daemon's process).
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from .. import program
from ..check import Checks, heat_gap, maps_lsb, per_stream, stats_gap
from ..frames import make_pool, rng_of, stream_offsets
from ..record import Context, Run
from ..reference import StreamReplay, params_from_config, pool_planes

ROOT = Path(__file__).resolve().parents[2]
#: the module that runs the daemon (tests plant faults under it)
DAEMON_MODULE = "portbench.drivers.serve_daemon"
#: how long set-up may take to bring the daemon up (the first run of a
#: checkout builds the kernels)
_START_S = 900.0
#: how long past the window's close the run waits for replies
_DRAIN_S = 60.0


def phases(traffic: dict, seed: int, period: float) -> np.ndarray:
    """Each camera's phase: a fixed set, dealt by the seed."""
    cams = int(traffic["cameras"])
    base = np.sort(rng_of(int(traffic["phase_seed"])).uniform(0, period,
                                                              cams))
    return base[rng_of(seed, 2).permutation(cams)]


class Camera(threading.Thread):
    """One camera's session: ``warm`` requests in set-up, then the open
    loop of the window."""

    def __init__(self, client, frame, warm: int, keep: int, rng):
        super().__init__(daemon=True)
        self.client = client
        self.frame, self.warm, self.keep, self.rng = frame, warm, keep, rng
        self.sent = 0            # requests sent (the session's frames)
        self.replied = 0
        self.errors = 0
        self.reply_ms: list = []
        self.late_ms: list = []
        self.kept: list = []     # (frame index, maps, stats)
        self.last = None
        self.schedule = None     # (open, phase, period, close)
        self.go = threading.Event()
        self.warmed = threading.Event()
        self.error = None

    def _request(self, i: int):
        self.sent += 1
        maps, stats = self.client.process(self.frame(i))
        self.replied += 1
        return maps.reshape(maps.shape[-3:]), stats.reshape(-1)

    def run(self) -> None:
        try:
            for i in range(self.warm):
                self._request(i)
            self.warmed.set()
            self.go.wait()
            t_open, phase, period, close = self.schedule
            k = 0
            while True:
                due = t_open + phase + k * period
                if due >= close:
                    break
                now = time.perf_counter()
                if due > now:
                    time.sleep(due - now)
                    now = time.perf_counter()
                self.late_ms.append((now - due) * 1e3)
                i = self.sent
                try:
                    maps, stats = self._request(i)
                except RuntimeError:
                    self.errors += 1
                    k += 1
                    continue
                self.reply_ms.append((time.perf_counter() - due) * 1e3)
                self._keep(k, (i, maps, stats))
                k += 1
        except Exception as e:  # reported as failed requests
            self.error = e
        finally:
            self.warmed.set()

    def _keep(self, k: int, item) -> None:
        if len(self.kept) < self.keep:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, k + 1))
            if j < self.keep:
                self.kept[j] = item
        self.last = item


def _drain(stream, port_box: dict, ready: threading.Event) -> None:
    """Read the daemon's standard output: its port, then pass the rest on
    to standard error."""
    for line in stream:
        if "dips server on" in line and "port" not in port_box:
            port_box["port"] = int(line.strip().rsplit(":", 1)[1])
            ready.set()
        else:
            sys.stderr.write(line)
    ready.set()


def run(ctx: Context) -> Run:
    cfg, traffic = ctx.config, ctx.cell["traffic"]
    h, w = int(cfg["height"]), int(cfg["width"])
    cams = int(traffic["cameras"])
    period = cams / float(traffic["rate_fps"])
    res = Run(cell=ctx.cell, config=cfg)
    pool = make_pool(ctx.seed, h, w, traffic)
    offs = stream_offsets(cams, traffic)
    n_pool = len(pool)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    report = os.path.join(tmp, "daemon.json")
    argv = [sys.executable, "-m", DAEMON_MODULE,
            "--report", report, "--trace", str(int(ctx.trace)), "--",
            *program.daemon_flags(cfg), "--host", "127.0.0.1", "--port", "0",
            "--height", str(h), "--width", str(w),
            "--coalesce", str(traffic["coalesce"]),
            "--coalesce-window-ms", str(traffic["coalesce_window_ms"]),
            "--batch", str(traffic["batch"]),
            "--input-layout", cfg["input_layout"], "--device", ctx.device,
            "--warm", f"{h}x{w}"]
    proc = subprocess.Popen(argv, cwd=str(ROOT), stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True,
                            env=dict(os.environ))
    cams_ = []
    try:
        box: dict = {}
        ready = threading.Event()
        threading.Thread(target=_drain, args=(proc.stdout, box, ready),
                         daemon=True).start()
        if not ready.wait(_START_S) or "port" not in box:
            raise RuntimeError("the daemon did not come up")
        from dips_tpu_torch.serve import DiPsClient
        keep = int(traffic.get("keep", 1))
        for c in range(cams):
            def frame(i, off=offs[c]):
                return pool[(i + off) % n_pool]
            cams_.append(Camera(DiPsClient(box["port"], session=f"cam{c}"),
                                frame, int(traffic["warmup_requests"]), keep,
                                rng_of(ctx.seed, 10 + c)))
        for cam in cams_:
            cam.start()
        for cam in cams_:
            cam.warmed.wait()
        if any(cam.error for cam in cams_):
            raise RuntimeError(f"set-up failed: "
                               f"{[repr(c.error) for c in cams_]}")
        res.setup_s = time.perf_counter() - ctx.t0
        ph = phases(traffic, ctx.seed, period)
        t_open = time.perf_counter()
        close = t_open + ctx.seconds
        for cam, p in zip(cams_, ph):
            cam.schedule = (t_open, float(p), period, close)
            cam.go.set()
        if ctx.trace:
            _at(t_open + float(traffic["trace_after_s"]))
            proc.send_signal(signal.SIGUSR1)
            _at(min(close, t_open + float(traffic["trace_after_s"])
                    + float(traffic["trace_s"])))
            proc.send_signal(signal.SIGUSR2)
        for cam in cams_:
            cam.join(max(0.0, close + _DRAIN_S - time.perf_counter()))
        t_close = time.perf_counter()
        res.window_s = t_close - t_open
        stuck = [c for c in cams_ if c.is_alive()]
        for cam in cams_:
            res.reply_ms += cam.reply_ms
            res.lateness_ms += cam.late_ms
        res.attempted = sum(len(c.late_ms) for c in cams_)
        res.frames = len(res.reply_ms)
        res.failed = res.attempted - res.frames
        if not stuck:
            res.server = cams_[0].client.metrics()
            heats = [c.client.heatmap().copy() for c in cams_]
        _say(proc, "report")
        daemon = _wait_report(report, proc)
    finally:
        for cam in cams_:
            if not cam.is_alive():
                cam.client.close()
        proc.terminate()
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
        shutil.rmtree(tmp, ignore_errors=True)
    res.memory_peak_bytes = int(daemon["memory_peak_bytes"])
    res.notes["daemon_forbidden"] = daemon["forbidden_loaded"]
    if ctx.trace and daemon["intervals"]:
        iv = [tuple(x) for x in daemon["intervals"]]
        lo = min(a for _, a, _ in iv)
        res.device_iv = iv
        res.trace_lo, res.trace_hi = lo, lo + daemon["window_s"] * 1e6
        res.spans = [("portbench.daemon", res.trace_lo, res.trace_hi)]
        res.notes["served_trace"] = True
    res.notes["late_by_camera"] = [c.late_ms for c in cams_]

    checks = Checks(ctx.cell["limits"])
    checks.add("missing", res.failed + len(stuck)
               + sum(1 for c in cams_ if c.error is not None))
    if stuck:
        res.checks = checks.items()
        return res
    prm = params_from_config(cfg)
    planes = pool_planes(pool, prm, per_stream)

    def camera(c: int):
        cam = cams_[c]
        replay = StreamReplay(pool, offs[c], prm, planes)
        items = list(cam.kept)
        if cam.last is not None and all(it[0] != cam.last[0]
                                        for it in items):
            items.append(cam.last)
        got = []
        for i, maps, stats in items:
            exp_maps, exp_stats = replay.outputs([i])
            got += [("maps_lsb", maps_lsb(maps, exp_maps[0])),
                    ("stats_gap", stats_gap(stats[None], exp_stats))]
        return got + [("heat_gap", heat_gap(heats[c],
                                            replay.heatmap(cam.sent)))]

    for got in per_stream(camera, range(cams)):
        for name, value in got:
            checks.add(name, value)
    res.checks = checks.items()
    return res


def _at(t: float) -> None:
    now = time.perf_counter()
    if t > now:
        time.sleep(t - now)


def _say(proc, line: str) -> None:
    proc.stdin.write(line + "\n")
    proc.stdin.flush()


def _wait_report(path: str, proc, timeout: float = 120.0) -> dict:
    end = time.perf_counter() + timeout
    while not os.path.exists(path):
        if proc.poll() is not None or time.perf_counter() > end:
            raise RuntimeError("the daemon wrote no report")
        time.sleep(0.05)
    with open(path) as f:
        return json.load(f)

