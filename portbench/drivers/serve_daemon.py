"""``dips_tpu_torch``'s serving daemon in this process, with controls for
the benchmark that started it: the device trace and a report.

    python3 -m portbench.drivers.serve_daemon --report PATH [--trace 1] \\
        -- <the daemon's flags>

* SIGUSR1: (``--trace 1``) start ``torch.profiler`` on the device's
  activity: the device trace has to come from the process that launches
  the kernels, and the profiler from the thread that first used it, the
  main one, where the signal's handler runs;
* SIGUSR2: stop it, after the device has finished what it was given;
* the line ``report`` on standard input: write PATH (JSON): the device
  intervals of the traced stretch and its length on the host's clock, the
  card's peak of allocated memory, and the top-level modules of ``jax``,
  ``jaxlib``, ``flax`` or ``dips_tpu`` loaded in this process.

SIGTERM stops the daemon, as it does the daemon alone.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "dips_tpu")


class Control:
    """The profiler and the report.  The profiler is brought up once in
    set-up, on the main thread, and each start and stop runs there too (in
    the signals' handlers); a stop that arrives while a start is still in
    progress waits for it."""

    def __init__(self, report: str, trace: bool):
        self.report_path, self.trace = report, trace
        self.prof = None
        self.t_start = 0.0
        self.window_s = 0.0
        self.intervals: list = []
        self._starting = False
        self._stop_pending = False

    def warm(self) -> None:
        """One empty profile, so that the window's start is quick (no
        profile without a card: there is no device to trace)."""
        import torch
        self.trace = self.trace and torch.cuda.is_available()
        if self.trace:
            self.start()
            self.stop()
            self.window_s, self.intervals = 0.0, []

    def start(self) -> None:
        if not self.trace or self.prof is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._starting = True
        try:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            self.prof, self.t_start = prof, time.perf_counter()
        finally:
            self._starting = False
        if self._stop_pending:
            self._stop_pending = False
            self.stop()

    def stop(self) -> None:
        if self._starting:
            self._stop_pending = True
            return
        if self.prof is None:
            return
        import torch
        from torch.autograd import DeviceType
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t_start
        self.prof.stop()
        self.intervals = [(e.name, e.time_range.start, e.time_range.end)
                          for e in self.prof.events()
                          if e.device_type == DeviceType.CUDA]
        self.prof = None

    def report(self) -> None:
        import torch
        peak = (int(torch.cuda.max_memory_allocated())
                if torch.cuda.is_available() else 0)
        loaded = sorted({m.split(".")[0] for m in sys.modules}
                        & set(FORBIDDEN))
        doc = {"intervals": self.intervals, "window_s": self.window_s,
               "memory_peak_bytes": peak, "forbidden_loaded": loaded}
        tmp = self.report_path + ".part"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, self.report_path)

    def on_signal(self, signum, frame) -> None:
        try:
            (self.start if signum == signal.SIGUSR1 else self.stop)()
        except Exception as e:  # keep serving; the report has no trace
            print(f"serve_daemon: {signal.Signals(signum).name}: {e!r}",
                  file=sys.stderr, flush=True)

    def loop(self) -> None:
        for line in sys.stdin:
            if line.strip() == "report":
                self.report()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("daemon", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    flags = args.daemon[1:] if args.daemon[:1] == ["--"] else args.daemon
    ctl = Control(args.report, bool(args.trace))
    ctl.warm()
    signal.signal(signal.SIGUSR1, ctl.on_signal)
    signal.signal(signal.SIGUSR2, ctl.on_signal)
    threading.Thread(target=ctl.loop, daemon=True).start()
    from dips_tpu_torch.serve.daemon import main as daemon_main
    return daemon_main(flags)


if __name__ == "__main__":
    sys.exit(main())
