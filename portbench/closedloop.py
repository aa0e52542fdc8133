"""The measured window of a closed loop: one call into the program after
another, as fast as each returns.

The window opens once set-up is done, and closes when the last call that
started before ``seconds`` had passed returns: every call of the window
counts whole, and the window's length is the time from its opening to
that return.  Each call runs inside a ``record_function`` span of the
benchmark's own, and its host time is kept.

With ``trace``, a steady stretch of the window runs under
``torch.profiler``: it starts ``trace_after_s`` into the window and ends
after ``trace_calls`` calls (or at the window's close); the engine's
stage timers, when it has them, are read over the same stretch.

The calls whose outputs the check compares are a sample drawn from the
seed (a reservoir of ``keep`` calls) and the window's last call.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

from . import trace as tr
from .frames import rng_of
from .record import Run


def run_window(run: Run, step: Callable[[int], object], seconds: float,
               traffic: dict, seed: int, traced: bool,
               timers_of: Optional[Callable[[], dict]] = None,
               start_timers: Optional[Callable[[], None]] = None
               ) -> List[Tuple[int, object]]:
    """Drive ``step(k)`` (call k of the window, returning what the check
    needs) over the window; fills ``run``'s window, batch and trace
    fields, and returns the kept (k, output) pairs."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    rng = rng_of(seed, 1)
    keep = int(traffic.get("keep", 1))
    kept: List[Tuple[int, object]] = []
    last = None
    prof = None
    stretch = None
    trace_after = float(traffic.get("trace_after_s", 1.0))
    trace_calls = int(traffic["trace_calls"])
    traced_calls = 0
    k = 0
    t_open = time.perf_counter()
    close = t_open + seconds
    while True:
        t = time.perf_counter()
        if t >= close:
            break
        if traced and prof is None and traced_calls == 0 \
                and t >= t_open + trace_after:
            _sync()
            prof = profile(activities=[ProfilerActivity.CPU]
                           + ([ProfilerActivity.CUDA]
                              if torch.cuda.is_available() else []))
            prof.start()
            if start_timers is not None:
                start_timers()
            stretch = record_function("portbench.traced_stretch")
            stretch.__enter__()
            t = time.perf_counter()
        with record_function("portbench.process_batch"):
            out = step(k)
        t2 = time.perf_counter()
        run.batch_ms.append((t2 - t) * 1e3)
        if len(kept) < keep:
            kept.append((k, out))
        else:
            j = int(rng.integers(0, k + 1))
            if j < keep:
                kept[j] = (k, out)
        last = (k, out)
        k += 1
        if prof is not None:
            traced_calls += 1
            if traced_calls >= trace_calls:
                _stop(run, prof, stretch, traced_calls, timers_of)
                prof = None
    window_end = time.perf_counter()
    if prof is not None:
        _stop(run, prof, stretch, traced_calls, timers_of)
    run.window_s = window_end - t_open
    if last is not None and all(kk != last[0] for kk, _ in kept):
        kept.append(last)
    return kept


def _sync() -> None:
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _stop(run: Run, prof, stretch, calls: int, timers_of) -> None:
    _sync()
    stretch.__exit__(None, None, None)
    prof.stop()
    if timers_of is not None:
        run.timers = timers_of()
    run.trace_batches = calls
    run.device_iv = tr.device_intervals(prof)
    run.spans = tr.host_spans(prof)
    whole = [s for s in run.spans if s[0] == "portbench.traced_stretch"]
    if whole:
        run.trace_lo, run.trace_hi = whole[0][1], whole[0][2]


def frames_done(run: Run, frames_per_call: int) -> None:
    """Every call of the window counts whole."""
    run.frames = len(run.batch_ms) * frames_per_call
    run.attempted = run.frames
