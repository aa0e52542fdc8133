"""Per-stage wall-clock timers and a device trace for the run path.

Counterpart of ``dips_tpu/utils/profiling.py``:

* :class:`StageTimers`, a verbatim copy of the JAX package's class
  (accumulating wall-clock timers per named stage with a frames/s
  summary).  The engines split their time into :data:`ENGINE_STAGES`;
  the run path adds ``decode``, ``device`` and ``encode``.
* :func:`stage`, the engines' one hook around a stage: it times the stage
  into a :class:`StageTimers` and, while a ``torch.profiler`` records,
  opens a ``dips.engine.<stage>`` span on the profile's host timeline,
  the clock of the kernels and copies it records.  :data:`POST_STAGE` is
  the optional seventh stage, the engine's post-analysis;
  :data:`POOL_STAGE` the optional stage of a downscaled engine's layout
  prep.
* :class:`StepCounts`, the counts of such an optional step: batches,
  frames, planes and its device time between two CUDA events.
* :func:`trace`, a ``torch.profiler`` capture (CPU activity, and CUDA
  activity when a card is present) written as a Chrome trace, in place of
  the JAX package's ``jax.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import ContextManager, Dict, Iterator, List, Optional, Tuple

import torch

#: the stages of one engine batch, in order: the frames into the host
#: buffer and the tail's newest frames into its slots, in one copy
#: (``stage_in``), the tail's copies alone where the caller filled the
#: buffer (``tail_keep``: ``dispatch_async``, so one of the two runs a
#: batch), the upload's enqueue (``h2d``), layout prep, launch and
#: crop enqueued (``dispatch``), the host blocked until the device is done
#: (``wait``), the downloads (``d2h``)
ENGINE_STAGES = ("stage_in", "tail_keep", "h2d", "dispatch", "wait", "d2h")
#: the stage of ``DiPsEngine``'s post-analysis (the FFT denoise of the
#: maps on the device, between ``dispatch`` and ``wait``), only on an
#: engine given a ``denoise_radius``
POST_STAGE = "denoise"
#: the stage of a downscaled engine's layout prep (the k x k box mean of
#: the uploaded frames into the planar rows, between ``h2d`` and
#: ``dispatch``), only on an engine given ``downscale`` > 1
POOL_STAGE = "pool"
#: the prefix of the engines' profiler spans
SPAN_PREFIX = "dips.engine."
#: the span: a function-scope record, which holds no device-side mark (a
#: ``record_function`` user annotation gets one spanning the kernels
#: launched inside it, which a reader of the device's busy time would
#: count as work)
_span = torch._C._profiler._RecordFunctionFast


class StageTimers:
    """Accumulates wall-clock per named stage; thread-compatible as long as
    each stage name is used by one thread (the pipeline's case)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.frames = 0
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t
            self.counts[name] += 1

    def add_frames(self, n: int) -> None:
        self.frames += n

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def fps(self) -> float:
        e = self.elapsed
        return self.frames / e if e > 0 else 0.0

    def summary(self) -> Dict[str, dict]:
        out = {}
        elapsed = self.elapsed  # one denominator: shares must reconcile
        for name, total in sorted(self.totals.items()):
            n = self.counts[name]
            out[name] = {
                "total_s": round(total, 4),
                "calls": n,
                "mean_ms": round(total / n * 1e3, 3) if n else 0.0,
                "share": round(total / elapsed, 3),
            }
        out["_overall"] = {"frames": self.frames,
                           "elapsed_s": round(elapsed, 3),
                           "fps": round(self.frames / elapsed, 1)
                           if elapsed else 0.0}
        return out

    def __str__(self) -> str:
        rows = [f"  {k:<12} {v}" for k, v in self.summary().items()]
        return "StageTimers:\n" + "\n".join(rows)


class StepCounts:
    """Counts of one optional engine step (stage ``name``), kept while the
    engine's stage timers are on: ``batches``, ``frames``, ``planes`` and
    ``device_ms``, the device time between two CUDA events recorded
    around the step on its stream (on a card).  The events are read by
    :meth:`settle` once the stream has been synchronised: the engine calls
    it after the wait its download makes, so counting adds no sync."""

    def __init__(self, name: str = POST_STAGE) -> None:
        self.name = name
        self.batches = 0
        self.frames = 0
        self.planes = 0
        self.device_ms = 0.0
        self._pending: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []

    @contextlib.contextmanager
    def step(self, device: torch.device, frames: int, planes: int
             ) -> Iterator[None]:
        """Count the block as one batch of ``frames`` frames and
        ``planes`` planes; on a card, its device time is read later."""
        events = None
        if device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        yield
        if events is not None:
            events[1].record()
            self._pending.append(events)
        self.batches += 1
        self.frames += frames
        self.planes += planes

    def settle(self) -> None:
        """Add the device time of the steps recorded so far; the stream
        they ran on must have been synchronised since."""
        for a, b in self._pending:
            self.device_ms += a.elapsed_time(b)
        self._pending.clear()

    def as_dict(self) -> Dict[str, float]:
        return {"batches": self.batches, "frames": self.frames,
                "planes": self.planes, "device_ms": self.device_ms}

    def __str__(self) -> str:
        per = (f", {self.device_ms / self.batches:.3f} ms a batch"
               if self.batches and self.device_ms else "")
        return (f"{self.name}: {self.batches} batches, {self.frames} "
                f"frames, {self.planes} planes, device {self.device_ms:.3f}"
                f" ms{per}")


def stage(timers: Optional[StageTimers], name: str) -> ContextManager:
    """The block as engine stage ``name``: timed into ``timers`` (a
    :class:`StageTimers`, or None), and a ``dips.engine.<name>`` span while
    a ``torch.profiler`` records.  With no profiler recording it costs one
    flag check and enters no span."""
    timed = (timers.stage(name) if timers is not None
             else contextlib.nullcontext())
    if torch.autograd._profiler_enabled():
        return _spanned(timed, name)
    return timed


@contextlib.contextmanager
def _spanned(timed: ContextManager, name: str) -> Iterator[None]:
    with _span(SPAN_PREFIX + name), timed:
        yield


@contextlib.contextmanager
def trace(logdir: Optional[str] = None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block into
    ``logdir/trace.<pid>.json`` (Chrome trace format, viewable in Perfetto
    or chrome://tracing), also when the block raises; a no-op when
    ``logdir`` is None."""
    if logdir is None:
        yield
        return
    import os

    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:  # a run that dies still leaves its trace
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir,
                                              f"trace.{os.getpid()}.json"))
