"""Per-stage wall-clock timers for the run path.

Counterpart of ``dips_tpu/utils/profiling.py``: :class:`StageTimers`, a
verbatim copy of the JAX package's class (accumulating wall-clock timers
per named stage with a frames/s summary).  The engines split their time
into ``h2d``, ``dispatch`` and ``d2h``; the run path adds ``decode``,
``device`` and ``encode``.  The JAX package's ``trace`` (``jax.profiler``)
is not copied: a ``torch.profiler`` counterpart is queued in ROADMAP.md.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator


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
