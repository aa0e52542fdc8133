"""What a driver is given and what it hands back."""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class Context:
    """One run of one cell: its files, the seed, the window and the
    device; ``t0`` is the host clock when the run's process started
    (set-up is counted from it)."""
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float


@dataclass
class Run:
    """A run's raw readings; the metric readers under ``metrics/`` take
    theirs from here."""
    cell: dict
    config: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    frames: int = 0                 # frames whose maps reached the host
    batch_ms: List[float] = field(default_factory=list)
    reply_ms: List[float] = field(default_factory=list)
    lateness_ms: List[float] = field(default_factory=list)
    memory_peak_bytes: int = 0
    #: the engine's StageTimers over the traced stretch: {stage: seconds},
    #: and the batches it covered
    timers: Optional[dict] = None
    #: the traced stretch: device intervals and host spans (us), its
    #: bounds (us) and the batches it covered
    device_iv: Optional[list] = None
    spans: Optional[list] = None
    trace_lo: float = 0.0
    trace_hi: float = 0.0
    trace_batches: int = 0
    #: the daemon's metrics reply at the window's end (serving cells)
    server: Optional[dict] = None
    #: (name, value, limit) of every number the correctness check compared
    checks: List[Tuple[str, float, float]] = field(default_factory=list)
    notes: dict = field(default_factory=dict)

    @property
    def traced(self) -> bool:
        return self.device_iv is not None and self.trace_hi > self.trace_lo

    def busy_s(self) -> float:
        from .trace import clip, union_us
        return union_us(clip(self.device_iv, self.trace_lo,
                             self.trace_hi)) / 1e6

    def trace_window_s(self) -> float:
        return (self.trace_hi - self.trace_lo) / 1e6


def percentile(values: List[float], q: int) -> Optional[float]:
    """The q-th percentile (statistics.quantiles, exclusive method);
    None with fewer than two values."""
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=100)[q - 1]
