"""Reading a ``torch.profiler`` trace: device intervals, busy time, the
idle share, and the breakdown of the result line.

The interval union is the arithmetic of the repository's engine profiler,
frozen here: the device is busy while any kernel or copy runs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

Interval = Tuple[str, float, float]   # (name, start_us, end_us)

#: the prefix of the benchmark's own host spans (``record_function``)
SPAN_PREFIX = "portbench."


def device_intervals(prof) -> List[Interval]:
    """(name, start_us, end_us) of every kernel and copy of a profile (the
    device-side marks of the benchmark's own spans are not work)."""
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith(SPAN_PREFIX)]


def host_spans(prof) -> List[Interval]:
    """The benchmark's own spans of a profile."""
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CPU
            and e.name.startswith(SPAN_PREFIX)]


def clip(iv: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The parts of the intervals inside [lo, hi]."""
    return [(n, max(a, lo), min(b, hi)) for n, a, b in iv
            if b > lo and a < hi]


def merged(iv: Sequence[Interval]) -> List[Tuple[float, float]]:
    """The union of the intervals as disjoint (start, end) pairs."""
    out: List[List[float]] = []
    for _, a, b in sorted(iv, key=lambda x: x[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_us(iv: Sequence[Interval]) -> float:
    """Length of the union of the intervals."""
    return sum(b - a for a, b in merged(iv))


def top_ops(iv: Sequence[Interval], k: int = 10) -> List[list]:
    """The ``k`` device operations with the most time: [name, seconds]."""
    per: dict = {}
    for n, a, b in iv:
        per[n] = per.get(n, 0.0) + (b - a)
    return [[_short(n), t / 1e6] for n, t in
            sorted(per.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(iv: Sequence[Interval], spans: Sequence[Interval],
              lo: float, hi: float, k: int = 10) -> List[list]:
    """The ``k`` longest stretches of [lo, hi] with nothing on the device,
    each named by the innermost of ``spans`` open at its middle:
    [name, seconds]."""
    busy = merged(iv)
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    return [[_span_at(spans, (a + b) / 2), (b - a) / 1e6]
            for a, b in gaps[:k]]


def _span_at(spans: Sequence[Interval], t: float) -> str:
    best: Optional[Interval] = None
    for s in spans:
        if s[1] <= t <= s[2] and (best is None or s[2] - s[1]
                                  < best[2] - best[1]):
            best = s
    return best[0] if best else "outside the benchmark's spans"


def _short(name: str) -> str:
    return name if len(name) <= 96 else name[:93] + "..."
