"""Hold two runs' printed lines of one example against each other.

    from dips_tpu_torch.examples._compare import check
    check("serving", port_stdout, jax_stdout)  # raises AssertionError

Used by the tests (each port example against its JAX counterpart on the
CPU) and by ``chip_smoke.py`` (each card run against a ``--cpu`` run).
Both sides print the same statistics, rounded, and those agree within
1e-6, so:

* the words between the numbers are equal (runs of blanks count as one);
* integers are equal;
* a float is within one unit of its last printed digit, but not below
  1e-6 (a float32 printed through its float64 repr shows digits past its
  precision); a float printed without digits after the point ("0." in a
  numpy row) takes the unit of the line's finest float;
* the lines carrying timing or environment are dropped, and the fields
  that do are masked, by each example's :class:`Spec`, each pattern with
  its reason; where several processes print to one stdout, only their
  records are compared, as a multiset.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

_NUM = re.compile(r"-?\d+(?:\.\d*)?(?:e[-+]?\d+)?")
_MASKED = "<masked>"


@dataclass(frozen=True)
class Ignore:
    """``pattern`` (a regex): with ``line`` the lines it matches (searched
    anywhere in the line) are dropped, else each match is masked -- only
    its first group where it has one."""
    pattern: str
    reason: str
    line: bool = False


@dataclass(frozen=True)
class Tol:
    """The numbers inside a match of ``pattern`` compare within ``atol``
    (a float printed as an integer)."""
    pattern: str
    atol: float
    reason: str


@dataclass(frozen=True)
class Records:
    """Compare only the matches of ``pattern`` (found anywhere in the
    text), as a multiset: the prints of several processes that share one
    stdout, in either order, among other output."""
    pattern: str
    reason: str


@dataclass(frozen=True)
class Spec:
    ignore: Tuple[Ignore, ...] = ()
    tol: Tuple[Tol, ...] = ()
    records: Optional[Records] = None


_TIMERS = Ignore(r"^StageTimers:$|^  \S+\s+\{'", "StageTimers rows are wall "
                 "times of this host", line=True)
_PORT = Ignore(r"on port (\d+)", "the daemon binds a free port")

SPECS: Dict[str, Spec] = {
    "single_video": Spec(ignore=(_TIMERS,)),
    "multi_stream": Spec(ignore=(
        Ignore(r"^mesh: (\d+) devices", "the mesh spans the machine's "
               "devices: 8 CPU cells (8 virtual devices in JAX) or the "
               "visible cards"),)),
    "fleet_telemetry": Spec(
        ignore=(Ignore(r"@(\(np\.int64\(\d+\), np\.int64\(\d+\)\)) amp "
                       r"0(?![\d.])", "a still camera's 4 Hz amplitude is "
                       "float rounding noise (it prints as 0): its argmax "
                       "is wherever that noise peaks"),),
        tol=(Tol(r"amp \d+", 1.0, "an amplitude printed with :.0f"),)),
    "scene_analysis": Spec(),
    "pod_fleet_grid": Spec(),
    "serving": Spec(ignore=(
        _PORT,
        Ignore(r"'backend': ('[^']*')", "the route: 'xla' in JAX; the "
               "port's 'kernel' on a card, 'plain' on the CPU"),
        Ignore(r"in (\d+) dispatches", "coalesced dispatches depend on "
               "how the sessions' requests meet in time"),
        Ignore(r"mean fill ([\d.]+)", "the fill depends on how the "
               "sessions' requests meet in time"),
        Ignore(r"request p50 ([\d.]+) ms", "a latency of this host"))),
    "motion_alerts": Spec(ignore=(_PORT,)),
    "camera_fleet": Spec(ignore=(
        _PORT,
        Ignore(r"daemon: (\d+) requests", "the resume path's requests "
               "depend on when the dropped connection is noticed"),
        Ignore(r"(\d+) coalesced dispatches", "coalesced dispatches depend "
               "on how the cameras' requests meet in time"),
        Ignore(r"mean fill ([\d.]+)", "the fill depends on how the "
               "cameras' requests meet in time"))),
    "multi_host": Spec(records=Records(
        r"\[host \d+\] (?:joined: \d+ global devices \(\d+ local\)|owns "
        r"streams \[[\d, ]*\]|round \d+: out \([\d, ]*\), global "
        r"mean\|diff\| \(cross-host psum\) = \d+\.\d{5})|(?m:^OK$|^FAILED "
        r"rc=\d+$)",
        "two workers print to one stdout in either order; JAX's gloo "
        "client also logs its 8 ranks' connections there, in fragments "
        "that interleave byte by byte (torch.distributed logs nothing)")),
}


def _mask(line: str, ign: Ignore) -> str:
    rx = re.compile(ign.pattern)

    def sub(m):
        if not rx.groups:
            return _MASKED
        a, b = m.span(1)
        s = m.start()
        return m.group(0)[:a - s] + _MASKED + m.group(0)[b - s:]
    return rx.sub(sub, line)


def lines_of(text: str, spec: Spec) -> List[str]:
    """The compared lines of ``text``: its records, or its lines less the
    dropped ones, masked, blanks collapsed."""
    if spec.records:
        return sorted(m.group(0) for m in
                      re.finditer(spec.records.pattern, text))
    out = []
    for line in text.splitlines():
        if any(i.line and re.search(i.pattern, line) for i in spec.ignore):
            continue
        for ign in spec.ignore:
            if not ign.line:
                line = _mask(line, ign)
        line = " ".join(line.split())
        if line:
            out.append(line)
    return out


def _tokens(line: str):
    """(the words between the numbers, the numbers as strings)."""
    return _NUM.split(line), _NUM.findall(line)


def _decimals(num: str) -> Optional[int]:
    """Digits after the point; None for an integer."""
    if "." not in num:
        return None
    return len(num.split(".")[1].split("e")[0])


def _tolerances(line: str, spec: Spec) -> List[Optional[float]]:
    """Each number's tolerance: None for an exact integer."""
    nums = list(_NUM.finditer(line))
    decs = [_decimals(m.group()) for m in nums]
    finest = max((d for d in decs if d), default=0)
    tols = []
    for m, d in zip(nums, decs):
        tol = None
        if d is not None:
            d = d or finest
            tol = max(10.0 ** -d, 1e-6) * (1 + 1e-9)
        for t in spec.tol:
            if any(a <= m.start() and m.end() <= b
                   for a, b in (x.span() for x in
                                re.finditer(t.pattern, line))):
                tol = t.atol
        tols.append(tol)
    return tols


def _line_diff(got: str, exp: str, spec: Spec) -> Optional[str]:
    gw, gn = _tokens(got)
    ew, en = _tokens(exp)
    if gw != ew or len(gn) != len(en):
        return "words differ"
    for g, e, tol in zip(gn, en, _tolerances(exp, spec)):
        if tol is None:
            if _decimals(g) is not None or int(g) != int(e):
                return f"{g} != {e}"
        elif abs(float(g) - float(e)) > tol:
            return f"{g} differs from {e} by more than {tol:.3g}"
    return None


def compare(name: str, got: str, exp: str) -> List[str]:
    """The differences between two runs' stdout of example ``name`` (an
    empty list when they agree)."""
    spec = SPECS[name]
    g, e = lines_of(got, spec), lines_of(exp, spec)
    diffs = []
    if len(g) != len(e):
        diffs.append(f"{len(g)} lines against {len(e)}")
    for i, (a, b) in enumerate(zip(g, e)):
        why = _line_diff(a, b, spec)
        if why:
            diffs.append(f"line {i}: {why}\n  got: {a}\n  exp: {b}")
    return diffs


def check(name: str, got: str, exp: str) -> None:
    """Raise ``AssertionError`` listing the differences, if any."""
    diffs = compare(name, got, exp)
    if diffs:
        raise AssertionError(f"{name}: the runs' printed lines differ:\n"
                             + "\n".join(diffs))
