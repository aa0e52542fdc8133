"""The engines' named stages on the CPU: ``utils/profiling.stage`` times
each stage into ``StageTimers`` and, while a ``torch.profiler`` records,
opens a ``dips.engine.<stage>`` span.

* ``DiPsEngine.process_batch``: the six spans once a call, in order,
  without overlap, inside the caller's ``record_function``; both
  protocols, both upload layouts.
* ``MultiStreamEngine.process_batch``: ``stage_in`` / ``tail_keep`` once
  per staged stream, then ``h2d``, ``dispatch``, ``wait``, ``d2h``; a
  stream gone quiet adds one ``stage_in`` (its stale rows zeroed).
* With no profiler recording no span is entered; the maps and stats are
  byte-equal with spans on and off; the timers take the new stages.

Sizes: H = 24, W = 40, B = 4, S = 3.
"""

import json
import os

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from dips_tpu_torch import (DiPsEngine, DiPsProperties, MultiStreamEngine,
                            OutputMode)
from dips_tpu_torch.utils import profiling
from dips_tpu_torch.utils.profiling import (ENGINE_STAGES, SPAN_PREFIX,
                                            StageTimers)

H, W, B, S = 24, 40, 4, 3
PROPS = {"colorize": DiPsProperties(),
         "absdiff": DiPsProperties(output=OutputMode.ABSDIFF)}


def clip(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (H, W, 3), np.uint8) for _ in range(n)]


def traced(call):
    """Run ``call`` inside a ``record_function`` of its own under a CPU
    profiler: (the caller's span, the engine spans in start order, the
    call's result)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            out = call()
    events = prof.events()
    caller = [e for e in events if e.name == "caller"]
    spans = sorted((e for e in events if e.name.startswith(SPAN_PREFIX)),
                   key=lambda e: e.time_range.start)
    assert len(caller) == 1
    return caller[0], spans, out


def check_nesting(caller, spans):
    """Every span inside the caller's, no two overlapping."""
    for e in spans:
        assert caller.time_range.start <= e.time_range.start
        assert e.time_range.end <= caller.time_range.end
    for a, b in zip(spans, spans[1:]):
        assert a.time_range.end <= b.time_range.start, (a.name, b.name)


def names(spans):
    return [e.name[len(SPAN_PREFIX):] for e in spans]


def engine(props="colorize", **kw):
    return DiPsEngine(PROPS[props], H, W, batch=B, device="cpu", **kw)


def fleet(props="colorize", **kw):
    return MultiStreamEngine(PROPS[props], H, W, S, batch=B, device="cpu",
                             **kw)


@pytest.mark.parametrize("layout", ["hwc", "planar"])
@pytest.mark.parametrize("ring", [True, False])
def test_engine_spans_once_a_call_in_order(ring, layout):
    eng = engine(ring_carry=ring, input_layout=layout)
    for k, n in enumerate((B, B - 1)):  # a first and a short batch
        caller, spans, _ = traced(lambda: eng.process_batch(clip(k, n)))
        assert names(spans) == list(ENGINE_STAGES)
        check_nesting(caller, spans)


@pytest.mark.parametrize("layout", ["hwc", "planar"])
@pytest.mark.parametrize("ring", [True, False])
def test_fleet_spans_once_per_staged_stream(ring, layout):
    f = fleet(ring_carry=ring, input_layout=layout)
    per_batch = list(ENGINE_STAGES[2:])
    feeds = [clip(1, B), clip(2, 2), clip(3, B)]
    caller, spans, _ = traced(lambda: f.process_batch(feeds))
    assert names(spans) == ["stage_in", "tail_keep"] * S + per_batch
    check_nesting(caller, spans)
    # stream 1 goes quiet: two staged streams, then its stale rows zeroed
    caller, spans, _ = traced(lambda: f.process_batch(
        [clip(4, B), [], clip(5, 1)]))
    assert names(spans) == (["stage_in", "tail_keep"] * 2 + ["stage_in"]
                            + per_batch)
    check_nesting(caller, spans)


class CountingSpan:
    """Stands in for the span type and counts its entries."""
    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        CountingSpan.entered += 1
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("timed", [False, True])
def test_no_profiler_enters_no_span(monkeypatch, timed):
    monkeypatch.setattr(profiling, "_span", CountingSpan)
    CountingSpan.entered = 0
    eng, f = engine(), fleet()
    if timed:
        eng.timers, f.timers = StageTimers(), StageTimers()
    for k in range(2):
        eng.process_batch(clip(k, B))
        f.process_batch([clip(k, B)] * S)
    assert CountingSpan.entered == 0
    # the same calls under a profiler enter the stand-in once a stage
    with profile(activities=[ProfilerActivity.CPU]):
        eng.process_batch(clip(2, B))
        f.process_batch([clip(2, B)] * S)
    assert CountingSpan.entered == len(ENGINE_STAGES) + 2 * S + 4


@pytest.mark.parametrize("props", sorted(PROPS))
@pytest.mark.parametrize("ring", [True, False])
def test_outputs_equal_with_spans_on_and_off(ring, props):
    plain, spanned = engine(props, ring_carry=ring), engine(props,
                                                            ring_carry=ring)
    spanned.timers = StageTimers()
    fplain, fspanned = fleet(props, ring_carry=ring), fleet(props,
                                                            ring_carry=ring)
    fspanned.timers = StageTimers()
    for k, n in enumerate((B, B, 2)):
        frames = clip(k, n)
        feeds = [clip(10 + k, n), clip(20 + k, B), clip(30 + k, 1)]
        want = plain.process_batch(frames)
        fwant = fplain.process_batch(feeds)
        _, _, got = traced(lambda: spanned.process_batch(frames))
        _, _, fgot = traced(lambda: fspanned.process_batch(feeds))
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(fwant[:2], fgot[:2]):
            np.testing.assert_array_equal(a, b)
        assert fwant[2] == fgot[2]
    np.testing.assert_array_equal(plain.heatmap(), spanned.heatmap())
    np.testing.assert_array_equal(fplain.heatmaps(), fspanned.heatmaps())


def test_timers_take_the_new_stages():
    eng, f = engine(), fleet()
    eng.timers, f.timers = StageTimers(), StageTimers()
    for k in range(2):
        eng.process_batch(clip(k, B))
        f.process_batch([clip(k, B), clip(k, 3), []])
    assert dict(eng.timers.counts) == {s: 2 for s in ENGINE_STAGES}
    assert dict(f.timers.counts) == dict(
        stage_in=4, tail_keep=4, h2d=2, dispatch=2, wait=2, d2h=2)
    assert set(f.timers.summary()) == set(ENGINE_STAGES) | {"_overall"}


def test_stage_hook_without_timers_or_profiler():
    """The hook alone: nothing timed, nothing raised through it lost."""
    with profiling.stage(None, "wait"):
        pass
    timers = StageTimers()
    with pytest.raises(ValueError):
        with profiling.stage(timers, "d2h"):
            raise ValueError("through the stage")
    assert timers.counts["d2h"] == 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.stage(timers, "d2h"):
            pass
    assert timers.counts["d2h"] == 2
    assert [e.name for e in prof.events()
            if e.name.startswith(SPAN_PREFIX)] == ["dips.engine.d2h"]


def test_chrome_trace_names_the_stages(tmp_path):
    """``utils/profiling.trace`` (the CLI's ``--trace-dir``) writes the six
    stage spans into its Chrome trace."""
    eng = engine()
    with profiling.trace(str(tmp_path)):
        eng.process_batch(clip(0, B))
    path = tmp_path / f"trace.{os.getpid()}.json"
    events = json.loads(path.read_text())["traceEvents"]
    got = [e["name"][len(SPAN_PREFIX):] for e in events
           if str(e.get("name", "")).startswith(SPAN_PREFIX)]
    assert sorted(got) == sorted(ENGINE_STAGES)
