"""run.pop_ms: the run path's pops a batch over the traced stretch, from
the engine's own stage timers: ``ring_pop``, the time ``stream_dips``
spends popping a batch's frames from its decode ring into the engine's
upload buffer (waiting for the decode worker included).  None where the
run path times no such stage, or timed no batch."""


def read(run):
    t = run.timers
    if not t or not t["counts"].get("ring_pop"):
        return None
    return t["totals"]["ring_pop"] / t["counts"]["ring_pop"] * 1e3
