"""engine.dispatch_ms: the engine's host side a batch, from its own stage
timers over the traced stretch: ``h2d`` (the upload's enqueue from the
pinned buffer) plus ``dispatch`` (layout prep, launch and crop enqueued).
Not ``d2h``, which also holds the wait for the device."""


def read(run):
    t = run.timers
    if not t or not t["counts"].get("dispatch"):
        return None
    total = t["totals"].get("h2d", 0.0) + t["totals"]["dispatch"]
    return total / t["counts"]["dispatch"] * 1e3
