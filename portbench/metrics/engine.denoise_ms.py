"""engine.denoise_ms: the device time of the engine's post-analysis (the
FFT denoise of the maps) a batch over the traced stretch, from the
engine's own counters (``DiPsEngine.denoise_counts``: CUDA events
recorded around the step on its stream).  None where the engine keeps no
such counters, or counted no batch."""


def read(run):
    c = (run.timers or {}).get("denoise")
    if not c or not c["batches"] or c["device_ms"] <= 0:
        return None
    return c["device_ms"] / c["batches"]
