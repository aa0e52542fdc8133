"""engine.pool_ms: the device time of a downscaled engine's layout prep
(the k x k box mean of the uploaded frames) a batch over the traced
stretch, from the engine's own counters (``pool_counts``: CUDA events
recorded around the step on its stream).  None where the engine keeps no
such counters, or counted no batch."""


def read(run):
    c = (run.timers or {}).get("pool")
    if not c or not c["batches"] or c["device_ms"] <= 0:
        return None
    return c["device_ms"] / c["batches"]
