"""copy.d2h_ms: device time of the device-to-host copies a batch over the
traced stretch (the maps' and the stats' downloads)."""

from portbench.trace import clip


def read(run):
    if not run.traced or run.trace_batches <= 0:
        return None
    iv = clip(run.device_iv, run.trace_lo, run.trace_hi)
    d2h = sum(b - a for n, a, b in iv if "DtoH" in n)
    if d2h <= 0:
        return None
    return d2h / 1e3 / run.trace_batches
