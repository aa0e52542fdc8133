"""raw_step_roofline: the raw ring step's share of its roofline: the least
time of a launch (``roofline.raw_ring_launch``: bytes over 3.35 TB/s,
operations over 16.73 Tops/s, the larger) over its device time a launch,
``raw_step_kernel`` and the ``raw_step_stats_kernel`` after it, in %."""

from portbench.roofline import raw_ring_launch
from portbench.trace import clip


def read(run):
    if not run.traced:
        return None
    iv = clip(run.device_iv, run.trace_lo, run.trace_hi)
    launches = sum(1 for n, _, _ in iv if "raw_step_kernel" in n)
    busy = sum(b - a for n, a, b in iv
               if "raw_step_kernel" in n or "raw_step_stats_kernel" in n)
    if launches == 0 or busy <= 0:
        return None
    cfg = run.config
    least = raw_ring_launch(int(cfg["height"]), int(cfg["width"]),
                            int(run.cell["traffic"].get("streams", 1)),
                            int(cfg["batch"]))["least_s"]
    return 100.0 * least / (busy / 1e6 / launches)
