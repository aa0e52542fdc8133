"""median_ring_roofline: the median ring kernel's share of its roofline:
the least time of a launch (``roofline.median_ring_launch``) over the
device time of ``median_ring_kernel`` a launch, in %."""

from portbench.roofline import median_ring_launch
from portbench.trace import clip


def read(run):
    if not run.traced:
        return None
    iv = clip(run.device_iv, run.trace_lo, run.trace_hi)
    times = [b - a for n, a, b in iv if "median_ring_kernel" in n]
    if not times or sum(times) <= 0:
        return None
    cfg, p = run.config, run.config["pipeline"]
    least = median_ring_launch(int(cfg["height"]), int(cfg["width"]),
                               int(run.cell["traffic"].get("streams", 1)),
                               int(cfg["batch"]), int(p["window_size"]),
                               int(p["temporal_size"]))["least_s"]
    return 100.0 * least / (sum(times) / 1e6 / len(times))
