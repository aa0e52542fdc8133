"""pool_prep_roofline: the decimation kernel's share of its roofline: the
least time of a launch (``roofline_pool.pool_launch``: the configuration's
analysis size, its ``downscale`` and a batch of frames a stream) over the
device time of ``pool_prep_kernel`` a launch, in %.  None where no such
kernel ran (a program that takes the box mean in plain PyTorch)."""

from portbench.roofline_pool import pool_launch
from portbench.trace import clip


def read(run):
    if not run.traced:
        return None
    iv = clip(run.device_iv, run.trace_lo, run.trace_hi)
    times = [b - a for n, a, b in iv if "pool_prep_kernel" in n]
    if not times or sum(times) <= 0:
        return None
    cfg = run.config
    frames = int(run.cell["traffic"].get("streams", 1)) * int(cfg["batch"])
    least = pool_launch(int(cfg["height"]), int(cfg["width"]),
                        int(cfg["downscale"]), frames)["least_s"]
    return 100.0 * least / (sum(times) / 1e6 / len(times))
