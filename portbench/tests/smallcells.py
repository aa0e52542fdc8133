"""Small cells for the CPU: the benchmark's own cells, cut to a size a
test run holds, driven through the harness with ``device="cpu"`` (the
port's plain kernel twins)."""

import json
import time

from portbench import run as harness


def small(cell_name: str, height: int = 48, width: int = 80,
          batch: int = 4):
    """(cell, config) of a cell at a test size."""
    cell, cfg = harness.cell_files(cell_name)
    cell = json.loads(json.dumps(cell))
    cfg = dict(cfg, height=height, width=width, batch=batch)
    cell["traffic"].update(object_px=[6, 16], trace_after_s=0.2)
    return cell, cfg


def run_small(cell_name: str, seed: int = 2 ** 33 + 1, seconds: float = 1.0,
              trace: bool = False, **kw):
    harness.pin_environment()
    cell, cfg = small(cell_name, **kw)
    return harness.execute(cell_name, seed, seconds, trace, device="cpu",
                           cell=cell, config=cfg, t0=time.perf_counter())
