"""portbench: the benchmark of dips_tpu_torch on NVIDIA GPUs.

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell once, on the card of the machine it is started on, and
prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: every number the correctness check
compared, with its limit (also the last lines on standard error).

Everything is found by name, from ``BENCHMARK.json`` at the root:

* ``portbench/cells/<cell>.json``: the configuration, the driver, the
  traffic's parameters and the check's limits;
* ``portbench/configs/<config>.json``: the configuration as it is run;
* ``portbench/drivers/<driver>.py``: the traffic's generator and the
  window (``run(ctx) -> Run``);
* ``portbench/metrics/<metric>.py``: one metric's reader
  (``read(run) -> float or None``; None leaves the metric out).

The run builds the port's kernels into ``build/dips_tpu_torch/`` in the
checkout (the first run of a checkout builds them, later runs load them),
and points the port's tuner store at a path under ``portbench/`` that holds
none, so every cell measures the default kernel geometry.  It exits with a
code other than 0, and prints no result, without a CUDA device or with
fewer than the cell asks for, or if ``jax``, ``jaxlib``, ``flax`` or
``dips_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional  # noqa: E402

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "dips_tpu")
#: the tuner store the port is pointed at: the path holds no store
NO_TUNER_STORE = PKG / "tuner" / "no_store.json"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(name: str):
    """(cell, config) files of a cell, found by name."""
    cell = load_json(PKG / "cells" / f"{name}.json")
    config = load_json(PKG / "configs" / f"{cell['config']}.json")
    return cell, config


def metric_entries(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's metrics from ``BENCHMARK.json``: its end-to-end ones
    (``--trace 0``) or its per-layer ones (``--trace 1``).  A metric
    without a ``workloads`` list is every cell's, for a per-layer one every
    cell's that reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]


def read_metric(name: str, run) -> Optional[float]:
    """The reader ``metrics/<name>.py`` applied to a run."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def pin_environment() -> None:
    """Kernel builds inside the checkout, no tuner store, no JAX."""
    os.environ.pop("DIPS_COMPILE_CACHE", None)
    os.environ["DIPS_TPU_TORCH_AUTOTUNE_CACHE"] = str(NO_TUNER_STORE)
    os.environ["USE_FLAX"] = "0"


def execute(cell_name: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", cell: Optional[dict] = None,
            config: Optional[dict] = None, bench: Optional[dict] = None,
            t0: Optional[float] = None) -> dict:
    """Run a cell once and return its result line as a dict.  ``cell``,
    ``config`` and ``bench`` default to the files found by name (tests
    hand in smaller ones)."""
    from .check import verdict
    from .record import Context
    if cell is None or config is None:
        c, g = cell_files(cell_name)
        cell, config = cell or c, config or g
    if bench is None:
        bench = load_json(ROOT / "BENCHMARK.json")
    driver = importlib.import_module(f"portbench.drivers.{cell['driver']}")
    ctx = Context(cell=cell, config=config, seed=int(seed),
                  seconds=float(seconds), trace=bool(trace), device=device,
                  t0=T0 if t0 is None else t0)
    run = driver.run(ctx)
    if run.notes.get("daemon_forbidden"):
        print(f"portbench: loaded in the daemon's process: "
              f"{', '.join(run.notes['daemon_forbidden'])}", file=sys.stderr)
        raise SystemExit(4)
    metrics = {}
    for m in metric_entries(bench, cell_name, trace):
        v = read_metric(m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": device_name(device), "count": 1,
           "memory_peak_bytes": run.memory_peak_bytes}
    line = {"correct": verdict(run.checks, cell["limits"]),
            "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": dev}
    if trace:
        from . import trace as tr
        if run.traced:
            dev["busy_s"] = run.busy_s()
            dev["window_s"] = run.trace_window_s()
            iv = tr.clip(run.device_iv, run.trace_lo, run.trace_hi)
            line["breakdown"] = {
                "device_ops": tr.top_ops(iv),
                "idle_gaps": tr.idle_gaps(iv, run.spans or [],
                                          run.trace_lo, run.trace_hi)}
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, v, lim in run.checks}
    return line


def device_name(device: str) -> str:
    import torch
    if device.startswith("cuda"):
        return torch.cuda.get_device_name(torch.device(device))
    return device


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m portbench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    pin_environment()
    try:
        cell_files(args.workload)
        bench = load_json(ROOT / "BENCHMARK.json")
        entry = [w for w in bench["workloads"] if w["name"] == args.workload]
        need = int(entry[0]["chips"]) if entry else 1
    except FileNotFoundError as e:
        print(f"portbench: no such file: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("portbench: torch sees no CUDA device; the benchmark runs "
              "on the card only", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < need:
        print(f"portbench: the cell asks for {need} cards, torch sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    line = execute(args.workload, args.seed, args.seconds,
                   bool(args.trace), bench=bench)
    bad = forbidden_loaded()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
