"""Multi-host demo, self-contained on one machine.

Spawns TWO worker processes that form a real ``torch.distributed``
cluster (gloo; 4 mesh cells each -> an 8-cell global mesh) and run
``MultiHostStreamEngine`` over 8 camera streams: each "host" decodes and
feeds only its own 4 streams, the global mean|diff| statistic rides one
cross-process all-reduce, and outputs come back host-locally.  On real
hosts the SAME worker code runs once per host with ``init_multihost()``
and no arguments (under torchrun's environment).

  python -m dips_tpu_torch.examples.multi_host [--cpu]

With no flag both workers put their 4 cells on the one card (cuda:0);
``--cpu`` puts them on the CPU.
"""

import os
import socket
import subprocess
import sys

if not __package__:  # run as a script path: the repository root on sys.path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import argparse

from dips_tpu_torch.examples import example_device, run

_WORKER = r'''
import sys

import numpy as np
from dips_tpu_torch.parallel import (init_multihost, MultiHostStreamEngine,
                                     stream_mesh)
from dips_tpu_torch.properties import DiPsProperties, DiPsFilter

rank, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
dev = sys.argv[4]
info = init_multihost(f"127.0.0.1:{port}", nprocs, rank)
# the JAX workers each hold 4 virtual devices and build the global mesh
# over all 8; here each process builds its own 4-cell mesh and the engine
# learns the other processes' cells.  The cells stand in for the devices,
# so the JAX line counts them (init_multihost counts the cards a process
# sees, or 1 for the CPU).
mesh = stream_mesh(devices=[dev] * 4)
n_local = mesh.devices.size
print(f"[host {info.process_index}] joined: "
      f"{info.process_count * n_local} global devices "
      f"({n_local} local)", flush=True)

props = DiPsProperties(window_size=3, temporal_size=2,
                       filter=DiPsFilter.UNFILTERED)
eng = MultiHostStreamEngine(props, 64, 96, n_streams=8, batch=4,
                            mesh=mesh, device=dev)
print(f"[host {rank}] owns streams {eng.local_stream_ids}", flush=True)

rng = np.random.default_rng(rank)
for rnd in range(3):
    feed = eng.local_frames_template()
    for si in eng.local_stream_ids:
        frames = rng.integers(0, 255, (4, 64, 96, 3), np.uint8)
        feed[si] = list(frames)
    out, stats, gmean = eng.process_batch(feed)
    print(f"[host {rank}] round {rnd}: out {out.shape}, "
          f"global mean|diff| (cross-host psum) = {gmean:.5f}", flush=True)
'''


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run both workers on the CPU")
    args = ap.parse_args()
    device = example_device(args.cpu)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    # the workers run `python -c`, which puts the CWD (not this repo) on
    # sys.path -- hand them the repo root explicitly so a non-installed
    # checkout works from any directory
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER,
                               str(r), "2", str(port), device], env=env)
             for r in range(2)]
    rc = 0
    try:
        for p in procs:
            rc |= p.wait(timeout=300)
    except subprocess.TimeoutExpired:
        # one worker crashing at startup leaves its peer blocked in
        # init_process_group -- don't leak it
        rc = 1
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print("OK" if rc == 0 else f"FAILED rc={rc}")
    return rc


if __name__ == "__main__":
    raise SystemExit(run(main))
