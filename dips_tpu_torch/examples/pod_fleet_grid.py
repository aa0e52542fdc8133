"""Pod-fleet demo: raw no-map fleet on the 2-D (stream x rows) grid.

A handful of HUGE cameras where the stream count alone cannot fill every
cell.  Each cell owns a horizontal slab of a subset of streams; raw modes
(absdiff / threshold / stats-only) have no stencil, so the slabs need no
halo exchange at all -- only the statistics cross cells.

Two flavours over the same synthetic fleet:

* ``STATS_ONLY`` with the engine's default protocol -- the no-map events
  fleet (~128 B of device-to-host traffic per frame per stream);
* ``THRESHOLD`` with ``packed_wire`` -- bit-packed motion masks on the
  same 2-D grid (8x less device-to-host traffic when maps ARE wanted).

Run:
  python -m dips_tpu_torch.examples.pod_fleet_grid [--cpu]

The JAX example's grid is 8 chips (8 virtual devices on the CPU).  Here
the 8 cells all name one device: the card, or the CPU under ``--cpu``.
Each cell still launches on its own slab only, so the path is the one a
grid over 8 cards takes (32-row frames give 8-row slabs, aligned for the
slab kernels).
"""

import os
import sys

if not __package__:  # run as a script path: the repository root on sys.path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import argparse

import numpy as np

from dips_tpu_torch.examples import example_device, run


def synth_clip(n, h, w, seed):
    r = np.random.default_rng(seed)
    base = r.integers(0, 200, (h, w, 3), np.uint8)
    frames = []
    for i in range(n):
        f = base.copy()
        y, x = (3 * i) % (h - 8), (5 * i) % (w - 8)
        f[y:y + 8, x:x + 8] = 255  # moving block = motion signal
        frames.append(f)
    return frames


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (8 CPU cells)")
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args()
    device = example_device(args.cpu)

    from dips_tpu_torch.parallel import MultiStreamEngine
    from dips_tpu_torch.parallel.grid2d import grid_mesh
    from dips_tpu_torch.properties import DiPsProperties, OutputMode

    h, w, batch = 32, 96, 4
    # 2 stream shards x 4 row slabs = 8 cells, all on one device
    mesh = grid_mesh(2, 4, devices=[device] * 8)
    print(f"mesh: 2 streams x 4 row slabs over {mesh.devices.size} devices")
    clips = [synth_clip(args.frames, h, w, seed=k) for k in range(2)]

    # 1. the events fleet: stats only, zero map egress, carried state
    props = DiPsProperties(output=OutputMode.STATS_ONLY, temporal_size=2,
                           change_threshold=20)
    eng = MultiStreamEngine(props, h, w, n_streams=2, batch=batch,
                            mesh=mesh, ring_carry=None, device=device)
    for i in range(0, args.frames, batch):
        out, stats, gmean = eng.process_batch(
            [c[i:i + batch] for c in clips])
        assert out.shape[-1] == 0  # no map bytes at all
        for si in range(2):
            changed = stats[si, :, 3].astype(int)
            print(f"  stats_only stream {si} frames {i}-{i + batch - 1}: "
                  f"changed px {changed.tolist()} (gmean {gmean:.4f})")
    hm = eng.heatmaps()
    print(f"heatmaps: {hm.shape}, hottest pixel/stream "
          f"{[round(float(x), 2) for x in hm.max(axis=(1, 2))]}")

    # 2. the masked fleet: THRESHOLD + packed wire on the same grid
    props = DiPsProperties(output=OutputMode.THRESHOLD, temporal_size=2,
                           change_threshold=20)
    eng = MultiStreamEngine(props, h, w, n_streams=2, batch=batch,
                            mesh=mesh, packed_wire=True, device=device)
    out, stats, _ = eng.process_batch([c[:batch] for c in clips])
    on = (out == 255).mean(axis=(2, 3, 4))
    print(f"threshold+packed_wire: masks {out.shape}, "
          f"on-fraction/frame {np.round(on, 3).tolist()}")


if __name__ == "__main__":
    raise SystemExit(run(main))
