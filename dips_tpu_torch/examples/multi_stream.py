"""Multi-stream demo: 8 videos sharded over the device mesh.

Run:
  python -m dips_tpu_torch.examples.multi_stream [--cpu]

On the card the mesh is the visible cards (one cell each); ``--cpu`` splits
the host into 8 CPU cells, as the JAX example splits it into 8 virtual
devices.  The printed global mean does not depend on the mesh.
"""

import os
import sys

if not __package__:  # run as a script path: the repository root on sys.path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import argparse

from dips_tpu_torch.examples import example_device, run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (8 CPU cells)")
    ap.add_argument("--streams", type=int, default=8)
    args = ap.parse_args()
    device = example_device(args.cpu)

    from dips_tpu_torch.io import moving_square_clip
    from dips_tpu_torch.parallel import MultiStreamEngine, stream_mesh
    from dips_tpu_torch.properties import DiPsProperties

    mesh = stream_mesh(devices=["cpu"] * 8) if args.cpu else stream_mesh()
    n_dev = mesh.devices.size
    s = max(args.streams // n_dev, 1) * n_dev
    print(f"mesh: {n_dev} devices, {s} streams")

    clips = [moving_square_clip(n=12, height=96, width=128, seed=i)
             for i in range(s)]
    props = DiPsProperties(window_size=3, temporal_size=2)
    eng = MultiStreamEngine(props, 96, 128, n_streams=s, batch=4, mesh=mesh,
                            device=device)
    for i in range(0, 12, 4):
        out, stats, gmean = eng.process_batch(
            [list(c[i:i + 4]) for c in clips])
        # the JAX line's words: there the mean is a psum over the chips'
        # interconnect, here a sum over the cells' partial statistics
        print(f"frames {i}..{i+3}: out {out.shape}, "
              f"global mean |diff| (psum over ICI) = {gmean:.5f}")


if __name__ == "__main__":
    raise SystemExit(run(main))
