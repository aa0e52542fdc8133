"""Minimal end-to-end demo: synthesize a clip, run DiPs, write outputs.

Run: python -m dips_tpu_torch.examples.single_video [--cpu]
Produces demo_in.avi, demo_out.avi, demo_heatmap.png and prints stats.

The JAX example's ``--backend xla|pallas`` has no counterpart: on the card
the CUDA kernels are the only route, and ``--cpu`` runs their plain twins.
"""

import os
import sys

if not __package__:  # run as a script path: the repository root on sys.path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import argparse

import numpy as np

from dips_tpu_torch import (DiPsEngine, DiPsJob, DiPsMethod, DiPsProperties,
                            perform_dips)
from dips_tpu_torch.examples import example_device, run
from dips_tpu_torch.io import moving_square_clip, write_clip


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (like the other examples)")
    args = ap.parse_args()
    device = example_device(args.cpu)

    frames = moving_square_clip(n=48, height=240, width=320, seed=7)
    write_clip(frames, "demo_in.avi", fps=24)

    props = DiPsProperties(method=DiPsMethod.OVERALL, window_size=3,
                           temporal_size=4, refresh_markers=(24,))
    job = DiPsJob(properties=props, video_path="demo_in.avi",
                  output_path="demo_out.avi", device=device, profile=True)
    stats = perform_dips(job)
    print(f"{stats.shape[0]} frames; mean |diff| per frame:",
          np.round(stats[:, 1], 4).tolist()[:8], "...")
    print(job.timers)

    # heatmap via the engine API
    eng = DiPsEngine(props, 240, 320, batch=16, device=device)
    eng.process_frames(list(frames))
    hm = eng.heatmap()
    import cv2
    cv2.imwrite("demo_heatmap.png",
                (hm / max(hm.max(), 1e-6) * 255).astype(np.uint8))
    print("wrote demo_out.avi and demo_heatmap.png")


if __name__ == "__main__":
    raise SystemExit(run(main))
