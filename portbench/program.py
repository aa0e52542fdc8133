"""The system under test, as the benchmark reaches it: ``dips_tpu_torch``'s
properties, engines and daemon flags from a configuration file.

The only module of the harness that imports the program; the reference
never does.
"""

from __future__ import annotations

from typing import List

import numpy as np


def props(cfg: dict):
    """The configuration's pipeline as ``DiPsProperties``."""
    from dips_tpu_torch.properties import (ChromaFilter, DiPsFilter,
                                           DiPsMethod, DiPsProperties,
                                           OutputMode)
    p = cfg["pipeline"]
    return DiPsProperties(
        method=DiPsMethod[p["method"]], output=OutputMode[p["output"]],
        filter=DiPsFilter[p["filter"]], chroma=ChromaFilter[p["chroma"]],
        window_size=int(p["window_size"]),
        temporal_size=int(p["temporal_size"]),
        sensitivity=float(p["sensitivity"]),
        sigmoid_horizontal_scalar=float(p["sigmoid_horizontal_scalar"]),
        change_threshold=int(p["change_threshold"]))


def daemon_flags(cfg: dict) -> List[str]:
    """The pipeline as the daemon's command-line flags."""
    p = cfg["pipeline"]
    flags = {"SIGMOID": "sigmoid", "INVERSE_SIGMOID": "inv_sig",
             "NONE": "none"}
    chroma = {"ALL": "", "RED": "r", "GREEN": "g", "BLUE": "b"}
    return ["--method", p["method"].lower(),
            "--output-mode", p["output"].lower(),
            "--filter", flags[p["filter"]], "--chroma", chroma[p["chroma"]],
            "--win_size", str(p["window_size"]),
            "--temporal", str(p["temporal_size"]),
            "--sensitivity", str(p["sensitivity"]),
            "--sig_scalar", str(p["sigmoid_horizontal_scalar"]),
            "--threshold", str(p["change_threshold"])]


def baseline_hwc(baseline: np.ndarray, height: int, width: int
                 ) -> np.ndarray:
    """A carried baseline as the reference holds it: the raw modes' planar
    (3, Hp, Wp) uint8 frame as (H, W, 3), a median mode's (Hp, Wp) plane
    as (H, W)."""
    if baseline.ndim == 3:
        return np.ascontiguousarray(
            baseline[:, :height, :width].transpose(1, 2, 0))
    return baseline[:height, :width]
