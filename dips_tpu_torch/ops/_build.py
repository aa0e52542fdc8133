"""Build and load the port's CUDA kernels.

The sources under ``dips_tpu_torch/csrc/`` are compiled with ``nvcc`` into
one shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers in the build, so it takes seconds, not minutes).  Each
source compiles in its own ``nvcc`` process, all started together, and one
more ``nvcc`` links the objects.  The build
runs at first use, from the package's own sources only, into
``build/dips_tpu_torch/<key>/`` at the repository root, where ``<key>`` is a
hash of the sources, of the generated network header and of the compiler
flags: a changed source builds anew, an unchanged one loads the cached
library.

The median kernels' selection networks are generated here from
``ops/networks.py`` (the same column-factored window plans, separable
medians, the quirk window's rank selection and the temporal median
networks the plain version applies with ``torch.minimum`` /
``torch.maximum``) into ``median_networks.cuh`` beside the library.

``-fmad=false`` and no fast math: the emphasis path must round like the
float32 reference (``expf``/``logf``, IEEE division, no contracted
multiply-adds).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

from . import networks

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "dips_tpu_torch"
SOURCES = ("raw_ring.cu", "median_ring.cu", "median_tail.cu")
LIB_NAME = "libdips_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")
#: spatial windows the median kernel is instantiated for
WINDOWS = (1, 3, 5, 7)
#: largest temporal ring the median kernel carries in registers
MAX_T = 16

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C signatures: every pointer and the stream as c_void_p
SIGNATURES = {
    # raw, prev, base, heat, out, parts, flags, valid, seeds,
    # S, B, Hp, Wp, overall, out_mode, thr, y0, x0, y1, x1,
    # heat_scale, stream
    "dips_raw_ring": [_P] * 9 + [_I] * 11 + [_F, _P],
    # raw, btop, bbot, ring, prev, base, heat, out, parts, flags, valid,
    # offs, seeds,
    # S, B, Hp, Wp, T, W, spatial mode, overall, out_mode, chroma, filter,
    # k, sens, lo_clip, hi_clip, scale, thr, y0, x0, y1, x1, stream
    "dips_median_ring": [_P] * 13 + [_I] * 11 + [_F] * 6 + [_I] * 4 + [_P],
    # raw, base, heat, out, parts, flags, valid,
    # S, B, T, Hp, Wp, overall, out_mode, thr, y0, x0, y1, x1,
    # heat_scale, stream
    "dips_raw_tail": [_P] * 7 + [_I] * 12 + [_F, _P],
    # raw, btop, bbot, base, heat, out, parts, flags, valid,
    # S, B, Hp, Wp, T, W, spatial mode, overall, out_mode, chroma, filter,
    # k, sens, lo_clip, hi_clip, scale, thr, y0, x0, y1, x1, stream
    "dips_median_tail": [_P] * 9 + [_I] * 11 + [_F] * 6 + [_I] * 4 + [_P],
}

_lib: Optional[ctypes.CDLL] = None
#: what the last build or load did: directory, seconds, ptxas report
build_info: Dict[str, object] = {}


def _cmpx(i: int, j: int, need_min: bool, need_max: bool, v: str) -> str:
    a, b = f"{v}{i}", f"{v}{j}"
    if need_min and need_max:
        return f"  {{ auto t = min({a}, {b}); {b} = max({a}, {b}); {a} = t; }}"
    if need_min:
        return f"  {a} = min({a}, {b});"
    return f"  {b} = max({a}, {b});"


def _window_median_fn(w: int) -> str:
    """``int wmed<w>(const int* s, int ld)``: the exact median of the w x w
    taps whose top-left is ``s`` (row stride ``ld``), as
    ``networks.window_median`` computes it: sort each column, then the
    pruned merge plan; wire ``dx * w + j`` is the j-th smallest of
    column dx."""
    col_sort, merge_ops, target = networks.column_median_plan(w)
    lines = [f"__device__ __forceinline__ int wmed{w}(const int* s, int ld) {{"]
    for dx in range(w):
        for j in range(w):
            lines.append(f"  int v{dx * w + j} = s[{j} * ld + {dx}];")
    for dx in range(w):
        for i, j in col_sort:
            lines.append(_cmpx(dx * w + i, dx * w + j, True, True, "v"))
    for i, j, nmin, nmax in merge_ops:
        lines.append(_cmpx(i, j, nmin, nmax, "v"))
    lines.append(f"  return v{target};")
    lines.append("}")
    return "\n".join(lines)


def _separable_median_fn(w: int) -> str:
    """``int smed<w>(const int* s, int step)``: the median of the w taps
    ``s[0], s[step], ..., s[(w-1) * step]`` through
    ``networks.median_network(w)`` -- the building block of
    ``networks.separable_median``: down a column (step = the row stride),
    then across the w column medians (step 1)."""
    lines = [f"__device__ __forceinline__ int smed{w}(const int* s, "
             "int step) {"]
    for j in range(w):
        lines.append(f"  int v{j} = s[{j} * step];")
    for i, j, nmin, nmax in networks.median_network(w):
        lines.append(_cmpx(i, j, nmin, nmax, "v"))
    lines.append(f"  return v{w // 2};")
    lines.append("}")
    return "\n".join(lines)


def _quirk_select_fn(w: int) -> str:
    """``int qsel<w>(const int* s, int ld)``: ``networks.
    quirk_window_select`` -- the tap of rank ``w*w//2 + 1 - 2w`` of the
    off-center (w-1) x (w-1) window whose top-left is ``s`` (offsets
    [-p, p) in both axes), through ``networks.selection_network``; wire
    ``dx * (w-1) + dy`` is tap (dy, dx), as the plain version orders them.
    At w = 3 the rank is negative and the result is 0."""
    wm1 = w - 1
    rank = (w * w) // 2 + 1 - 2 * w
    lines = [f"__device__ __forceinline__ int qsel{w}(const int* s, "
             "int ld) {"]
    if rank < 0:
        lines += ["  return 0;", "}"]
        return "\n".join(lines)
    for dx in range(wm1):
        for dy in range(wm1):
            lines.append(f"  int v{dx * wm1 + dy} = s[{dy} * ld + {dx}];")
    for i, j, nmin, nmax in networks.selection_network(wm1 * wm1, (rank,)):
        lines.append(_cmpx(i, j, nmin, nmax, "v"))
    lines.append(f"  return v{rank};")
    lines.append("}")
    return "\n".join(lines)


def _temporal_median_fn() -> str:
    """``float tmed(const float (&r)[MAX_T], int t)``: the exact median
    (index t // 2) of ``r[0..t)``, through ``networks.median_network(t)``
    for each t, selected by a switch on the runtime ring length."""
    lines = [f"__device__ __forceinline__ float tmed(const float (&r)[{MAX_T}], "
             "int t) {", "  switch (t) {"]
    for t in range(1, MAX_T + 1):
        lines.append(f"  case {t}: {{")
        for k in range(t):
            lines.append(f"    float q{k} = r[{k}];")
        for i, j, nmin, nmax in networks.median_network(t):
            lines.append("  " + _cmpx(i, j, nmin, nmax, "q"))
        lines.append(f"    return q{t // 2};")
        lines.append("  }")
    lines += ["  default: return 0.f;", "  }", "}"]
    return "\n".join(lines)


def network_header() -> str:
    """Source of ``median_networks.cuh``, generated from ops/networks.py."""
    parts = ["// Generated from dips_tpu_torch/ops/networks.py by "
             "ops/_build.py; do not edit.",
             "#pragma once",
             f"#define DIPS_MAX_T {MAX_T}"]
    for w in WINDOWS:
        if w > 1:
            parts += [_window_median_fn(w), _separable_median_fn(w),
                      _quirk_select_fn(w)]
    parts.append(_temporal_median_fn())
    return "\n\n".join(parts) + "\n"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels cannot be built")
    return found


def build_key(header: str) -> str:
    h = hashlib.sha256()
    for name in sorted(p.name for p in CSRC.iterdir()
                       if p.suffix in (".cu", ".cuh")):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(header.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(force: bool = False) -> Path:
    """Compile the kernels unless the cached library for these sources
    exists; returns the library path.  Raises with nvcc's output when the
    build fails."""
    header = network_header()
    out_dir = BUILD_ROOT / build_key(header)
    lib_path = out_dir / LIB_NAME
    log_path = out_dir / "ptxas.log"
    if lib_path.exists() and not force:
        build_info.update(dir=str(out_dir), seconds=0.0,
                          ptxas=log_path.read_text() if log_path.exists()
                          else "")
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "median_networks.cuh").write_text(header)
    nvcc, tag = _nvcc(), os.getpid()
    objs = [out_dir / f"{Path(src).stem}.{tag}.o" for src in SOURCES]
    t0 = time.perf_counter()
    # one nvcc per source, all running at once; then one link
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-I", str(out_dir), "-I",
                          str(CSRC), "-c", "-o", str(obj), str(CSRC / src)]
                         for src, obj in zip(SOURCES, objs))]
    report = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        report.append(err + out)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{out}\n{err}")
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
           "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    for obj in objs:
        obj.unlink()
    ptxas = "".join(report)
    log_path.write_text(ptxas)
    os.replace(tmp, lib_path)
    build_info.update(dir=str(out_dir), seconds=seconds, ptxas=ptxas)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.dips_error_string.argtypes = [ctypes.c_int]
        handle.dips_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        why = lib().dips_error_string(rc).decode()
        raise RuntimeError(f"{name} failed: CUDA error {rc} ({why})")
