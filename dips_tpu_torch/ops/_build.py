"""Build and load the port's CUDA kernels.

The sources under ``dips_tpu_torch/csrc/`` are compiled with ``nvcc`` into
one shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers in the build, so it takes seconds, not minutes).  Each
compile unit runs in its own ``nvcc`` process, all started together, and
one more ``nvcc`` links the objects: the raw kernel's source, and each
median kernel's source once per spatial window (``-DDIPS_WINDOW=w``): 9
processes for the 42 median instances and the raw kernel.  The build
runs at first use, from the package's own sources only, into
``build/dips_tpu_torch/<key>/`` at the repository root, where ``<key>`` is a
hash of the sources, of the generated network header and of the compiler
flags: a changed source builds anew, an unchanged one loads the cached
library.

The median kernels' selection networks are generated here from
``ops/networks.py`` (the column sort and the merge plan of the
column-factored window median, separable medians, the quirk window's rank
selection and the temporal median networks the plain version applies with
``torch.minimum`` / ``torch.maximum``) into ``median_networks.cuh`` beside
the library.  The per-pixel networks read their taps through a functor
(``s(dx, j)``), so the kernel decides where a tap lies in shared memory.

The median kernels stage their frames with TMA; the tensor maps are
encoded on the host by ``cuTensorMapEncodeTiled``, which the library looks
up through the CUDA runtime's entry-point query (no ``-lcuda``).

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
import threading
import time
from pathlib import Path
from typing import Dict, Optional

from . import networks

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "dips_tpu_torch"
SOURCES = ("raw_ring.cu", "median_ring.cu", "median_tail.cu")
#: spatial windows the median kernels are instantiated for
WINDOWS = (1, 3, 5, 7)
#: compile units, (source, window): each median source once per window
#: with that window's instances (-DDIPS_WINDOW=w; the window-1 unit also
#: holds the entry points), so that they compile in parallel; finer units
#: (one per window and mode) build slower on 8 cores, each nvcc having a
#: fixed cost of a few CPU-seconds.
UNITS = (("raw_ring.cu", None),) + tuple(
    (src, w) for src in SOURCES[1:] for w in WINDOWS)
LIB_NAME = "libdips_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")
#: largest temporal ring the median kernels carry (in shared memory)
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
    # Hp, Wp -> statistic partials per (frame, section), 0: not whole tiles
    "dips_median_parts": [_I, _I],
}

_lib: Optional[ctypes.CDLL] = None
#: held while one thread builds and loads the library: the object files
#: and the temporary library are named by pid, so two threads of one
#: process (a server's sessions at their first launch) must not build at
#: once
_lib_lock = threading.Lock()
#: what the last build or load did: directory, seconds, ptxas report
build_info: Dict[str, object] = {}


def _cmpx(i: int, j: int, need_min: bool, need_max: bool, v: str) -> str:
    a, b = f"{v}{i}", f"{v}{j}"
    if need_min and need_max:
        return f"  {{ auto t = min({a}, {b}); {b} = max({a}, {b}); {a} = t; }}"
    if need_min:
        return f"  {a} = min({a}, {b});"
    return f"  {b} = max({a}, {b});"


def _column_sort_fn(w: int) -> str:
    """``void csort<w>(int* s)``: sorts ``s[0..w)`` ascending in place --
    the ``col_sort`` of ``networks.column_median_plan``, which the kernels
    apply ONCE per column and tile row and share among the w pixels whose
    windows hold that column."""
    col_sort, _, _ = networks.column_median_plan(w)
    lines = [f"__device__ __forceinline__ void csort{w}(int* s) {{"]
    lines += [f"  int v{j} = s[{j}];" for j in range(w)]
    lines += [_cmpx(i, j, True, True, "v") for i, j in col_sort]
    lines += [f"  s[{j}] = v{j};" for j in range(w)]
    lines.append("}")
    return "\n".join(lines)


def _window_merge_fn(w: int) -> str:
    """``int wmerge<w>(Tap s)``: the exact median of a w x w window from
    its w sorted columns, ``s(dx, j)`` the j-th smallest tap of column dx
    (wire ``dx * w + j``), through the pruned merge plan of
    ``networks.column_median_plan`` -- the per-pixel half of
    ``networks.window_median``."""
    _, merge_ops, target = networks.column_median_plan(w)
    lines = ["template <class Tap>",
             f"__device__ __forceinline__ int wmerge{w}(Tap s) {{"]
    lines += [f"  int v{dx * w + j} = s({dx}, {j});"
              for dx in range(w) for j in range(w)]
    lines += [_cmpx(i, j, nmin, nmax, "v") for i, j, nmin, nmax in merge_ops]
    lines.append(f"  return v{target};")
    lines.append("}")
    return "\n".join(lines)


def _separable_median_fn(w: int) -> str:
    """``int smed<w>(Tap s)``: the median of the w taps ``s(0) .. s(w-1)``
    through ``networks.median_network(w)`` -- the building block of
    ``networks.separable_median``: down a column, then across the w column
    medians."""
    lines = ["template <class Tap>",
             f"__device__ __forceinline__ int smed{w}(Tap s) {{"]
    lines += [f"  int v{j} = s({j});" for j in range(w)]
    lines += [_cmpx(i, j, nmin, nmax, "v")
              for i, j, nmin, nmax in networks.median_network(w)]
    lines.append(f"  return v{w // 2};")
    lines.append("}")
    return "\n".join(lines)


def _quirk_select_fn(w: int) -> str:
    """``int qsel<w>(Tap s)``: ``networks.quirk_window_select`` -- the tap
    of rank ``w*w//2 + 1 - 2w`` of the off-center (w-1) x (w-1) window
    whose taps are ``s(dx, dy)`` (offsets [-p, p) in both axes), through
    ``networks.selection_network``; wire ``dx * (w-1) + dy`` is tap
    (dy, dx), as the plain version orders them.  At w = 3 the rank is
    negative and the result is 0."""
    wm1 = w - 1
    rank = (w * w) // 2 + 1 - 2 * w
    lines = ["template <class Tap>",
             f"__device__ __forceinline__ int qsel{w}(Tap s) {{"]
    if rank < 0:
        lines += ["  return 0;", "}"]
        return "\n".join(lines)
    lines += [f"  int v{dx * wm1 + dy} = s({dx}, {dy});"
              for dx in range(wm1) for dy in range(wm1)]
    lines += [_cmpx(i, j, nmin, nmax, "v") for i, j, nmin, nmax
              in networks.selection_network(wm1 * wm1, (rank,))]
    lines.append(f"  return v{rank};")
    lines.append("}")
    return "\n".join(lines)


def _temporal_median_fn() -> str:
    """``auto tmed(Tap s, int t)``: the exact median (index t // 2) of the
    ring slots ``s(0) .. s(t-1)``, through ``networks.median_network(t)``
    for each t, selected by a switch on the runtime ring length."""
    lines = ["template <class Tap>",
             "__device__ __forceinline__ auto tmed(Tap s, int t) {",
             "  switch (t) {"]
    for t in range(1, MAX_T + 1):
        lines.append(f"  case {t}: {{")
        for k in range(t):
            lines.append(f"    auto q{k} = s({k});")
        for i, j, nmin, nmax in networks.median_network(t):
            lines.append("  " + _cmpx(i, j, nmin, nmax, "q"))
        lines.append(f"    return q{t // 2};")
        lines.append("  }")
    lines += ["  default: { auto q0 = s(0); return q0; }", "  }", "}"]
    return "\n".join(lines)


def network_header() -> str:
    """Source of ``median_networks.cuh``, generated from ops/networks.py."""
    parts = ["// Generated from dips_tpu_torch/ops/networks.py by "
             "ops/_build.py; do not edit.",
             "#pragma once",
             f"#define DIPS_MAX_T {MAX_T}"]
    for w in WINDOWS:
        if w > 1:
            parts += [_column_sort_fn(w), _window_merge_fn(w),
                      _separable_median_fn(w), _quirk_select_fn(w)]
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
    h.update(repr(UNITS).encode())
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
    objs = [out_dir / f"{Path(src).stem}.w{w or 0}.{tag}.o"
            for src, w in UNITS]
    t0 = time.perf_counter()
    # one nvcc per compile unit, all running at once; then one link
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-I", str(out_dir), "-I",
                          str(CSRC)]
                         + ([] if w is None else [f"-DDIPS_WINDOW={w}"])
                         + ["-c", "-o", str(obj), str(CSRC / src)]
                         for (src, w), obj in zip(UNITS, objs))]
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
    """The loaded kernel library (built at first use, by one thread while
    any others wait for it)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
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
