"""Build and load the port's CUDA kernels.

The sources under ``dips_tpu_torch/csrc/`` are compiled with ``nvcc`` into
one shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers in the build, so it takes seconds, not minutes).  Each
compile unit runs in its own ``nvcc`` process, all started together, and
one more ``nvcc`` links the objects: the raw kernel's source, and each
median kernel's source once per spatial window (``-DDIPS_WINDOW=w``): 9
processes for the 42 median instances and the raw kernel.  Every unit
exports its own entry points (``dips_median_ring_w3``, ...), so a library
may hold any set of units.  The build runs at first use, from the
package's own sources only, into ``BUILD_ROOT/<key>/``
(``build/dips_tpu_torch/`` at the repository root, or the directory that
``utils/compilecache.py`` names), where ``<key>`` is a hash of the sources,
of the generated network header, of the compiler flags, of the units, and
of the toolchain (nvcc's version and the card's compute capability): a
changed source builds anew, an unchanged one loads the cached library.
The build holds an exclusive lock on its directory, so processes sharing a
cache directory never write the same files at once.

The box mean of a downscaled engine's layout prep (``pool_prep.cu``,
:data:`POOL_UNIT`) is a unit outside that library: a library of that
unit alone (one more nvcc) is built for the first process that asks for
it (a downscaled engine on a card, when it is made), and the key of the
default library does not read its source, so a process that never
downscales builds and loads what it did before.

The kernels' block geometry is a build parameter (:class:`Geometry`: the
median kernels' :class:`MedianTile`, the raw kernel's :class:`RawBlock`),
passed as ``-D`` flags; the default geometry adds none and builds the
library above.  Another geometry is built per unit, only for the kernel
that launches it (``ops/cuda_fused.py`` asks for it when
``ops/tuning.py``'s store names one; ``autotune.py`` builds its
candidates so).

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

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass, field, fields
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

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
RAW_UNIT = UNITS[0]
#: the box mean of a downscaled engine's layout prep: a unit of its own,
#: outside the default library, built only for a process that asks for it
POOL_UNIT = ("pool_prep.cu", None)
LIB_NAME = "libdips_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")
#: largest temporal ring the median kernels carry (in shared memory)
MAX_T = 16



@dataclass(frozen=True)
class MedianTile:
    """The median kernels' tile (``csrc/median_common.cuh``): ``rows`` tile
    rows, a warp each; ``px`` adjacent pixels a thread (so 32 * px tile
    columns); ``stages`` frames staged ahead by TMA.  Raises
    ``ValueError`` outside what the kernels take: rows a multiple of 8 up
    to 32 (32 * rows threads), px 1, 2 or 4 (the TMA box is 32 * px + 32
    columns, starting on a 16-byte column), stages 1 to 8."""

    rows: int = 8
    px: int = 4
    stages: int = 3

    def __post_init__(self):
        for f in fields(self):
            if type(getattr(self, f.name)) is not int:
                raise ValueError(f"tile {f.name} must be an int")
        if self.rows % 8 or not 8 <= self.rows <= 32:
            raise ValueError(f"tile rows {self.rows}: a multiple of 8 up "
                             f"to 32")
        if self.px not in (1, 2, 4):
            raise ValueError(f"tile px {self.px}: 1, 2 or 4")
        if not 1 <= self.stages <= 8:
            raise ValueError(f"tile stages {self.stages}: 1 to 8")

    @property
    def cols(self) -> int:
        return 32 * self.px

    def name(self) -> str:
        return f"{self.rows}x{self.cols}/s{self.stages}"

    def smem_bytes(self, window: int, mode: int, t: int) -> int:
        """Dynamic shared memory of a launch with window ``window``,
        spatial mode ``mode`` (0 exact, 1 approx, 2 quirk) and ``t`` ring
        slots: ``Tile<W, M, kBands>::smem_bytes`` of median_common.cuh,
        which the library reports too (``dips_median_*_smem_w<W>``)."""
        p = window // 2
        box_w = self.cols + 32
        halo_pad = -(-3 * p * box_w // 128) * 128
        stage = 2 * halo_pad + 3 * self.rows * box_w
        sort = mode == 0 and window > 1
        colmed = mode == 1 and window > 1
        strips = 1 if sort or colmed else 2
        strip_rows = self.rows + 2 * p
        sc = self.cols + 8
        col_rows = self.rows * window if sort else (self.rows if colmed
                                                    else 0)
        strip_off = self.stages * stage + 8 * self.stages
        col_off = strip_off + 2 * strips * strip_rows * sc
        ring_off = -(-(col_off + 2 * col_rows * sc) // 16) * 16
        return 128 + ring_off + t * self.px * 32 * self.rows * 4


@dataclass(frozen=True)
class RawBlock:
    """The raw kernel's block (``csrc/raw_ring.cu``): ``threads`` consumer
    threads, a tile of as many chunks, and a producer warp besides;
    ``bytes`` bytes of a row a chunk (a thread's in a tile).  Raises
    ``ValueError`` outside what the kernel takes: threads a multiple of 32
    up to 992 (with the producer's warp, 1024), bytes 16 or 32 (whole
    uint4s).

    The launch's grid is the card's, not the image's: ``blocks`` a stream
    (:meth:`blocks`), each owning a contiguous share of the stream's
    chunks and walking it in ``tiles`` tiles (:meth:`tiles`); the methods
    below mirror the kernel's own arithmetic (:meth:`split`, :meth:`parts`,
    :meth:`smem_bytes`), which the library reports too."""

    threads: int = 256
    bytes: int = 16

    def __post_init__(self):
        for f in fields(self):
            if type(getattr(self, f.name)) is not int:
                raise ValueError(f"block {f.name} must be an int")
        if self.threads % 32 or not 32 <= self.threads <= 992:
            raise ValueError(f"block threads {self.threads}: a multiple "
                             f"of 32 up to 992")
        if self.bytes not in (16, 32):
            raise ValueError(f"block bytes {self.bytes}: 16 or 32")

    def name(self) -> str:
        return f"{self.threads}x{self.bytes}"

    def chunks(self, hp: int, wp: int) -> int:
        """Chunks of one stream's Hp x Wp plane."""
        return hp * wp // self.bytes

    def blocks(self, s: int, hp: int, wp: int, resident: int) -> int:
        """Blocks a stream (the launch's grid is this x s): the
        ``resident`` blocks the card holds at once (``dips_raw_resident``
        of the launch's out mode) shared among the s streams, at least one
        a stream, and no more than the stream has whole tiles of chunks."""
        whole = max(1, self.chunks(hp, wp) // self.threads)
        return max(1, min(resident // s, whole))

    def tiles(self, hp: int, wp: int, nb: int) -> int:
        """Tiles each of the ``nb`` blocks of a stream walks: as many as
        the largest share needs."""
        share = -(-self.chunks(hp, wp) // nb)
        return -(-share // self.threads)

    def parts(self, hp: int, wp: int, nb: int) -> int:
        """Statistic partials per (frame, stream): one per block, tile and
        warp (``dips_raw_parts``)."""
        return nb * self.tiles(hp, wp, nb) * (self.threads // 32)

    def split(self, hp: int, wp: int, nb: int) -> list:
        """[(first chunk, chunks)] of every tile, block by block, as the
        kernel cuts a stream: ``nb`` shares that differ by at most one
        chunk, each cut into :meth:`tiles` pieces the same way."""
        n, t = self.chunks(hp, wp), self.tiles(hp, wp, nb)
        out = []
        for b in range(nb):
            lo, share = _piece(n, nb, b)
            for k in range(t):
                start, size = _piece(share, t, k)
                out.append((lo + start, size))
        return out

    @property
    def stages(self) -> int:
        """Items staged ahead (``kStages``): 4 where four stages of the
        tile's three planes fit in 96 KB, else as many as fit, at least
        2."""
        return min(4, max(2, 96 * 1024 // (3 * self.threads * self.bytes)))

    def smem_bytes(self) -> int:
        """Dynamic shared memory of a block (``dips_raw_smem``)."""
        return 128 + self.stages * 3 * self.threads * self.bytes


def _piece(n: int, parts: int, k: int) -> Tuple[int, int]:
    """The k-th of ``parts`` near-equal pieces of range(n): (first index,
    size), the larger pieces first (``piece`` in csrc/raw_ring.cu)."""
    q, r = divmod(n, parts)
    return k * q + min(k, r), q + (k < r)


@dataclass(frozen=True)
class Geometry:
    """The kernels' block geometry, a build parameter."""

    tile: MedianTile = field(default_factory=MedianTile)
    block: RawBlock = field(default_factory=RawBlock)

    def defines(self) -> Tuple[str, ...]:
        """The ``-D`` flags of the fields that differ from the defaults
        (none for the default geometry)."""
        macros = {("tile", "rows"): "DIPS_TILE_ROWS",
                  ("tile", "px"): "DIPS_PX",
                  ("tile", "stages"): "DIPS_STAGES",
                  ("block", "threads"): "DIPS_RAW_THREADS",
                  ("block", "bytes"): "DIPS_RAW_BYTES"}
        out = []
        for (part, name), macro in macros.items():
            v = getattr(getattr(self, part), name)
            if v != getattr(getattr(DEFAULT, part), name):
                out.append(f"-D{macro}={v}")
        return tuple(out)


DEFAULT = Geometry()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C signatures: every pointer and the stream as c_void_p
RAW_SIGNATURES = {
    # raw, prev, base, heat, out, parts, stats, flags, valid, seeds,
    # S, B, Hp, Wp, nb, overall, out_mode, thr, y0, x0, y1, x1,
    # heat_scale, sum_scale, max_scale, stream
    "dips_raw_ring": [_P] * 10 + [_I] * 12 + [_F] * 3 + [_P],
    # raw, base, heat, out, parts, stats, flags, valid,
    # S, B, T, Hp, Wp, nb, overall, out_mode, thr, y0, x0, y1, x1,
    # heat_scale, sum_scale, max_scale, stream
    "dips_raw_tail": [_P] * 8 + [_I] * 13 + [_F] * 3 + [_P],
    # out mode -> blocks the current card holds at once (a CUDA error:
    # -code)
    "dips_raw_resident": [_I],
    # Hp, Wp, nb -> statistic partials per (frame, stream)
    "dips_raw_parts": [_I, _I, _I],
    # -> dynamic shared memory of a block
    "dips_raw_smem": [],
}
MEDIAN_SIGNATURES = {
    # raw, btop, bbot, ring, prev, base, heat, out, parts, flags, valid,
    # offs, seeds,
    # S, B, Hp, Wp, T, W, spatial mode, overall, out_mode, chroma, filter,
    # k, sens, lo_clip, hi_clip, scale, thr, y0, x0, y1, x1, stream
    "ring": [_P] * 13 + [_I] * 11 + [_F] * 6 + [_I] * 4 + [_P],
    # raw, btop, bbot, base, heat, out, parts, flags, valid,
    # S, B, Hp, Wp, T, W, spatial mode, overall, out_mode, chroma, filter,
    # k, sens, lo_clip, hi_clip, scale, thr, y0, x0, y1, x1, stream
    "tail": [_P] * 9 + [_I] * 11 + [_F] * 6 + [_I] * 4 + [_P],
}


#: the pool unit's entry point: in, out, S, F, H, W, k, the output's
#: stream, frame, plane and row strides, swap, 1/k^2, stream
POOL_SIGNATURES = {
    "dips_pool_prep": [_P, _P] + [_I] * 5 + [ctypes.c_longlong] * 4
    + [_I, _F, _P],
}


def median_unit(tail: bool, window: int) -> Tuple[str, int]:
    """The compile unit that holds one median kernel's window."""
    return ("median_tail.cu" if tail else "median_ring.cu", window)


def median_symbol(tail: bool, window: int, what: str = "") -> str:
    """A median unit's entry point: the launch (``what`` ""), ``parts``
    (statistic partials a frame and section) or ``smem`` (a launch's
    dynamic shared memory)."""
    kind = "tail" if tail else "ring"
    return f"dips_median_{kind}{'_' + what if what else ''}_w{window}"


def unit_signatures(unit: Tuple[str, Optional[int]]) -> dict:
    """The entry points a compile unit exports, with their C signatures."""
    src, w = unit
    if src == RAW_UNIT[0]:
        return dict(RAW_SIGNATURES)
    if src == POOL_UNIT[0]:
        return dict(POOL_SIGNATURES)
    tail = src == "median_tail.cu"
    return {median_symbol(tail, w): MEDIAN_SIGNATURES["tail" if tail
                                                      else "ring"],
            median_symbol(tail, w, "parts"): [_I, _I],
            median_symbol(tail, w, "smem"): [_I, _I]}


#: every entry point of the default library
SIGNATURES = {name: sig for unit in UNITS
              for name, sig in unit_signatures(unit).items()}

_lib: Optional[ctypes.CDLL] = None
#: held while one thread builds and loads the library: the object files
#: and the temporary library are named by pid, so two threads of one
#: process (a server's sessions at their first launch) must not build at
#: once
_lib_lock = threading.Lock()
#: libraries of other geometries and unit sets, and a lock for each
_libs: Dict[tuple, ctypes.CDLL] = {}
_key_locks: Dict[tuple, threading.Lock] = {}
#: what the last build or load did: directory, seconds, ptxas report
build_info: Dict[str, object] = {}
#: nvcc path -> its version line
_nvcc_versions: Dict[str, str] = {}


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


def toolchain() -> str:
    """What else a built library depends on: nvcc's version line and the
    first card's compute capability ("none" for either that is absent)."""
    try:
        nvcc = _nvcc()
    except RuntimeError:
        nvcc = None
    version = "none"
    if nvcc is not None:
        if nvcc not in _nvcc_versions:
            try:
                out = subprocess.run([nvcc, "--version"],
                                     capture_output=True, text=True,
                                     timeout=60).stdout.strip()
                _nvcc_versions[nvcc] = out.splitlines()[-1] if out \
                    else "unknown"
            except (OSError, subprocess.SubprocessError):
                _nvcc_versions[nvcc] = "none"
        version = _nvcc_versions[nvcc]
    capability = "none"
    import torch
    try:
        if torch.cuda.is_available():
            capability = "sm_%d%d" % torch.cuda.get_device_capability(0)
    except (RuntimeError, AssertionError):
        pass
    return f"nvcc {version}; device {capability}"


def _units(units) -> tuple:
    return UNITS if units is None else tuple(units)


def build_key(header: str, geometry: Optional[Geometry] = None,
              units=None) -> str:
    """Hash of what a library is built from: the sources (the headers,
    the default library's and the units'), the network header, the
    compiler flags (the geometry's ``-D`` flags among them), the compile
    units and :func:`toolchain`."""
    geometry = geometry or DEFAULT
    h = hashlib.sha256()
    names = {p.name for p in CSRC.iterdir() if p.suffix == ".cuh"}
    names |= set(SOURCES) | {src for src, _ in _units(units)}
    for name in sorted(names):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(header.encode())
    h.update(" ".join(NVCC_FLAGS + geometry.defines()).encode())
    h.update(repr(_units(units)).encode())
    h.update(toolchain().encode())
    return h.hexdigest()[:16]


def compile_commands(nvcc: str, out_dir: Path, tag: object,
                     geometry: Optional[Geometry] = None,
                     units=None) -> list:
    """[(nvcc command, object file)] of each compile unit."""
    geometry = geometry or DEFAULT
    out = []
    for src, w in _units(units):
        obj = out_dir / f"{Path(src).stem}.w{w or 0}.{tag}.o"
        out.append(([nvcc, *NVCC_FLAGS, *geometry.defines(), "-I",
                     str(out_dir), "-I", str(CSRC)]
                    + ([] if w is None else [f"-DDIPS_WINDOW={w}"])
                    + ["-c", "-o", str(obj), str(CSRC / src)], obj))
    return out


@contextlib.contextmanager
def _dir_lock(out_dir: Path) -> Iterator[None]:
    """An exclusive lock on a build directory (released when the process
    ends, so a killed build leaves no stale lock)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    fd = os.open(out_dir / ".lock", os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)


def build(force: bool = False, geometry: Optional[Geometry] = None,
          units=None) -> Path:
    """Compile the kernels of ``geometry`` (default: :data:`DEFAULT`) in
    ``units`` (default: all of :data:`UNITS`) unless the cached library
    exists; returns the library path.  Raises with nvcc's output when the
    build fails."""
    header = network_header()
    out_dir = BUILD_ROOT / build_key(header, geometry, units)
    with _dir_lock(out_dir):
        return _build_locked(out_dir, header, force, geometry, units)


def _build_locked(out_dir: Path, header: str, force: bool,
                  geometry: Optional[Geometry], units) -> Path:
    lib_path = out_dir / LIB_NAME
    log_path = out_dir / "ptxas.log"
    if lib_path.exists() and not force:
        build_info.update(dir=str(out_dir), seconds=0.0,
                          ptxas=log_path.read_text() if log_path.exists()
                          else "")
        return lib_path
    (out_dir / "median_networks.cuh").write_text(header)
    nvcc, tag = _nvcc(), f"{os.getpid()}.{threading.get_ident()}"
    cmds = compile_commands(nvcc, out_dir, tag, geometry, units)
    objs = [obj for _, obj in cmds]
    t0 = time.perf_counter()
    # one nvcc per compile unit, all running at once; then one link
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd, _ in cmds]
    # wait for every unit before raising, so that no nvcc outlives a
    # failed build
    done = [(cmd, proc, *proc.communicate()) for cmd, proc in procs]
    report = []
    for cmd, proc, out, err in done:
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


def _bind(path: Path, signatures: dict) -> ctypes.CDLL:
    handle = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    handle.dips_error_string.argtypes = [ctypes.c_int]
    handle.dips_error_string.restype = ctypes.c_char_p
    return handle


def lib(geometry: Optional[Geometry] = None, units=None) -> ctypes.CDLL:
    """The loaded kernel library of ``geometry`` and ``units`` (default:
    the default geometry, every unit), built at first use by one thread
    while any others wait for it."""
    global _lib
    if (geometry is None or geometry == DEFAULT) and units is None:
        if _lib is not None:
            return _lib
        with _lib_lock:
            if _lib is None:
                _lib = _bind(build(), SIGNATURES)
        return _lib
    key = (geometry or DEFAULT, _units(units))
    if key in _libs:
        return _libs[key]
    with _lib_lock:
        lock = _key_locks.setdefault(key, threading.Lock())
    with lock:
        if key not in _libs:
            signatures = {name: sig for unit in key[1]
                          for name, sig in unit_signatures(unit).items()}
            _libs[key] = _bind(build(geometry=key[0], units=key[1]),
                               signatures)
    return _libs[key]


def kernel_lib(geometry: Geometry, unit) -> ctypes.CDLL:
    """The library a launch of ``unit``'s kernel in ``geometry`` uses: the
    default library for the default geometry, else one built of that unit
    alone."""
    if geometry == DEFAULT:
        return lib()
    return lib(geometry, (unit,))


def check(rc: int, name: str, handle: Optional[ctypes.CDLL] = None) -> None:
    """Raise when a C entry point of ``handle`` (default: the default
    library) returned a CUDA error code."""
    if rc != 0:
        why = (handle or lib()).dips_error_string(rc).decode()
        raise RuntimeError(f"{name} failed: CUDA error {rc} ({why})")
