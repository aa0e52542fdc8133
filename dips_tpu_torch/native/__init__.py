"""ctypes bindings for the framepump native host runtime.

Loads ``libframepump.so`` (built lazily with the in-tree Makefile on first
use if g++ is available) and exposes:

* :func:`planarize` / :func:`interleave` — fused single-pass layout
  transforms for the decode/encode hot path;
* :class:`FrameRing` — bounded SPSC frame ring with preallocated slots,
  its copies outside its lock and a large pop on the copy pool;
* :func:`copy_pieces` — a gather copy on a persistent pool of host
  threads (``utils/staging.py`` decides when to take it).

Every entry point has a pure-numpy fallback, so the package works without a
toolchain (``NATIVE_AVAILABLE`` tells you which path is live; set
``DIPS_TPU_NO_NATIVE=1`` to force the fallback).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import logging
import os
import subprocess
from typing import Optional

import numpy as np

log = logging.getLogger("dips_tpu_torch.native")

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libframepump.so")

_lib: Optional[ctypes.CDLL] = None


def _build(force: bool = False) -> bool:
    try:
        if force:  # new inode, so a re-dlopen can't alias the old mapping
            try:
                os.remove(_SO)
            except OSError:
                pass
        subprocess.run(["make", "-C", _DIR, "-s"], check=True,
                       capture_output=True, timeout=120)
        return os.path.exists(_SO)
    except Exception as e:
        log.debug("framepump build failed: %s", e)
        return False


def _bind(lib: ctypes.CDLL) -> None:
    """Declare every exported symbol's signature.  Raises AttributeError
    when the loaded .so predates one of them (a stale prebuilt binary)."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    lib.fp_planarize.argtypes = [u8p, i64, i64, i64, i64, u8p, i64, i64,
                                 ctypes.c_int]
    lib.fp_interleave.argtypes = [u8p, i64, i64, i64, i64, i64, u8p,
                                  ctypes.c_int]
    lib.fp_ring_create.restype = ctypes.c_void_p
    lib.fp_ring_create.argtypes = [i64, i64]
    lib.fp_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.fp_ring_push.argtypes = [ctypes.c_void_p, u8p, i64]
    lib.fp_ring_push.restype = ctypes.c_int
    lib.fp_ring_pop_pooled.argtypes = [ctypes.c_void_p, u8p, i64, i64, i64,
                                       ctypes.c_int]
    lib.fp_ring_pop_pooled.restype = ctypes.c_int
    lib.fp_ring_close.argtypes = [ctypes.c_void_p]
    lib.fp_ring_size.argtypes = [ctypes.c_void_p]
    lib.fp_ring_size.restype = i64
    lib.fp_simd_level.restype = ctypes.c_int
    lib.fp_copy_pieces.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, i64, i64, ctypes.c_int]
    lib.fp_copy_pieces.restype = ctypes.c_int


def _load() -> Optional[ctypes.CDLL]:
    if os.environ.get("DIPS_TPU_NO_NATIVE"):
        return None
    if not os.path.exists(_SO):
        if not _build():
            return None
    else:
        _build()  # sources newer than the .so rebuild; failure (no
        #           toolchain) keeps the existing binary
    for attempt in (0, 1):
        try:
            lib = ctypes.CDLL(_SO)
        except OSError as e:
            log.warning("framepump load failed: %s", e)
            return None
        try:
            _bind(lib)
            return lib
        except AttributeError as e:
            # a prebuilt .so from an older source tree lacks a symbol:
            # force one rebuild, then fall back to numpy rather than
            # crash the package import.  dlopen dedupes by PATH, so the
            # stale mapping must be dlclosed or the reload returns it.
            try:
                import _ctypes
                _ctypes.dlclose(lib._handle)
            except Exception:
                pass
            del lib
            if attempt or not _build(force=True):
                log.warning("framepump .so is stale (%s); using the "
                            "numpy fallback", e)
                return None
    return None


@contextlib.contextmanager
def _lock():
    """An exclusive lock on the module's directory, held while it builds
    and loads the library: processes importing the package at once would
    otherwise write the same .so together, and one of them dlopen a
    half-written file.  No lock where the directory cannot be opened."""
    try:
        fd = os.open(_DIR, os.O_RDONLY)
    except OSError:
        yield
        return
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)  # releases the lock


with _lock():
    _lib = _load()
NATIVE_AVAILABLE = _lib is not None

SIMD_NAMES = {-1: "unavailable", 0: "scalar", 1: "ssse3", 2: "avx512vbmi"}


def simd_level() -> int:
    """SIMD tier of the loaded layout kernels: 0 scalar, 1 SSSE3 (16 px/
    iter), 2 AVX-512 VBMI (64 px/iter); -1 when the native module did not
    load.  Capped at runtime by ``DIPS_TPU_SIMD=scalar|ssse3|avx512``
    (re-read per call, so tests can flip tiers)."""
    return int(_lib.fp_simd_level()) if _lib is not None else -1


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def planarize(frame: np.ndarray, hp: int, wp: int,
              swap_rb: bool = False,
              out: Optional[np.ndarray] = None) -> np.ndarray:
    """HWC uint8 (h, w, 3|4) -> zero-padded planar (3, hp, wp) uint8.

    ``swap_rb=True`` converts BGR(A) input to RGB planes in the same pass.
    """
    h, w, c = frame.shape
    if h > hp or w > wp:
        # the native kernel writes y*wp+x for y<h unclamped — an oversized
        # frame (e.g. a mid-stream caps change on a network source) must
        # fail loudly here, not corrupt the heap
        raise ValueError(f"frame {w}x{h} exceeds padded geometry "
                         f"{wp}x{hp} (geometry changed mid-stream?)")
    if out is None:
        out = np.empty((3, hp, wp), np.uint8)
    if _lib is not None and frame.dtype == np.uint8:
        src = np.ascontiguousarray(frame)
        _lib.fp_planarize(_u8p(src), h, w, c, w * c, _u8p(out), hp, wp,
                          1 if swap_rb else 0)
        return out
    # numpy fallback
    rgb = frame[..., :3]
    if swap_rb:
        rgb = rgb[..., ::-1]
    out[:] = 0
    out[:, :h, :w] = np.moveaxis(rgb, -1, 0)
    return out


def interleave(planes: np.ndarray, h: int, w: int,
               swap_rb: bool = False,
               out: Optional[np.ndarray] = None) -> np.ndarray:
    """Planar uint8 (c, hp, wp) -> HWC (h, w, 3) uint8, cropping padding;
    c == 1 broadcasts gray.  ``swap_rb=True`` emits BGR for cv2 encoders."""
    c, hp, wp = planes.shape
    if h > hp or w > wp:
        raise ValueError(f"crop {w}x{h} exceeds plane geometry {wp}x{hp}")
    if out is None:
        out = np.empty((h, w, 3), np.uint8)
    if _lib is not None and planes.dtype == np.uint8:
        src = np.ascontiguousarray(planes)
        _lib.fp_interleave(_u8p(src), c, hp, wp, h, w, _u8p(out),
                           1 if swap_rb else 0)
        return out
    crop = planes[:, :h, :w]
    if c == 1:
        crop = np.broadcast_to(crop, (3, h, w))
    hwc = np.moveaxis(crop, 0, -1)
    if swap_rb:
        hwc = hwc[..., ::-1]
    out[:] = hwc
    return out


def copy_pieces(dst: np.ndarray, src: np.ndarray, nbytes: np.ndarray,
                chunk: int, threads: int) -> int:
    """Copy ``nbytes[i]`` bytes from address ``src[i]`` to ``dst[i]`` for
    every i (uintp / int64 arrays of one length), each piece cut into
    chunks of ``chunk`` bytes, on the calling thread and a pool of
    ``threads - 1`` workers that the first call in a process starts (a
    forked child starts its own).  The GIL is released for the copy.
    Returns the pool's copiers, the caller included.  The caller keeps
    the arrays behind the addresses alive and checks that no two pieces
    overlap; without the native module this raises ``RuntimeError``
    (``utils/staging.py`` copies through NumPy instead)."""
    if _lib is None:
        raise RuntimeError("framepump native module not loaded")
    n = len(nbytes)
    if len(dst) != n or len(src) != n:
        raise ValueError("copy_pieces: dst, src and nbytes differ in length")
    dst = np.ascontiguousarray(dst, np.uintp)
    src = np.ascontiguousarray(src, np.uintp)
    nbytes = np.ascontiguousarray(nbytes, np.int64)
    return int(_lib.fp_copy_pieces(dst.ctypes.data, src.ctypes.data,
                                   nbytes.ctypes.data, n, int(chunk),
                                   int(threads)))


class FrameRing:
    """Bounded SPSC ring of fixed-size byte slots (native when available).

    The staging buffer between the decode thread and the device feeder: the
    native analogue of the reference's frame VecDeque + streaming-thread
    handoff.  ``push`` blocks when full (backpressure); ``pop`` blocks with a
    timeout; ``close`` lets consumers drain then signals EOS.

    The native ring copies outside its lock, so a push and a pop copy at
    the same time; a pop of more than ``utils/staging.POOL_ABOVE`` bytes
    copies on the pool of :func:`copy_pieces` (``CHUNK_BYTES`` chunks,
    ``pool_threads()`` copiers), a smaller one on the calling thread.
    ``pops`` counts the frames popped, ``pooled_pops`` those the pool
    copied.
    """

    def __init__(self, slots: int, slot_bytes: int,
                 use_native: Optional[bool] = None):
        self.slots = int(slots)
        self.slot_bytes = int(slot_bytes)
        self._native = (_lib is not None) if use_native is None else (
            use_native and _lib is not None)
        self.pops = self.pooled_pops = 0
        if self._native:
            from ..utils import staging
            self._staging = staging
            self._threads = staging.pool_threads()
            self._h = _lib.fp_ring_create(self.slots, self.slot_bytes)
            if not self._h:
                raise MemoryError("fp_ring_create failed")
        else:
            # Pure-Python twin of framepump.cpp's ring: preallocated slots,
            # wrapping head/tail cursors (the reference's UCircularIndex,
            # dips/src/utils/indexing.rs:1-34), one condition variable.
            import threading
            from ..utils import UCircularIndex
            self._buf = np.empty((self.slots, self.slot_bytes), np.uint8)
            self._lens = np.zeros(self.slots, np.int64)
            self._head = UCircularIndex(0, self.slots)   # next pop slot
            self._tail = UCircularIndex(0, self.slots)   # next push slot
            self._count = 0
            self._cv = threading.Condition()
            self._closed = False

    def push(self, data: np.ndarray) -> bool:
        """Blocking push of a uint8 buffer; False if the ring is closed.
        The payload must fit the slot exactly — a silent truncation (or a
        stale slot tail) would hand the consumer a corrupted frame."""
        if data.dtype != np.uint8:
            raise TypeError(f"FrameRing carries uint8, got {data.dtype}")
        flat = data.reshape(-1)
        if flat.size != self.slot_bytes:
            raise ValueError(f"payload {flat.size} B != slot size "
                             f"{self.slot_bytes} B (geometry changed "
                             f"mid-stream?)")
        if self._native:
            return _lib.fp_ring_push(self._h, _u8p(flat), flat.nbytes) == 0
        n = min(flat.size, self.slot_bytes)
        with self._cv:
            while self._count == self.slots and not self._closed:
                self._cv.wait(0.1)
            if self._closed:
                return False
            self._buf[int(self._tail), :n] = flat[:n]
            self._lens[int(self._tail)] = n
            self._tail += 1
            self._count += 1
            self._cv.notify_all()
        return True

    def pop(self, out: np.ndarray, timeout_ms: int = 10000) -> int:
        """Blocking pop into ``out``; 0 = ok, -1 = closed+drained,
        -2 = timeout.  ``out`` must be C-contiguous — reshape(-1) of a
        non-contiguous view returns a copy and the frame would be silently
        discarded."""
        if not out.flags["C_CONTIGUOUS"]:
            raise ValueError("FrameRing.pop requires a C-contiguous buffer")
        if out.dtype != np.uint8:
            raise TypeError(f"FrameRing carries uint8, got {out.dtype}")
        flat = out.reshape(-1)
        if self._native:
            st = self._staging
            pooled = (self._threads > 1 and min(flat.nbytes, self.slot_bytes)
                      > st.POOL_ABOVE)
            rc = _lib.fp_ring_pop_pooled(self._h, _u8p(flat), flat.nbytes,
                                         timeout_ms, st.CHUNK_BYTES,
                                         self._threads if pooled else 1)
            if rc == 0:
                self.pops += 1
                self.pooled_pops += pooled
            return rc
        import time
        deadline = time.monotonic() + timeout_ms / 1000.0
        with self._cv:
            while self._count == 0:
                if self._closed:
                    return -1
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return -2
                self._cv.wait(min(remaining, 0.1))
            n = min(int(self._lens[int(self._head)]), flat.size)
            flat[:n] = self._buf[int(self._head), :n]
            self._head += 1
            self._count -= 1
            self._cv.notify_all()
        self.pops += 1
        return 0

    def close(self) -> None:
        if self._native:
            _lib.fp_ring_close(self._h)
        else:
            with self._cv:
                self._closed = True
                self._cv.notify_all()

    def __len__(self) -> int:
        if self._native:
            return int(_lib.fp_ring_size(self._h))
        with self._cv:
            return self._count

    def __del__(self):
        if getattr(self, "_native", False) and getattr(self, "_h", None):
            _lib.fp_ring_destroy(self._h)
            self._h = None
