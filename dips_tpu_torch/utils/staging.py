"""A batch's frames staged on the host in one copy, into memory the engine
owns.

Both engines stage each batch through a :class:`Staging`: the frames into
the engine's upload buffer (page-locked on a card) and the tail's newest
frames into the engine's :class:`TailSlots`, as one list of (destination,
source) pieces.  A call of more than :data:`POOL_ABOVE` bytes copies on the
native module's pool of host threads (``native.copy_pieces``: the pieces
cut into chunks of :data:`CHUNK_BYTES`, min(8, usable CPUs) threads, the
GIL released).  A smaller call, a process with one usable CPU, or one
without the native module copies through NumPy on the calling thread: a
single small frame does not repay the handoff to the pool.  Either way
the destinations hold the same bytes.  A source that is not C-contiguous
uint8, or that may share memory with its destination, is always copied by
NumPy, with NumPy's casting (as ``buf[i] = frame`` does).

A fleet's batch of twice :data:`PIECE_BYTES` or more goes up in pieces
(:func:`upload_pieces`): runs of consecutive rows of the upload buffer, each
staged by its own call and enqueued for upload before the next is staged,
so that the card's copy of one piece runs while the host stages the next.

A staging call is counted only when the caller asks (the engines ask while
their stage timers are on, as under ``--profile``), as ``Downloads``
counts: ``calls``, ``nbytes``, ``pooled`` (the calls the pool copied) and
``threads`` (the copiers of the last counted call).  The engines' batch
I/O layer counts ``batches`` and ``uploads`` (the upload pieces of those
batches; ``pieces`` a batch) beside them, and the run path
(``app.stream_dips``) ``pops`` and ``pooled_pops``: the frames it popped
from its decode rings straight into the upload buffer, and those of them
the pool copied (``native.FrameRing`` pools a pop by the same
:data:`POOL_ABOVE`).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import native

#: bytes of a staging call above which the thread pool copies it: on the
#: 8-core host of an H100 the pool's handoff costs about 0.3 ms, and the
#: pool first beats one thread's copy between 11 and 16 MB (PERF.md §6)
POOL_ABOVE = 16 << 20
#: bytes of one piece of work on the pool (1 MB chunks beat 2 and 4 MB on
#: a 1080p x 16 batch there)
CHUNK_BYTES = 1 << 20
#: bytes of one upload piece at least: a fleet's batch of twice this or
#: more is staged and uploaded in pieces (:func:`upload_pieces`), a smaller
#: one in one staging copy and one upload.  On an H100's host the 1080p
#: 8 x 16 fleet ran fastest in 4 pieces of 2 streams (PERF.md §6)
PIECE_BYTES = 96 << 20
#: the engine stages that staging copies run in
STAGING_STAGES = ("stage_in", "tail_keep")

Piece = Tuple[np.ndarray, np.ndarray]


def pool_threads() -> int:
    """Copiers of the pool: min(8, the CPUs this process may run on)."""
    return min(8, len(os.sched_getaffinity(0)))


def upload_pieces(rows: int, row_bytes: int) -> List[Tuple[int, int]]:
    """``rows`` rows of ``row_bytes`` bytes each cut into pieces of
    consecutive rows, as [start, stop) in order: as many pieces as hold
    :data:`PIECE_BYTES` each, the rows spread over them as evenly as they
    go (one piece below twice :data:`PIECE_BYTES`)."""
    per = max(1, -(-PIECE_BYTES // row_bytes))  # rows a piece needs
    m = max(1, rows // per)
    size, extra = divmod(rows, m)
    cuts, lo = [], 0
    for k in range(m):
        hi = lo + size + (k < extra)
        cuts.append((lo, hi))
        lo = hi
    return cuts


def _addresses(arrays: Sequence[np.ndarray]) -> np.ndarray:
    return np.fromiter((a.__array_interface__["data"][0] for a in arrays),
                       np.uintp, len(arrays))


class Staging:
    """One engine's host staging copies, with four counts of those made
    with ``count``: ``calls``, ``nbytes``, ``pooled`` and ``threads``; the
    engine's batches and their upload pieces, ``batches`` and
    ``uploads``, which the engine counts; and the run path's ring pops
    into the upload buffer, ``pops`` and ``pooled_pops``, which it
    counts."""

    def __init__(self) -> None:
        self.batches = 0
        self.calls = 0
        self.nbytes = 0
        self.pooled = 0
        self.threads = 1
        self.uploads = 0
        self.pops = 0
        self.pooled_pops = 0

    @property
    def pooled_share(self) -> Optional[float]:
        """The share of the counted calls the pool copied; None before
        the first."""
        return self.pooled / self.calls if self.calls else None

    @property
    def pieces(self) -> Optional[float]:
        """The upload pieces a counted batch (1.0: every batch went up
        whole); None before the first."""
        return self.uploads / self.batches if self.batches else None

    def gbps(self, timers) -> Optional[float]:
        """Staged GB/s: ``nbytes`` over the time ``timers`` (the engine's
        ``StageTimers``) hold in the stages the copies run in
        (:data:`STAGING_STAGES`; in the planar layout ``stage_in`` also
        holds the frames' planarization)."""
        if timers is None:
            return None
        s = sum(timers.totals.get(name, 0.0) for name in STAGING_STAGES)
        return self.nbytes / s / 1e9 if s > 0 else None

    def copy(self, pieces: Sequence[Piece], count: bool = False) -> bool:
        """Copy each source into its destination (a writable C-contiguous
        uint8 array of the source's shape); returns whether the pool
        copied.  With ``count`` the call is counted."""
        fast: List[Piece] = []
        nbytes = total = 0
        for dst, src in pieces:
            if dst.shape != np.shape(src):
                raise ValueError(f"staging: source {np.shape(src)} into "
                                 f"destination {dst.shape}")
            if (dst.dtype != np.uint8 or not dst.flags.c_contiguous
                    or not dst.flags.writeable):
                raise ValueError("staging: the destination must be a "
                                 "writable C-contiguous uint8 array")
            nbytes += dst.nbytes
            if (isinstance(src, np.ndarray) and src.dtype == np.uint8
                    and src.flags.c_contiguous
                    and not np.may_share_memory(dst, src)):
                fast.append((dst, src))
                total += dst.nbytes
            else:
                dst[...] = src
        threads = pool_threads() if fast and total > POOL_ABOVE else 1
        pooled = native.NATIVE_AVAILABLE and threads > 1
        if pooled:
            threads = native.copy_pieces(
                _addresses([d for d, _ in fast]),
                _addresses([s for _, s in fast]),
                np.fromiter((d.nbytes for d, _ in fast), np.int64,
                            len(fast)),
                CHUNK_BYTES, threads)
        else:
            threads = 1
            for dst, src in fast:
                dst[...] = src
        if count:
            self.calls += 1
            self.nbytes += nbytes
            self.pooled += pooled
            self.threads = threads
        return pooled

    def __str__(self) -> str:
        share, pieces = self.pooled_share, self.pieces
        return (f"staging: {self.batches} batches, {self.nbytes} bytes, "
                f"pooled share {0.0 if share is None else share:.3f}, "
                f"{self.threads} thread(s), "
                f"{0.0 if pieces is None else pieces:.3f} upload pieces "
                f"a batch")


class TailSlots:
    """T host frames, allocated at first use and reused, that hold a
    stream's tail: the last T frames it was fed.

    A tail is a list of T arrays, oldest first, each a slot or (after a
    checkpoint of another frame shape was loaded) a frame of its own.
    :meth:`keep` gives each newly kept frame the next slot in ring order,
    so a batch overwrites the slots its dropped frames held, never one a
    kept frame holds: a tail's slots are the most recently written ones,
    its newest k frames hold at most k of them, and a batch that adds j <=
    T frames writes the j slots after the newest.  The copies into the
    slots are the caller's to make (with the batch's staging copy) before
    anything reads the tail.  Nothing outside reads a slot: a checkpoint
    stacks the tail into an array of its own.
    """

    def __init__(self, t: int):
        self.t = int(t)
        self._slots: Optional[np.ndarray] = None
        self._next = 0

    def _take(self, like: np.ndarray) -> np.ndarray:
        """The next slot, for a frame of ``like``'s shape: a new set of
        slots when the shape differs from the slots' (a checkpoint's
        planar tail on an engine fed (H, W, 3) frames, or the frames
        after it); the old set lives on in the frames that view it."""
        shape = np.shape(like)
        if self._slots is None or self._slots.shape[1:] != shape:
            self._slots = np.empty((self.t,) + shape, np.uint8)
            self._next = 0
        slot = self._slots[self._next]
        self._next = (self._next + 1) % self.t
        return slot

    def keep(self, tail: Optional[Sequence[np.ndarray]],
             frames: Sequence[np.ndarray]) -> Tuple[list, List[Piece]]:
        """(the tail after ``frames``, the (slot, frame) copies that make
        it): the last T of ``tail`` followed by ``frames``; a first batch
        (``tail`` None) starts from T copies of ``frames[0]``.  A frame
        given twice (the same array) takes one slot."""
        t = self.t
        frames = list(frames)
        if tail is None:
            tail, frames = [], [frames[0]] * t + frames
        slot_of, copies, new = {}, [], []
        for f in frames[-t:]:
            slot = slot_of.get(id(f))
            if slot is None:
                slot = slot_of[id(f)] = self._take(f)
                copies.append((slot, f))
            new.append(slot)
        return (list(tail) + new)[-t:], copies

    def load(self, frames: Sequence[np.ndarray]) -> list:
        """A checkpoint's tail (T frames, oldest first) copied into the
        slots: the tail to hold."""
        tail, copies = self.keep([], frames)
        for slot, f in copies:
            slot[...] = f
        return tail
