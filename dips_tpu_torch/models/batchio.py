"""The batch I/O layer under both engines: what ``DiPsEngine`` and
``MultiStreamEngine`` do to every batch on the host, written once.

An engine builds one :class:`BatchIO` and owns it.  The layer keeps the
stage hook and the counters (``timers``; ``staging`` and ``downloads``
count while it is set), the upload buffers (page-locked on a card, each
with the event of its last upload, handed out in rotation), the batch's
one staging copy, its upload, the device side of its maps (crop and
interleave, or bit-pack) and its collect (the wait, the download and the
host unpack of packed masks).  A fleet's batch of twice
``staging.PIECE_BYTES`` or more is staged and uploaded in pieces
(:meth:`BatchIO.send`): each piece's upload is enqueued as soon as the
piece is staged and runs on the card while the host stages the next, and
the tails' slots are copied while the card works on the batch.  A fleet's
results carry a leading stream axis (S, n, ...); a single stream's are
the s = 1 case without it.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..ops import wire
from ..utils import profiling
from ..utils.downloads import Downloads
from ..utils.staging import Piece, Staging, upload_pieces


def interleave(out: torch.Tensor, n: int, s: int, h: int, w: int
               ) -> torch.Tensor:
    """The first ``n`` of the kernel's row-stacked planar maps (B, C,
    s*Hp, Wp) cropped to H x W and interleaved in one copy on their
    device: (s, n, H, W, C).  One strided view (stream j's rows start at
    row j*Hp) and one copy, the fewest host calls a batch."""
    sb, sc, sr, sx = out.stride()
    return out.as_strided((s, n, h, w, out.shape[1]),
                          (out.shape[2] // s * sr, sb, sr, sx, sc)
                          ).contiguous()


def unpack(packed: np.ndarray, n: int, s: int, h: int, w: int
           ) -> np.ndarray:
    """Downloaded bit-packed masks (n, 1, s*Hp/8, Wp) unpacked, cropped
    and interleaved on the host: (s, n, H, W, 1) uint8 {0, 255}."""
    hp, wp = 8 * packed.shape[-2] // s, packed.shape[-1]
    maps = wire.unpack_mask(packed).reshape(n, 1, s, hp, wp)[..., :h, :w]
    return np.ascontiguousarray(maps.transpose(2, 0, 3, 4, 1))


def capture_flags(row: np.ndarray, cursor: int, n: int, markers,
                  pending: bool) -> None:
    """One stream's capture flags for its ``n`` new frames, into ``row``:
    frame ``cursor + i`` captures the baseline when it is the stream's
    frame 0 or a refresh marker, the first when a snapshot is
    ``pending``."""
    for i in range(n):
        row[i] = cursor + i == 0 or cursor + i in markers
    if pending:
        row[0] = True


class BatchIO:
    """One engine's batch I/O on ``device``: maps cropped to ``height`` x
    ``width``, ``channels`` of them (0: stats only), bit-packed on the wire
    with ``packed_wire``; results with a stream axis of ``streams`` (None:
    a single stream, none); ``buffers`` upload buffers of ``shape``.  With
    ``twin`` a whole buffer goes up into a persistent device tensor (on
    the CPU the buffer is its own twin), else a row range into a fresh
    one."""

    def __init__(self, device: torch.device, height: int, width: int,
                 channels: int, packed_wire: bool, streams: Optional[int],
                 shape: tuple, buffers: int, twin: bool = False):
        self.device, self.height, self.width = device, height, width
        self.channels, self.packed_wire = channels, packed_wire
        self.streams = streams
        self.timers: Optional[profiling.StageTimers] = None
        self.staging = Staging()
        self.downloads = Downloads(device)
        on_card = device.type == "cuda"
        # zeros: a fleet's staging rows no batch wrote read as fresh zeros
        self._arrays = [torch.zeros(shape, dtype=torch.uint8,
                                    pin_memory=on_card).numpy()
                        for _ in range(buffers)]
        self._events = [torch.cuda.Event() for _ in
                        self._arrays] if on_card else []
        self._next = 0
        self._twin = (torch.empty(shape, dtype=torch.uint8, device=device)
                      if twin and on_card else None)

    @property
    def counting(self) -> bool:
        """The counters count while ``timers`` is set."""
        return self.timers is not None

    def stage(self, name: str):
        """The block as engine stage ``name`` (``profiling.stage``)."""
        return profiling.stage(self.timers, name)

    def buffer(self) -> np.ndarray:
        """The next upload buffer in rotation, once the upload last
        enqueued from it has completed."""
        k = self._next
        self._next = (k + 1) % len(self._arrays)
        if self._events:
            self._events[k].synchronize()
        return self._arrays[k]

    def copy(self, pieces: List[Piece]) -> None:
        """The batch's staging copy of (destination, source) pieces."""
        self.staging.copy(pieces, count=self.counting)

    def upload(self, buf: np.ndarray, lo: int = 0,
               hi: Optional[int] = None) -> torch.Tensor:
        """Rows ``[lo, hi)`` of ``buf`` on the device, enqueued without
        blocking in the ``h2d`` stage, as a batch that went up whole; a
        buffer of the layer's records its event."""
        with self.stage("h2d"):
            src = torch.from_numpy(buf[lo:hi])
            if self._twin is not None:
                src = self._twin.copy_(src, non_blocking=True)
            elif self.device.type == "cuda":
                src = src.to(self.device, non_blocking=True)
            self._record(buf, 1)
        return src

    @contextlib.contextmanager
    def send(self, buf: np.ndarray, rows: List[List[Piece]],
             after: List[Piece]) -> Iterator[torch.Tensor]:
        """The whole of ``buf`` staged and on the device, as :meth:`upload`
        gives it, for the body of the ``with``: ``rows[i]`` is the staging
        copy into row ``i``, ``after`` the host-only copies (the tails'
        slots).  In one piece (:func:`upload_pieces`) one ``stage_in``
        copies everything and one upload follows.  In pieces each piece is
        copied in a ``stage_in`` of its own and its upload enqueued in
        ``h2d`` before the next is copied, and ``after`` is copied once
        the body ends, by an exception too, so that the last upload and
        the work the body enqueues run behind it."""
        cuts = upload_pieces(len(rows), buf[0].nbytes)
        if len(cuts) == 1:
            pieces = [p for row in rows for p in row] + after
            if pieces:
                with self.stage("stage_in"):
                    self.copy(pieces)
            yield self.upload(buf)
            return
        try:
            for i, j in cuts:
                part = [p for row in rows[i:j] for p in row]
                if part:
                    with self.stage("stage_in"):
                        self.copy(part)
                with self.stage("h2d"):
                    self._put(buf, i, j)
            self._record(buf, len(cuts))
            yield (torch.from_numpy(buf) if self._twin is None
                   else self._twin)
        finally:
            with self.stage("stage_in"):
                self.copy(after)

    def _put(self, buf: np.ndarray, i: int, j: int) -> None:
        """Enqueue the upload of rows ``[i, j)`` of ``buf`` into the same
        rows of the device twin without blocking (on the CPU the buffer is
        its own twin)."""
        if self._twin is not None:
            self._twin[i:j].copy_(torch.from_numpy(buf[i:j]),
                                  non_blocking=True)

    def _record(self, buf: np.ndarray, uploads: int) -> None:
        """A batch sent from ``buf`` in ``uploads`` pieces, its last
        upload enqueued: a buffer of the layer's records its event, and
        the staging record counts the batch while counting."""
        for arr, ev in zip(self._arrays, self._events):
            if arr.ctypes.data == buf.ctypes.data:
                ev.record()
        if self.counting:
            self.staging.batches += 1
            self.staging.uploads += uploads

    def maps(self, out: torch.Tensor, n: int) -> torch.Tensor:
        """The first ``n`` of the kernel's maps (B, C, S*Hp, Wp) ready to
        come down: bit-packed (n, 1, S*Hp/8, Wp), or cropped and
        interleaved; without channels as they are."""
        if self.packed_wire:
            return wire.pack_mask(out[:n])
        if not self.channels:
            return out
        s = self.streams
        maps = interleave(out, n, s or 1, self.height, self.width)
        return maps[0] if s is None else maps

    def collect(self, maps: torch.Tensor, stats: torch.Tensor, n: int,
                packed: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """The ``wait`` stage (one stream sync), then the ``d2h`` stage:
        (maps, stats) in host memory the caller owns; the stats alone
        come down without channels, and packed masks are unpacked unless
        ``packed`` asks for them as they came down."""
        with self.stage("wait"):  # what the first download would wait for
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        s = self.streams
        with self.stage("d2h"):
            if not self.channels:
                stats_np, = self.downloads.fetch(stats, count=self.counting)
                lead = (n,) if s is None else (s, n)
                return (np.empty(lead + (self.height, self.width, 0),
                                 np.uint8), stats_np)
            maps_np, stats_np = self.downloads.fetch(maps, stats,
                                                     count=self.counting)
            if self.packed_wire and not packed:
                maps_np = unpack(maps_np, n, s or 1, self.height,
                                 self.width)
                maps_np = maps_np[0] if s is None else maps_np
        return maps_np, stats_np
