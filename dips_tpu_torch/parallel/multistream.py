"""MultiStreamEngine: a fleet of video streams through one stacked launch.

Counterpart of ``dips_tpu/parallel/multistream.py``, on either of the JAX
engine's protocols.  Without a mesh all S streams fold along the row axis
of ONE launch of a stacked kernel per batch:

* ring-carry (``ring_carry=True``, the default; the JAX engine builds
  ``make_sharded_ring_step`` for it): ``ops/cuda_fused.
  absdiff_step_ring_stacked`` / ``batch_step_ring_stacked``, with the
  filtered ring and prev carried per stream;
* tail (``ring_carry=False``, the JAX engine's ``make_sharded_step``):
  ``ops/cuda_fused.absdiff_step_stacked`` / ``batch_step_stacked`` over
  (T+B, 3, S*Hp, Wp), each stream's raw tail in rows [0, T).

With a mesh (``mesh.py``) the fleet is split over its cells and each cell
is one launch per batch: a 1-D stream mesh (:func:`stream_mesh`) gives
each cell a subset of the streams at full height; a 2-D (stream, rows) grid
(``grid2d.grid_mesh``) gives each cell a horizontal slab of a subset of the
streams and runs the slab kernels of ``grid2d.py`` (``slab_impl``: "bands"
or "extended").  The kernels need 8-row-aligned slabs: a grid on a card
whose slabs are not raises, and a grid of CPU cells runs the plain twins at
that slab height, in the tail protocol.  Outputs, statistics and
checkpoints do not depend on the mesh.

The engine owns its state row-stacked, in the kernels' own layout: ring
(T, S*Hp, Wp), prev / baseline (3 or 1, S*Hp, Wp), heatmap (S*Hp, Wp);
stream ``si`` owns rows [si*Hp, (si+1)*Hp), in the mesh's cells
(``mesh.Layout``).  It owns the per-stream cursors, tails and failure
isolation, the zeroing of stale staging rows, the grid launches, the
global mean and the multi-process hooks.  A batch's frames are staged
into one (S, B, H, W, 3) upload buffer (planarized into (S, T_rows + B,
3, Hp, Wp) on the host in the planar layout) that goes up into a device
twin, whole or, for a large batch, in pieces of whole stream rows, each
as soon as it is staged (``BatchIO.send``); the layout prep writes them
into the row-stacked input seen as (F, 3, S, Hp, Wp).  Staging, upload,
crop and interleave, wait and download go through ``models/batchio.py``,
as the single-stream engine's do.  A stream not staged in a batch (idle,
exhausted or failed) is fed zeros, in its frame rows and, in the tail
protocol, in its tail rows, as the JAX engine stages it; its tail goes
back up when it is staged again.

Checkpoints are byte-compatible with the JAX engine's in both directions
and both protocols: the fleet's ``save`` / ``load``, and one slot's
``save_stream`` / ``load_stream`` in ``DiPsEngine``'s format
(``models/pipeline.py``'s one-stream checkpoint), so a slot moves to and
from a single-stream engine of either package.  After a load the ring
engine rebuilds its ring from the raw planar tails with one stacked
launch (one per cell on a mesh).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..errors import StreamError
from ..models.batchio import BatchIO, capture_flags
from ..models.pipeline import (EngineBase, load_slot, save_slot,
                               slot_baseline, slot_tail)
from ..ops.reference import NUM_STATS
from ..properties import DiPsProperties
from ..utils.staging import Piece, TailSlots
from .grid2d import (make_grid_ring_step, make_grid_step,
                     run_grid_ring_step, run_grid_step, slab_rows_ok)
from .mesh import Layout, Mesh, visible_devices

def stream_mesh(n_devices: Optional[int] = None,
                devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over the stream axis: the visible cards (the first
    ``n_devices`` of them), or ``devices`` as given (which may name one
    device several times)."""
    if devices is None:
        devices = visible_devices()
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(
                    f"stream_mesh: {n_devices} devices requested, only "
                    f"{len(devices)} available")
            devices = devices[:n_devices]
    return Mesh(list(devices), ("stream",))


def _check_stream_mesh(mesh: Mesh) -> None:
    if mesh.axis_names != ("stream",):
        raise ValueError(
            f"a sharded step runs on a ('stream',) mesh (stream_mesh), got "
            f"axes {mesh.axis_names}; a (stream, rows) grid runs "
            f"grid2d.make_grid_step / make_grid_ring_step")


def make_sharded_step(props: DiPsProperties, h: int, w: int, mesh: Mesh,
                      backend: Optional[str] = None):
    """A multi-stream step over the cells of a 1-D stream mesh
    (:func:`stream_mesh`), tail protocol, with the JAX function's call
    signature.

    The returned function maps raw u8 (S, T+B, 3, Hp, Wp), baseline (S,
    Hp, Wp) f32 (median modes) or (S, 3, Hp, Wp) u8 (raw modes), flags (S,
    B), heatmap (S, Hp, Wp), valid (S, B) -> (out (S, B, C, Hp, Wp) u8,
    stats (S, B, 4) f32, baseline, heatmap, global mean |diff| over the
    valid slots).  Each cell runs one stacked launch over its S / cells
    streams.  Where the JAX step donates baseline and heatmap, this one
    updates them in place and returns them.

    ``backend``: "kernel" (the default; None means the same) = the stacked
    CUDA kernels on a card, their plain twins on CPU cells; "plain" = the
    plain twins, for CPU tensors only.  The JAX package's "pallas" /
    "xla" / "auto" raise ``ValueError``.  A 1-D mesh is a grid with one
    row cell, so this is ``grid2d.make_grid_step`` on it."""
    _check_stream_mesh(mesh)
    backend = "kernel" if backend is None else backend
    if backend not in ("kernel", "plain"):
        raise ValueError(f"unknown backend {backend!r}: the port's are "
                         f"'kernel' and 'plain' (None means 'kernel')")
    return make_grid_step(props, h, w, mesh, backend=backend)


def make_sharded_ring_step(props: DiPsProperties, h: int, w: int,
                           mesh: Mesh):
    """Ring-carry twin of :func:`make_sharded_step`: the carried state
    (filtered ring / previous frame, baseline, heatmap) comes in per
    stream, the input is only the B new frames per stream.

    Median modes map raw u8 (S, B, 3, Hp, Wp), ring f32 (S, T, Hp, Wp),
    prev / baseline / heatmap f32 (S, Hp, Wp), flags / valid (S, B),
    offsets / seeds (S,) -> (out, stats, ring, prev, baseline, heatmap,
    global mean |diff|).  Raw modes carry prev and baseline as u8 (S, 3,
    Hp, Wp) and have no ring or offsets: (raw, prev, baseline, flags,
    heatmap, valid, seeds) -> (out, stats, prev, baseline, heatmap, global
    mean).  Where the JAX step donates the state, this one updates the
    state arguments in place and returns them.  The stacked ring kernels
    on a card, their plain twins on CPU cells (``grid2d.
    make_grid_ring_step`` on a grid with one row cell)."""
    _check_stream_mesh(mesh)
    return make_grid_ring_step(props, h, w, mesh)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy that never aliases engine state (also on the CPU)."""
    return t.detach().to("cpu", copy=True).numpy()


def npz_state(z) -> dict:
    """The fleet ``state_dict`` held by an open fleet .npz."""
    tails = z["tails"]
    return {
        "frame_cursors": z["frame_cursors"].tolist(),
        "baseline": z["baseline"],
        "heatmap": z["heatmap"],
        "tails": [tl if has else None
                  for tl, has in zip(tails, z["has_tail"])],
        "failed": z["failed"].tolist(),
    }


class MultiStreamEngine(EngineBase):
    """Batch runner over S parallel streams with per-stream failure
    isolation; feed one frame list per stream.

    Args:
      props: pipeline configuration, shared by every stream.
      height, width: true input frame geometry, shared by every stream
        (``.in_height`` / ``.in_width``; ``.height`` / ``.width`` are the
        analysis geometry, 1/k of it under ``downscale`` = k).
      n_streams: S.
      batch: frames per stream per launch (B).
      device: "cuda" (the default; None means the same), "cuda:N" or
        "cpu".  Without a card "cuda" raises :class:`DeviceError`; on the
        CPU the kernels' plain PyTorch twins run.
      input_layout: "hwc" (RGB frames), "hwc_bgr" (cv2's BGR order,
        swapped on the device in the same copy) or "planar" (RGB frames
        planarized on the host, the JAX engine's default).
      mesh: None (one launch over all streams on ``device``), a 1-D
        stream mesh or a 2-D (stream, rows) grid; ``n_streams`` must be a
        multiple of its stream axis and its rows axis must divide the
        padded height.  ``device`` stays the device that takes the upload
        and gathers the outputs.
      ring_carry: True for the ring-carry protocol, False for the tail
        protocol; both give the same outputs for every staged stream.
        None (the default) means True, except on a CPU grid whose slabs
        are not 8-row aligned, which runs only the tail protocol (True
        raises there).  On a card such a grid raises ``ValueError``: the
        slab kernels need aligned slabs and nothing there runs the plain
        version.
      packed_wire: THRESHOLD only: the masks are bit-packed on the device
        before the download and unpacked on the host.
      downscale: k >= 1, each stream's k x k box mean on the device (a hwc
        layout; "planar" becomes "hwc").
      slab_impl: "bands" (default) or "extended": how a 2-D grid's slab
        kernels get their neighbour rows (``grid2d.make_grid_ring_step``);
        validated on every mesh, used only by a grid's median modes.

    ``timers``, ``staging`` and ``downloads`` are the single-stream
    engine's (``models/batchio.py``).  The stages are its own but
    ``tail_keep``: ``stage_in`` (in the planar layout one per staged
    stream, which planarizes its frames; then one with the zeroing of a
    quiet stream's stale rows and the staging copy), ``h2d``,
    ``dispatch``, ``wait`` and ``d2h`` (maps and stats; the global mean
    follows).  A batch in pieces has a ``stage_in`` and an ``h2d`` a
    piece, and a last ``stage_in``, the tails' slots, after ``dispatch``.
    Each stream's host tail lives in T slots of its own that the engine
    reuses.
    """

    #: the multi-process engine (``multihost.py``) sets this: every process
    #: must enter the global-mean all-reduce of every ``process_batch`` and
    #: the same launches, so the "nothing to do here" shortcuts (an
    #: all-empty round, no tail to rebuild) are taken only when it is False
    _lockstep_collectives = False

    def __init__(self, props: DiPsProperties, height: int, width: int,
                 n_streams: int, batch: int = 8, device="cuda",
                 input_layout: str = "hwc",
                 ring_carry: Optional[bool] = None,
                 packed_wire: bool = False, downscale: int = 1,
                 slab_impl: str = "bands", mesh: Optional[Mesh] = None):
        if slab_impl not in ("bands", "extended"):
            raise ValueError(f"unknown slab_impl {slab_impl!r}")
        if n_streams < 1:
            raise ValueError("n_streams must be >= 1")
        super().__init__(props, height, width, batch, device, input_layout,
                         packed_wire, downscale)
        self.n_streams = int(n_streams)
        self._tail_slots = [TailSlots(props.temporal_size)
                            for _ in range(self.n_streams)]
        self.mesh, self.slab_impl = mesh, slab_impl
        self._layout = Layout(mesh, self._stage_rows(), self.hp, self.wp,
                              device=self.device)
        #: the cells' body: the (slab) kernels, or, for CPU cells whose
        #: slabs are not 8-row aligned, their plain twins at that height
        self.backend = "kernel"
        if mesh is not None and "rows" in mesh.axis_names \
                and not slab_rows_ok(self.hp, mesh.shape["rows"]):
            if any(d.type != "cpu" for d in mesh.devices.ravel()):
                raise ValueError(
                    "a 2-D mesh on a card needs 8-row-aligned slabs (the "
                    f"slab kernels): padded height {self.hp} / "
                    f"{mesh.shape['rows']} row shards = "
                    f"{self.hp / mesh.shape['rows']} rows")
            self.backend = "plain"
        if ring_carry is None:
            ring_carry = self.backend == "kernel"
        if ring_carry and self.backend != "kernel":
            raise ValueError(
                "ring_carry on a 2-D mesh requires the slab kernels "
                f"(8-row-aligned slabs): padded height {self.hp} / "
                f"{mesh.shape['rows']} row shards")
        self.ring_carry = bool(ring_carry)
        s = self._stage_rows()
        # one persistent upload buffer (planar: the tail rows staged on the
        # host too): the rows a batch does not write are re-zeroed
        # (``_stage_written``), so they stage fresh zeros
        self._io = BatchIO(self.device, self.height, self.width,
                           props.out_channels, self.packed_wire, s,
                           (s,) + self._buffer_shape, 1, twin=True)
        self._stage_written: set = set()
        self._planar = self._planar_input(s)
        #: the cells' slabs of the input (the input itself without a mesh)
        self._raw_cells = self._layout.scatter(self._planar)
        #: streams whose tail rows of ``_planar`` hold their tail; every
        #: other stream's tail rows are zero
        self._tail_live: set = set()
        self.reset()

    # -- the streams staged here --------------------------------------------
    # The multi-process engine (``multihost.py``) overrides these three: its
    # device state and staging hold only this process's streams.  Host
    # bookkeeping (cursors, tails, failures) stays indexed by stream.
    def _stage_rows(self) -> int:
        """Streams whose state lives here: the row sections of the
        row-stacked input and state."""
        return self.n_streams

    def _stage_index(self, si: int) -> int:
        """Row section of stream ``si``; -1: not staged here."""
        return si

    def _stage_gather(self, seq) -> np.ndarray:
        """Per-stream host values -> row-section order."""
        return np.asarray(seq)

    def _global_sums(self, total: torch.Tensor, count: torch.Tensor):
        """The valid-weighted sum of mean |diff| and the valid count over
        every process (here: this one's)."""
        return total, count

    # -- state ------------------------------------------------------------
    def _rows(self, row: int) -> slice:
        """Row section ``row`` of the row-stacked input."""
        return slice(row * self.hp, (row + 1) * self.hp)

    def _state(self) -> dict:
        """The carried state, each entry the cells of a row-stacked
        tensor (or None)."""
        return dict(ring=self._ring, prev=self._prev,
                    baseline=self._baseline, heatmap=self._heatmap)

    def _zero_carry(self) -> None:
        """Fresh ring (median modes) and prev of the ring protocol."""
        zeros = self._layout.zeros
        self._ring = self._prev = None
        if not self.ring_carry:
            return
        if self._raw_mode:
            self._prev = zeros((3,), torch.uint8)
        else:
            self._ring = zeros((self.props.temporal_size,), torch.float32)
            self._prev = zeros((), torch.float32)

    def reset(self) -> None:
        """Clear every stream's state (cursors, tails, ring, baseline,
        heatmap, failures)."""
        s = self.n_streams
        self.frame_cursors: List[int] = [0] * s
        # entries, in the stream's ``_tail_slots``: (H, W, 3) frames in the
        # input layout, or planar (3, Hp, Wp) frames; planarized on demand
        self._tails: List[Optional[list]] = [None] * s
        if self._raw_mode:
            self._baseline = self._layout.zeros((3,), torch.uint8)
        else:
            self._baseline = self._layout.zeros((), torch.float32)
        self._heatmap = self._layout.zeros((), torch.float32)
        self._zero_carry()
        self._drop_tails(range(self._stage_rows()))
        self._ring_offs = [0] * s
        self._snap_pending = [False] * s
        self.failed: Dict[int, StreamError] = {}

    def snapshot(self, stream: Optional[int] = None) -> None:
        """Force a baseline re-capture on the next processed frame of one
        stream, or of every stream."""
        if stream is None:
            self._snap_pending = [True] * self.n_streams
        else:
            self._snap_pending[stream] = True

    @property
    def frame_index(self) -> int:
        """Furthest per-stream cursor (streams advance independently)."""
        return max(self.frame_cursors, default=0)

    def revive(self, stream: int) -> None:
        """Clear a stream's failure; it continues from its old state
        (cursor, baseline and ring are kept)."""
        self.failed.pop(stream, None)

    def reset_stream(self, stream: int) -> None:
        """Clear a stream's failure and restart it fresh: cursor 0 (its next
        frame captures the baseline), no tail, and its rows of the baseline,
        heatmap, ring and prev zeroed.  The other streams are untouched."""
        self.failed.pop(stream, None)
        self.frame_cursors[stream] = 0
        self._snap_pending[stream] = False
        self._tails[stream] = None
        self._ring_offs[stream] = 0
        for cells in self._state().values():
            if cells is not None:
                for slab in self._layout.stream_views(cells, stream):
                    slab.zero_()
        self._drop_tails([stream])

    def _drop_tails(self, rows) -> None:
        """Zero the tail rows of row sections ``rows`` in the planar input
        (tail protocol); their tails go back up from the host bookkeeping
        when they are staged again."""
        for row in set(rows) & self._tail_live:
            self._planar[:self._tail_len, :, self._rows(row)] = 0
            self._tail_live.discard(row)

    def heatmaps(self) -> np.ndarray:
        """(S, H, W) accumulated |diff| heatmaps, cropped."""
        hm = self._layout.gather(self._heatmap, self.device).view(
            self._stage_rows(), self.hp, self.wp)
        return _to_host(hm[:, :self.height, :self.width])

    def _planar_tail(self, stream: int) -> Optional[np.ndarray]:
        """Stream ``stream``'s tail as planar RGB (T, 3, Hp, Wp) u8."""
        return self._planar_stack(self._tails[stream])

    # -- checkpoint / resume ----------------------------------------------
    def _per_stream(self, cells: list) -> np.ndarray:
        """The cells of row-stacked state (3, S*Hp, Wp) or (S*Hp, Wp) ->
        the JAX engine's per-stream (S, 3, Hp, Wp) or (S, Hp, Wp), on the
        host."""
        s, hp, wp = self._stage_rows(), self.hp, self.wp
        x = self._layout.gather(cells, self.device)
        if x.dim() == 3:
            x = x.view(3, s, hp, wp).permute(1, 0, 2, 3)
        else:
            x = x.view(s, hp, wp)
        return np.ascontiguousarray(_to_host(x))

    def _from_per_stream(self, a: np.ndarray) -> list:
        """The inverse of :meth:`_per_stream`: the cells of a row-stacked
        copy."""
        t = torch.from_numpy(np.array(a))  # a private copy
        if t.dim() == 4:
            t = t.permute(1, 0, 2, 3)
        rows = (self._stage_rows() * self.hp, self.wp)
        return self._layout.scatter(
            t.reshape(t.shape[:-3] + rows).to(self.device))

    def state_dict(self) -> dict:
        """Fleet state in the JAX engine's format: per-stream cursors,
        baseline (S, [3,] Hp, Wp), heatmap (S, Hp, Wp), planar tails and
        the failed streams."""
        return {
            "frame_cursors": list(self.frame_cursors),
            "baseline": self._per_stream(self._baseline),
            "heatmap": self._per_stream(self._heatmap),
            "tails": [self._planar_tail(si) for si in range(self.n_streams)],
            "failed": sorted(self.failed),
        }

    def load_state_dict(self, state: dict) -> None:
        s, hp, wp = self.n_streams, self.hp, self.wp
        bl = np.asarray(state["baseline"])
        expect = (s, 3, hp, wp) if self._raw_mode else (s, hp, wp)
        if bl.shape != expect:
            raise ValueError(f"checkpoint baseline shape {bl.shape} != "
                             f"engine's expected {expect}")
        if len(state["frame_cursors"]) != s:
            raise ValueError("checkpoint stream count mismatch")
        hm = np.asarray(state["heatmap"], np.float32)
        if hm.shape != (s, hp, wp):
            raise ValueError(f"checkpoint heatmap shape {hm.shape} != "
                             f"{(s, hp, wp)}")
        self.frame_cursors = [int(c) for c in state["frame_cursors"]]
        dtype = np.uint8 if self._raw_mode else np.float32
        self._baseline = self._from_per_stream(bl.astype(dtype))
        self._heatmap = self._from_per_stream(hm)
        self._tails = [self._slot_tail(si, tl)
                       for si, tl in enumerate(state["tails"])]
        self.failed = {
            int(si): StreamError(int(si),
                                 RuntimeError("restored from checkpoint"))
            for si in state.get("failed", ())}
        # a snapshot requested before the restore must not fire after it
        self._snap_pending = [False] * s
        self._drop_tails(range(s))
        self._rebuild_ring_state()

    def _rebuild_ring_state(self) -> None:
        """Rebuild the carried ring / prev of every stream from its raw
        tail: one stacked launch (one per cell on a mesh) over the T tail
        frames with inert capture flags, valid and seed 1 for each stream
        that has a tail, and a scratch heatmap; outputs are discarded.
        Streams without a tail keep zero state and seed on their first
        frame.  The tail protocol has no ring: nothing to do."""
        sh, t, hp = self._stage_rows(), self.props.temporal_size, self.hp
        self._ring_offs = [0] * self.n_streams
        self._zero_carry()
        if not self.ring_carry:
            return
        has = np.asarray([tl is not None for tl in self._tails])
        if not has.any() and not self._lockstep_collectives:
            return
        tail = np.zeros((t, 3, sh * hp, self.wp), np.uint8)
        for si in np.flatnonzero(has):
            tail[:, :, self._rows(self._stage_index(si))] = \
                self._planar_tail(si)
        raw = self._layout.scatter(torch.from_numpy(tail).to(self.device))
        has = self._stage_gather(has)
        flags = np.zeros((sh, t), np.bool_)
        valid = np.repeat(has[:, None], t, axis=1)
        seeds = has.astype(np.int32)
        state = dict(self._state(),
                     heatmap=self._layout.zeros((), torch.float32))
        run_grid_ring_step(self.props, self.height, self.width,
                           self._layout, raw, state, flags, valid,
                           np.zeros((sh,), np.int32), seeds, self.slab_impl,
                           self.device)

    # -- per-stream checkpoints (DiPsEngine's format) -----------------------
    def stream_state_dict(self, stream: int) -> dict:
        """One slot's state in ``DiPsEngine.state_dict`` form."""
        return {
            "frame_index": self.frame_cursors[stream],
            "baseline": _to_host(self._stream_rows(self._baseline, stream)),
            "heatmap": _to_host(self._stream_rows(self._heatmap, stream)),
            "tail": self._planar_tail(stream),
        }

    def _stream_rows(self, cells: list, stream: int) -> torch.Tensor:
        """One stream's full-height rows of row-stacked state, on
        ``device``."""
        return torch.cat([slab.to(self.device) for slab in
                          self._layout.stream_views(cells, stream)], dim=-2)

    def _set_stream_rows(self, cells: list, stream: int,
                         value: np.ndarray) -> None:
        value = torch.from_numpy(value)
        hs = self._layout.hs
        for j, slab in enumerate(self._layout.stream_views(cells, stream)):
            slab.copy_(value[..., j * hs:(j + 1) * hs, :])

    def _slot_tail(self, stream: int, tail) -> Optional[list]:
        """A checkpoint's tail for stream ``stream`` in its slots
        (``pipeline.slot_tail``; an empty tail list raises)."""
        return slot_tail(self._tail_slots[stream], tail, self.hp, self.wp,
                         empty_ok=False)

    def load_stream_state(self, stream: int, state: dict) -> None:
        """Restore one slot from a ``DiPsEngine``-format state dict; the
        other slots keep their state (their ring is rebuilt bit-exactly
        from the raw tails the engine carries)."""
        bl = slot_baseline(state["baseline"], self._raw_mode, self.hp,
                           self.wp)
        self._tails[stream] = self._slot_tail(stream, state.get("tail"))
        self.failed.pop(stream, None)
        self._snap_pending[stream] = False
        self.frame_cursors[stream] = int(state["frame_index"])
        self._set_stream_rows(self._baseline, stream, bl)
        hm = state.get("heatmap")
        if hm is not None:
            self._set_stream_rows(self._heatmap, stream,
                                  np.array(hm, np.float32))
        self._drop_tails([stream])
        self._rebuild_ring_state()

    def save_stream(self, stream: int, path: str) -> None:
        """Checkpoint one slot (``DiPsEngine.save``'s npz keys)."""
        save_slot(path, self.stream_state_dict(stream), self.height,
                  self.width)

    def load_stream(self, stream: int, path: str) -> None:
        self.load_stream_state(stream, load_slot(path, self.height,
                                                 self.width))

    def save(self, path: str) -> None:
        """Persist the fleet (the JAX engine's .npz format)."""
        self._save_npz(path, self.state_dict())

    def _save_npz(self, path: str, st: dict, **first) -> None:
        """A fleet ``state_dict`` as the .npz, after the arrays ``first``;
        a stream without a tail saves zeros and ``has_tail`` False."""
        t = self.props.temporal_size
        tails = np.stack([
            tl if tl is not None
            else np.zeros((t, 3, self.hp, self.wp), np.uint8)
            for tl in st["tails"]])
        has_tail = np.asarray([tl is not None for tl in st["tails"]])
        np.savez_compressed(
            path, **first, frame_cursors=np.asarray(st["frame_cursors"]),
            baseline=st["baseline"], heatmap=st["heatmap"], tails=tails,
            has_tail=has_tail, failed=np.asarray(st["failed"], np.int64))

    def load(self, path: str) -> None:
        with np.load(path) as z:
            self.load_state_dict(npz_state(z))

    # -- the batch ----------------------------------------------------------
    def process_batch(self, frames_per_stream: Sequence[Sequence[np.ndarray]]
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Process up to ``batch`` (H, W, 3) uint8 frames for each of the S
        streams.

        Streams may pass different counts (an exhausted or dead stream
        passes an empty list); n is the largest.  Returns (out uint8
        (S, n, H, W, C), stats float32 (S, n, 4), the mean |diff| over the
        valid slots).  A stream given a frame of the wrong shape is
        isolated into ``failed`` (a :class:`StreamError`); the others run.
        """
        t, b, s = self.props.temporal_size, self.batch, self._stage_rows()
        if len(frames_per_stream) != self.n_streams:
            raise ValueError(f"expected {self.n_streams} streams")
        n = max((len(f) for f in frames_per_stream), default=0)
        if n == 0 and not self._lockstep_collectives:
            return (np.zeros((s, 0, self.height, self.width,
                              self.props.out_channels), np.uint8),
                    np.zeros((s, 0, NUM_STATS), np.float32), 0.0)
        if n > b:
            raise ValueError(f"{n} frames > batch {b}")
        buf = self._io.buffer()
        planar = self._prep is None
        tr = self._tail_len
        shape = (self.in_height, self.in_width, 3)
        flags = np.zeros((s, b), np.bool_)
        valid = np.zeros((s, b), np.bool_)
        seeds = np.zeros((s,), np.int32)
        offsets = self._stage_gather(self._ring_offs).astype(np.int32)
        written: Dict[int, int] = {}  # row section -> frames staged
        # tail protocol: row sections whose tail rows must be filled before
        # the launch, from frame 0 (a fresh stream) or from the host tail
        fresh, resumed = [], {}
        # the batch's staging copy, (destination, source): each row
        # section's frames, then the tails' slots
        rows: List[List[Piece]] = [[] for _ in range(s)]
        tail_copies: List[Piece] = []
        for si, frames in enumerate(frames_per_stream):
            row = self._stage_index(si)
            if row < 0 or si in self.failed:
                continue  # another process's or a dead stream: not staged
            bad = [np.shape(f) for f in frames if np.shape(f) != shape]
            if bad:  # isolate the stream; its siblings run on
                self.failed[si] = StreamError(si, ValueError(
                    f"frame shape {bad[0]} != {shape}"))
                continue
            n_si = len(frames)
            if not n_si:
                continue
            tail = self._tails[si]
            if planar:  # the host lays out each frame, RGB planes
                with self._io.stage("stage_in"):
                    new = buf[row, tr:]
                    for i, f in enumerate(frames):
                        new[i] = native.planarize(f, self.hp, self.wp)
                    new[n_si:] = new[n_si - 1]
                    if tr:  # the tail rows go up with the frames
                        # (a fresh stream's tail is T copies of its frame 0)
                        buf[row, :t] = (new[0] if tail is None
                                        else self._planar_tail(si))
                kept = list(new[:n_si])
            else:
                # slots past n_si hold replicas of the last frame; the
                # kernel reads them as invalid and leaves the carried state
                # alone
                rows[row] = [(buf[row, i], frames[min(i, n_si - 1)])
                             for i in range(b)]
                kept = frames
            if tail is None:
                fresh.append(row)
                seeds[row] = 1
            elif not (self.ring_carry or planar or row in self._tail_live):
                resumed[row] = self._planar_tail(si)
            # the old tail is read above: the staging copy below may write
            # the slots its dropped frames held
            self._tails[si], copies = self._tail_slots[si].keep(tail, kept)
            tail_copies += copies
            valid[row, :n_si] = True
            # markers fire on each stream's own cursor
            cursor = self.frame_cursors[si]
            capture_flags(flags[row], cursor, n_si,
                          self.props.refresh_markers, self._snap_pending[si])
            self._snap_pending[si] = False
            self.frame_cursors[si] = cursor + n_si
            self._ring_offs[si] = (self._ring_offs[si] + n_si) % t
            written[row] = n_si
        # stale frames of a stream gone quiet or dead, zeroed in the copy
        # of the piece that uploads them
        zero = np.broadcast_to(np.uint8(0), buf.shape[1:])
        for row in self._stage_written - set(written):
            rows[row] = [(buf[row], zero)]
        self._stage_written = set(written)

        with self._io.send(buf, rows, tail_copies) as staged, \
                self._io.stage("dispatch"):
            raw = self._planar
            # the input (F, 3, S*Hp, Wp) seen as (S, F, 3, Hp, Wp): each
            # stream's rows are written in place, no transpose per batch
            if planar:
                raw.view(tr + b, 3, s, self.hp, self.wp).permute(
                    2, 0, 1, 3, 4).copy_(staged)
                fresh = []  # their tail rows came up from the host
            else:
                self._prep(staged, out=raw[tr:].view(
                    b, 3, s, self.hp, self.wp).permute(2, 0, 1, 3, 4))
            if self.ring_carry:
                out, stats = self._launch_ring(raw, flags, valid, offsets,
                                               seeds)
            else:
                out, stats = self._launch_tail(raw, flags, valid, written,
                                               fresh, resumed)
            out = self._io.maps(out, n)
        maps, stats_np = self._io.collect(out, stats[:, :n], n)
        # mean |diff| over valid slots only: padding replicas and dead
        # streams stay out of the aggregate
        vw = torch.from_numpy(valid[:, :n]).to(torch.float32)
        total, count = self._global_sums(
            (torch.from_numpy(stats_np)[..., 1] * vw).sum(), vw.sum())
        return maps, stats_np, float(total / torch.clamp(count, min=1.0))

    def _launch_ring(self, raw: torch.Tensor, flags, valid, offsets, seeds):
        """One stacked ring-carry launch over the B-row planar input, or
        one per cell of the mesh."""
        lay = self._layout
        outs, stats = run_grid_ring_step(
            self.props, self.height, self.width, lay,
            lay.scatter(raw, out=self._raw_cells), self._state(), flags,
            valid, offsets, seeds, self.slab_impl, self.device)
        return lay.gather(outs, self.device), stats

    def _launch_tail(self, raw: torch.Tensor, flags, valid,
                     written: Dict[int, int], fresh: List[int],
                     resumed: Dict[int, np.ndarray]):
        """One stacked tail launch (one per cell of the mesh) over the
        (T+B)-row planar input; ``written`` / ``fresh`` / ``resumed`` are
        keyed by row section.  Before it, every staged stream's rows [0, T)
        hold its tail and every other stream's are zero; after it, each
        staged stream's next tail is its rows [n_si, n_si + T)."""
        s, t = self._stage_rows(), self.props.temporal_size
        h, w = self.height, self.width
        self._drop_tails(set(range(s)) - set(written))
        for row in fresh:  # the tail starts as T copies of frame 0
            r = self._rows(row)
            raw[:t, :, r] = raw[t, :, r]
        for row, tail in resumed.items():
            raw[:t, :, self._rows(row)] = torch.from_numpy(tail)
        lay = self._layout
        outs, stats = run_grid_step(
            self.props, h, w, lay, lay.scatter(raw, out=self._raw_cells),
            dict(baseline=self._baseline, heatmap=self._heatmap), flags,
            valid, self.slab_impl, self.backend, self.device)
        out = lay.gather(outs, self.device)
        # through a temporary: the two row ranges overlap when n_si < T
        if len(written) == s and len(set(written.values())) == 1:
            spans = [(next(iter(written.values())), slice(None))]
        else:
            spans = [(n_si, self._rows(row))
                     for row, n_si in written.items()]
        for n_si, r in spans:
            raw[:t, :, r] = raw[n_si:n_si + t, :, r].clone()
        self._tail_live = set(written)
        return out, stats
