"""DiPsEngine: the streaming pipeline, on either of the JAX engine's
protocols.

Counterpart of ``dips_tpu/models/pipeline.py``.  The engine owns its
carried state as tensors on ``device`` and each batch's kernel updates it
in place (no copy per step):

* ring-carry (``ring_carry=True``, the default, as on the JAX engine's fast
  backend): the filtered temporal ring (median modes), the previous plane
  (PER_FRAME), the baseline and the heatmap; the input is the B new frames;
* tail (``ring_carry=False``): the baseline and the heatmap only; the input
  is the raw planar tail of the last T frames followed by the B new ones,
  and the kernel rebuilds the ring from the tail at every launch.  The tail
  stays on the device: after a launch, rows [n, n+T) of the (T+B)-row
  planar batch are the next batch's rows [0, T).

Per batch: one staging copy on the host (``utils/staging.py``: the frames
into a pinned host buffer on a card, the tail's newest frames into host
slots the engine reuses, on a pool of host threads when the batch is
large), one upload of the (n, H, W, 3) frames, the layout prep on the
device (optional k x k box mean, permute, optional BGR flip, zero pad
into a planar buffer the engine keeps), one kernel launch, then crop and
interleave on the device before one download of the maps and stats into
page-locked host memory the caller owns (``utils/downloads.py``).  With
``denoise_radius`` the kernel's planar maps go through the FFT low-pass
of ``ops/analysis.py`` on the device first, and only the denoised maps
come down.  With ``input_layout="planar"`` the host hands over padded
planar frames and the upload goes straight into the planar buffer; with
``packed_wire`` (THRESHOLD) the masks are bit-packed on the device and
unpacked on the host.

Checkpoints are byte-compatible with the JAX engine's and the same in both
protocols: they hold the raw planar u8 tail of the last T frames (at the
analysis geometry under ``downscale``).  After a load the ring engine
rebuilds its ring from the tail by running the kernel over it with inert
flags and seed 1; the tail engine just uploads it.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..errors import DeviceError
from ..properties import DiPsProperties, OutputMode
from ..ops import cuda_fused, reference, wire
from ..ops.reference import NUM_STATS, pad_geometry
from ..utils import profiling
from ..utils.downloads import Downloads
from ..utils.staging import Staging, TailSlots

_RAW_MODES = (OutputMode.ABSDIFF, OutputMode.THRESHOLD,
              OutputMode.STATS_ONLY)
#: pinned upload buffers kept per engine on a card (one can be filling
#: while the previous one is still being copied)
_PINNED_BUFFERS = 2


def tail_frame_planar(frame: np.ndarray, hp: int, wp: int, downscale: int,
                      swap_rb: bool) -> np.ndarray:
    """A checkpoint-tail entry as a planar RGB (3, Hp, Wp) frame at the
    analysis geometry: a planar frame as it is, an input-layout (H, W, 3)
    frame pooled (``downscale`` > 1, bit-equal to the device prep) and
    planarized on the host (``native.planarize``, equal to
    ``reference.planarize_host``)."""
    if frame.shape == (3, hp, wp):
        return frame
    if downscale > 1:
        frame = reference.pool_frame_host(frame, downscale)
    return native.planarize(frame, hp, wp, swap_rb=swap_rb)


def resolve_device(device) -> torch.device:
    """``None`` or "cuda" -> the current card, "cuda:N" -> card N; without
    a card these raise :class:`DeviceError`.  "cpu" runs the kernels' plain
    twins and must be asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceError(f"device {device!r} requested but torch sees "
                              f"no CUDA device")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise DeviceError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def analysis_geometry(height: int, width: int, downscale, input_layout: str
                      ) -> Tuple[int, int, int, str]:
    """(analysis height, width, k, input layout) of an engine fed
    ``height`` x ``width`` frames with ``downscale`` = k: the k x k box
    mean runs in the device layout prep, so a "planar" layout becomes
    "hwc" when k > 1 (as the JAX engines promote it)."""
    k = int(downscale)
    if k < 1:
        raise ValueError(f"downscale must be >= 1, got {downscale}")
    if k > 1:
        if height % k or width % k:
            raise ValueError(
                f"downscale {k} must divide the input geometry "
                f"{height}x{width} (crop the stream or pick a divisor)")
        height, width = height // k, width // k
        if input_layout == "planar":
            input_layout = "hwc"
    return int(height), int(width), k, input_layout


def check_packed_wire(props: DiPsProperties, packed_wire: bool) -> bool:
    """``packed_wire`` needs THRESHOLD masks (the JAX engines' rule)."""
    if packed_wire and (props.output != OutputMode.THRESHOLD
                        or props.out_channels == 0):
        raise ValueError("packed_wire requires THRESHOLD output with "
                         "emit_maps=True (there must be masks to pack)")
    return bool(packed_wire)


class DiPsEngine:
    """Stateful streaming engine: feed uint8 (H, W, 3) frames, get diff maps
    and per-frame statistics.

    Args:
      props: pipeline configuration.
      height, width: true input frame geometry.  With ``downscale = k > 1``
        the analysis geometry (maps, stats, heatmap, roi, checkpoints) is
        ``height/k x width/k`` (``.height`` / ``.width``; the input dims
        stay on ``.in_height`` / ``.in_width``).
      batch: frames per kernel launch (B).
      device: "cuda" (the default; None means the same), "cuda:N" or
        "cpu".  Without a card "cuda" raises :class:`DeviceError`; on the
        CPU the kernels' plain PyTorch twins run.
      input_layout: "hwc" (RGB frames), "hwc_bgr" (cv2's BGR order,
        swapped on the device in the same copy) or "planar" (padded planar
        (3, Hp, Wp) frames from the host: :meth:`process_planar`, or
        :meth:`new_batch_buffer` rows ``[tail_rows:]``).
      ring_carry: True for the ring-carry protocol, False for the tail
        protocol; both give the same outputs.
      packed_wire: THRESHOLD only: bit-pack the masks on the device before
        the download (1/8 of the bytes, ``ops/wire.py``) and unpack them on
        the host; ``collect(packed=True)`` returns the packed bytes.
      downscale: k >= 1, the k x k box mean of each input frame on the
        device (a hwc layout; "planar" becomes "hwc").
      denoise_radius: r >= 1 runs the post-analysis on the device: the
        square low-pass of ``ops/analysis.denoise_planes`` over each
        frame's planar maps of the true region, before they are
        interleaved, so the maps come down denoised, once.  Needs maps,
        and no ``packed_wire`` (denoised masks are no longer masks).  None
        (the default) leaves the path as it is.

    ``timers`` (a :class:`~dips_tpu_torch.utils.profiling.StageTimers`,
    None by default) splits the time into ``stage_in`` (the frames into the
    host buffer, planarized in the planar layout, and the tail's newest
    frames into its slots, in one staging copy), ``tail_keep`` (the tail's
    copies out of a buffer the caller filled: :meth:`process_buffer`,
    :meth:`dispatch_async`), ``h2d`` (the upload), ``dispatch`` (layout
    prep, launch and packing), ``wait`` (the host blocked until the device
    has run what was enqueued) and ``d2h`` (the downloads).  Kernels run
    asynchronously on the card, so ``dispatch`` holds only the enqueue;
    ``d2h`` no longer holds the wait for the device.  While a
    ``torch.profiler`` records, each stage is also a ``dips.engine.<stage>``
    span (:func:`~dips_tpu_torch.utils.profiling.stage`).

    ``downloads`` (a :class:`~dips_tpu_torch.utils.downloads.Downloads`)
    brings each batch's maps and stats down; on a card, while ``timers``
    is set, it counts the batches, their bytes and those whose download
    page-locked a new host block.

    ``staging`` (a :class:`~dips_tpu_torch.utils.staging.Staging`) makes
    each batch's host copies and, while ``timers`` is set, counts the
    batches, their bytes, those the thread pool copied and its threads.
    The host tail lives in T slots the engine reuses (``TailSlots``); it
    never views the caller's frames or an upload buffer.

    ``denoise_counts`` (a :class:`~dips_tpu_torch.utils.profiling.StepCounts`)
    counts the denoise step while ``timers`` is set: batches, frames,
    planes and its device time, read at :meth:`collect` after the wait.
    """

    def __init__(self, props: DiPsProperties, height: int, width: int,
                 batch: int = 8, device="cuda", input_layout: str = "hwc",
                 ring_carry: bool = True, packed_wire: bool = False,
                 downscale: int = 1, denoise_radius: Optional[int] = None):
        if height <= 0 or width <= 0:
            raise ValueError(f"bad geometry {height}x{width}")
        if batch < 1:
            raise ValueError("batch must be >= 1")
        self.props = props
        self.in_height, self.in_width = int(height), int(width)
        self.height, self.width, self.downscale, input_layout = \
            analysis_geometry(height, width, downscale, input_layout)
        props.roi_bounds(self.height, self.width)  # fail early on a bad roi
        self.hp, self.wp = pad_geometry(self.height, self.width)
        self.batch = int(batch)
        self.packed_wire = check_packed_wire(props, packed_wire)
        self.device = resolve_device(device)
        self.input_layout = input_layout
        self._swap_rb, self._prep = reference.make_layout_prep(
            input_layout, self.height, self.width, self.hp, self.wp,
            downscale=self.downscale)
        self._raw_mode = props.output in _RAW_MODES
        self.ring_carry = bool(ring_carry)
        self.timers = None
        self.downloads = Downloads(self.device)
        self.staging = Staging()
        self._tail_slots = TailSlots(props.temporal_size)
        self.denoise_radius = self._denoise_mask = None
        self.denoise_counts = profiling.StepCounts()
        if denoise_radius is not None:
            if denoise_radius < 1:
                raise ValueError(f"denoise_radius must be >= 1, got "
                                 f"{denoise_radius}")
            if props.out_channels == 0:
                raise ValueError("denoise filters diff maps; a map-"
                                 "suppressed pipeline (STATS_ONLY / "
                                 "emit_maps=False) has none")
            if self.packed_wire:
                raise ValueError("denoise_radius with packed_wire: the "
                                 "denoised masks are not bit-packable")
            from ..ops.analysis import lowpass_mask
            self.denoise_radius = int(denoise_radius)
            self._denoise_mask = lowpass_mask(self.height, self.width,
                                              self.denoise_radius,
                                              self.device)
        # planar device batch, the tail rows first in the tail protocol:
        # the padding stays zero, only the true region is rewritten
        self._planar = torch.zeros(
            (self._tail_len + self.batch, 3, self.hp, self.wp),
            dtype=torch.uint8, device=self.device)
        self._pinned: List[Tuple[torch.Tensor, np.ndarray, list]] = []
        self._pinned_next = 0
        if self.device.type == "cuda":
            for _ in range(_PINNED_BUFFERS):
                t = torch.empty(self._buffer_shape, dtype=torch.uint8,
                                pin_memory=True)
                self._pinned.append((t, t.numpy(), [None]))
        self.reset()

    # -- state ------------------------------------------------------------
    @property
    def analysis_pixels(self) -> int:
        """Pixels the per-frame statistics reduce over: the roi area when
        ``props.roi`` is set, else the whole (analysis) frame -- the right
        ``pixels`` for a ``changed_frac`` MotionDetector on this engine."""
        return self.props.analysis_pixels(self.height, self.width)

    @property
    def _tail_len(self) -> int:
        """Rows of raw tail ahead of the new frames in a launch."""
        return 0 if self.ring_carry else self.props.temporal_size

    @property
    def tail_rows(self) -> int:
        """Leading tail rows in a :meth:`new_batch_buffer` buffer: T in the
        planar layout's tail protocol (the JAX engine's layout; the port
        keeps its tail on the device and never reads those rows), else 0.
        New frames go at ``buf[tail_rows + i]``."""
        return self._tail_len if self.input_layout == "planar" else 0

    @property
    def _buffer_shape(self) -> tuple:
        """Shape of a :meth:`new_batch_buffer` buffer."""
        if self.input_layout == "planar":
            return (self.tail_rows + self.batch, 3, self.hp, self.wp)
        return (self.batch, self.in_height, self.in_width, 3)


    def _zeros(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def reset(self) -> None:
        """Clear all streaming state (cursor, tail, ring, baseline,
        heatmap)."""
        t = self.props.temporal_size
        self.frame_index = 0
        # the last T frames, oldest first, in ``_tail_slots``: (H, W, 3)
        # frames in the input layout, planarized only when a checkpoint
        # asks for them, or planar (3, Hp, Wp) frames; empty before the
        # first batch
        self._tail: List[np.ndarray] = []
        plane = (self.hp, self.wp)
        if self._raw_mode:
            self._baseline = self._zeros((3,) + plane, torch.uint8)
        else:
            self._baseline = self._zeros(plane, torch.float32)
        self._heatmap = self._zeros(plane, torch.float32)
        self._ring_off = 0
        self._seeded = False
        self._force_snapshot = False
        self._ring = self._prev = None
        if not self.ring_carry:
            return
        if self._raw_mode:
            self._prev = self._zeros((3,) + plane, torch.uint8)
        else:
            self._ring = self._zeros((t,) + plane, torch.float32)
            self._prev = self._zeros(plane, torch.float32)

    def _is_capture(self, idx: int) -> bool:
        return idx == 0 or idx in self.props.refresh_markers

    def snapshot(self) -> None:
        """Force a baseline re-capture on the next frame."""
        self._force_snapshot = True

    def _planar_tail(self) -> Optional[np.ndarray]:
        if not self._tail:
            return None
        return np.stack([tail_frame_planar(
            f, self.hp, self.wp, self.downscale, self._swap_rb)
            for f in self._tail])

    # -- core ---------------------------------------------------------------
    def _empty_result(self):
        return (np.zeros((0, self.height, self.width,
                          self.props.out_channels), np.uint8),
                np.zeros((0, NUM_STATS), np.float32))

    def _stage(self, name: str):
        return profiling.stage(self.timers, name)

    def new_batch_buffer(self) -> np.ndarray:
        """A host buffer for one batch: (B, H_in, W_in, 3) uint8 in a hwc
        layout, fill rows [0:n]; (tail_rows + B, 3, Hp, Wp) in the planar
        layout, fill rows [tail_rows : tail_rows + n] with padded planar
        frames.  On a card it is pinned memory the upload reads directly;
        it may be handed out again once the batch dispatched from it was
        uploaded."""
        if not self._pinned:
            return np.empty(self._buffer_shape, np.uint8)
        _, arr, ev = self._pinned[self._pinned_next]
        self._pinned_next = (self._pinned_next + 1) % len(self._pinned)
        if ev[0] is not None:
            ev[0].synchronize()
            ev[0] = None
        return arr

    def process_batch(self, frames: Sequence[np.ndarray],
                      packed: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Process up to ``batch`` (H_in, W_in, 3) uint8 frames; returns
        (outputs uint8 (n, H, W, C), stats float32 (n, 4)), or the packed
        masks with ``packed`` (see :meth:`collect`).  In the planar layout
        the frames are planarized on the host first."""
        n = len(frames)
        if n == 0:
            return self._empty_result()
        if n > self.batch:
            raise ValueError(f"got {n} frames > batch {self.batch}")
        shape = (self.in_height, self.in_width, 3)
        for f in frames:
            if f.shape != shape:
                raise ValueError(f"frame shape {f.shape} != {shape}")
        with self._stage("stage_in"):
            if self.input_layout == "planar":
                frames = [native.planarize(f, self.hp, self.wp)
                          for f in frames]
            buf, tail = self._stage_frames(frames)
        return self.collect(self._dispatch(buf, n, tail), packed=packed)

    def process_planar(self, planar: Sequence[np.ndarray],
                       packed: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Process up to ``batch`` frames already in padded planar
        (3, Hp, Wp) uint8 layout (``input_layout="planar"`` only)."""
        if self.input_layout != "planar":
            raise ValueError(
                f"process_planar on an input_layout={self.input_layout!r} "
                f"engine: feed (H, W, 3) frames via process_batch instead")
        n = len(planar)
        if n == 0:
            return self._empty_result()
        if n > self.batch:
            raise ValueError(f"got {n} frames > batch {self.batch}")
        for f in planar:
            if f.shape != (3, self.hp, self.wp):
                raise ValueError(f"planar frame shape {f.shape} != "
                                 f"{(3, self.hp, self.wp)}")
        with self._stage("stage_in"):
            buf, tail = self._stage_frames(planar)
        return self.collect(self._dispatch(buf, n, tail), packed=packed)

    def _stage_frames(self, frames: Sequence[np.ndarray]):
        """(a :meth:`new_batch_buffer` buffer with the frames in its rows
        ``[tail_rows:]``, the tail after them): the frames into the buffer
        and the tail's newest frames into its slots, straight from the
        caller's frames, in one staging copy."""
        buf = self.new_batch_buffer()
        tr = self.tail_rows
        tail, copies = self._tail_slots.keep(self._tail or None, frames)
        self.staging.copy([(buf[tr + i], f) for i, f in enumerate(frames)]
                          + copies, count=self.timers is not None)
        return buf, tail

    def process_buffer(self, buf: np.ndarray, n: int, packed: bool = False
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Process ``n`` frames already written into a
        :meth:`new_batch_buffer` buffer at ``buf[tail_rows:tail_rows+n]``;
        the engine fills the tail rows and the padding.  Returns what
        :meth:`collect` returns."""
        return self.collect(self.dispatch_async(buf, n), packed=packed)

    def dispatch_async(self, buf: np.ndarray, n: int):
        """Upload and launch one batch without waiting for its results;
        returns a handle for :meth:`collect`.  ``buf`` is a
        :meth:`new_batch_buffer` buffer with the n frames written.  State
        (cursor, tail, ring) advances at dispatch, so calls must stay
        ordered."""
        if n < 1 or n > self.batch:
            raise ValueError(f"n={n} outside 1..{self.batch}")
        if buf.shape != self._buffer_shape or buf.dtype != np.uint8:
            raise ValueError(f"batch buffer {buf.shape} {buf.dtype} != "
                             f"{self._buffer_shape} uint8")
        tr = self.tail_rows
        with self._stage("tail_keep"):
            tail, copies = self._tail_slots.keep(self._tail or None,
                                                 list(buf[tr:tr + n]))
            self.staging.copy(copies, count=self.timers is not None)
        return self._dispatch(buf, n, tail)

    def _dispatch(self, buf: np.ndarray, n: int, tail: List[np.ndarray]):
        """:meth:`dispatch_async` once the tail after the batch, ``tail``,
        is in its slots."""
        t = self.props.temporal_size
        b = self.batch
        tr_host = self.tail_rows
        new = buf[tr_host:tr_host + n]
        first = not self._tail  # the tail starts as T x frame 0
        self._tail = tail

        flags = np.zeros((b,), np.bool_)
        valid = np.zeros((b,), np.bool_)
        valid[:n] = True
        for i in range(n):
            flags[i] = self._is_capture(self.frame_index + i)
        if self._force_snapshot:
            flags[0] = True
            self._force_snapshot = False

        raw = self._planar
        tr = self._tail_len
        with self._stage("h2d"):
            src = torch.from_numpy(new)
            if self.device.type == "cuda":
                src = src.to(self.device, non_blocking=True)
                for _, arr, ev in self._pinned:
                    if arr.ctypes.data == buf.ctypes.data:
                        ev[0] = torch.cuda.Event()
                        ev[0].record()
        with self._stage("dispatch"):
            if self._prep is None:
                raw[tr:tr + n] = src
            else:
                self._prep(src, out=raw[tr:tr + n])
            if n < b:  # padding replicas of the last frame
                raw[tr + n:] = raw[tr + n - 1]
            if not self.ring_carry:
                if first:
                    raw[:t] = raw[t]
                out, stats = self._launch_tail(raw, flags, valid)
                # the next batch's tail: the last T of (tail + n new
                # frames), through a temporary (the two row ranges overlap
                # when n < T)
                raw[:t] = raw[n:n + t].clone()
            else:
                out, stats = self._launch_ring(raw, flags, valid)
                self._ring_off = (self._ring_off + n) % t
                self._seeded = True
            if self.packed_wire:
                # padded (n, 1, Hp/8, Wp): cropped after the host unpack
                out = wire.pack_mask(out[:n])
            elif out.shape[1] and self.denoise_radius is None:
                # crop + interleave on the device: one download per batch
                out = out[:n, :, :self.height, :self.width].permute(
                    0, 2, 3, 1).contiguous()
        if self.denoise_radius is not None:
            with self._stage(profiling.POST_STAGE):
                out = self._denoise(out, n)
        self.frame_index += n
        return out, stats[:n], n

    def _denoise(self, out: torch.Tensor, n: int) -> torch.Tensor:
        """The first ``n`` of the kernel's planar (B, C, Hp, Wp) maps
        through the low-pass over the true H x W region, one frame's C
        planes a transform, written interleaved: (n, H, W, C) uint8."""
        from ..ops import analysis
        h, w, c = self.height, self.width, out.shape[1]
        den = torch.empty((n, h, w, c), dtype=torch.uint8,
                          device=self.device)
        counting = (self.denoise_counts.step(self.device, n, n * c)
                    if self.timers is not None
                    else contextlib.nullcontext())
        with counting:
            for i in range(n):
                den[i] = analysis.denoise_planes(
                    out[i, :, :h, :w], self._denoise_mask).permute(1, 2, 0)
        return den

    def _launch_tail(self, raw: torch.Tensor, flags, valid):
        """One tail-protocol launch over the (T+B)-row planar batch."""
        step = (cuda_fused.absdiff_step if self._raw_mode
                else cuda_fused.batch_step)
        out, stats, *_ = step(self.props, self.height, self.width, raw,
                              self._baseline, flags, self._heatmap, valid)
        return out, stats

    def _launch_ring(self, raw: torch.Tensor, flags, valid):
        """One ring-carry launch over the B-row planar batch."""
        seed = 0 if self._seeded else 1
        # host flags: the wrapper uploads them with the seed in one copy
        if self._raw_mode:
            out, stats, *_ = cuda_fused.absdiff_step_ring(
                self.props, self.height, self.width, raw, self._prev,
                self._baseline, flags, self._heatmap, valid, seed)
        else:
            out, stats, *_ = cuda_fused.batch_step_ring(
                self.props, self.height, self.width, raw, self._ring,
                self._prev, self._baseline, flags, self._heatmap, valid,
                self._ring_off, seed)
        return out, stats

    def collect(self, handle, packed: bool = False
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Download a :meth:`dispatch_async` handle: (outputs uint8
        (n, H, W, C), stats float32 (n, 4)).  ``packed=True``
        (``packed_wire`` engines only) returns the device-packed padded
        masks (n, 1, Hp/8, Wp) as they came down, without the host
        unpack.  On a card the maps are a view of page-locked host
        memory the caller owns, the stats a copy of their own: no later
        batch writes into either."""
        out, stats, n = handle
        if packed and not self.packed_wire:
            raise ValueError("packed collect requires packed_wire=True")
        with self._stage("wait"):  # what the first download would wait for
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        self.denoise_counts.settle()
        counted = self.timers is not None
        with self._stage("d2h"):
            if out.shape[1] == 0:  # no maps: stats only
                stats_np, = self.downloads.fetch(stats, count=counted)
                return np.empty((n, self.height, self.width, 0),
                                np.uint8), stats_np
            out_np, stats_np = self.downloads.fetch(out, stats,
                                                    count=counted)
            if packed:
                return out_np, stats_np
            if self.packed_wire:
                out_np = np.moveaxis(wire.unpack_mask(out_np)[
                    :, :, :self.height, :self.width], 1, -1)
        return out_np, stats_np

    def process_frames(self, frames: Sequence[np.ndarray],
                       packed: bool = False
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Process any number of frames, batching internally.  Each
        batch is copied into one output allocated at the first, so one
        batch's download at a time is alive."""
        if len(frames) == 0:
            return self._empty_result()
        outs = stats = None
        for i in range(0, len(frames), self.batch):
            o, s = self.process_batch(frames[i:i + self.batch], packed=packed)
            if outs is None:
                outs = np.empty((len(frames),) + o.shape[1:], o.dtype)
                stats = np.empty((len(frames),) + s.shape[1:], s.dtype)
            outs[i:i + len(o)] = o
            stats[i:i + len(s)] = s
            # the batch's download goes back to the pool before the next
            del o, s
        return outs, stats

    # -- checkpoint / resume -------------------------------------------------
    def state_dict(self) -> dict:
        """Streaming state in the JAX engine's format: frame cursor,
        baseline, raw planar tail (T, 3, Hp, Wp) u8, heatmap."""
        return {
            "frame_index": self.frame_index,
            "baseline": self._baseline.to("cpu", copy=True).numpy(),
            "tail": self._planar_tail(),
            "heatmap": self._heatmap.to("cpu", copy=True).numpy(),
        }

    def load_state_dict(self, state: dict) -> None:
        bl = np.asarray(state["baseline"])
        expect = ((3, self.hp, self.wp) if self._raw_mode
                  else (self.hp, self.wp))
        if bl.shape != expect:
            raise ValueError(
                f"checkpoint baseline shape {bl.shape} != engine's expected "
                f"{expect} (raw and median modes have different baseline "
                f"representations)")
        self.frame_index = int(state["frame_index"])
        # copies (np.array): the engine updates its state in place
        self._baseline = torch.from_numpy(
            np.array(bl, dtype=np.uint8 if self._raw_mode
                     else np.float32)).to(self.device)
        self._tail = []
        if state["tail"] is not None:
            # a short tail (saved before T frames were seen) replicates its
            # oldest frame up to T, as the JAX engine does
            t = self.props.temporal_size
            tl = [np.asarray(f) for f in state["tail"]][-t:]
            if tl and tl[0].shape != (3, self.hp, self.wp):
                raise ValueError(
                    f"checkpoint tail frame shape {tl[0].shape} != "
                    f"{(3, self.hp, self.wp)}")
            if tl and len(tl) < t:
                tl = [tl[0]] * (t - len(tl)) + tl
            if tl:  # copies: the caller keeps its arrays
                self._tail = self._tail_slots.load(tl)
        if state.get("heatmap") is not None:
            self._heatmap = torch.from_numpy(np.array(
                state["heatmap"], dtype=np.float32)).to(self.device)
        # a snapshot requested before the restore must not fire after it
        self._force_snapshot = False
        if self.ring_carry:
            self._rebuild_ring_state()
        elif self._tail:
            self._planar[:self._tail_len] = torch.from_numpy(
                self._planar_tail())

    def _rebuild_ring_state(self) -> None:
        """Rebuild the carried ring / prev from the raw tail: one kernel
        launch over the T tail frames with inert capture flags, all frames
        valid, seed 1 and a scratch heatmap; outputs are discarded."""
        t = self.props.temporal_size
        plane = (self.hp, self.wp)
        self._ring_off = 0
        self._seeded = False
        if self._raw_mode:
            self._prev = self._zeros((3,) + plane, torch.uint8)
        else:
            self._ring = self._zeros((t,) + plane, torch.float32)
            self._prev = self._zeros(plane, torch.float32)
        tail = self._planar_tail()
        if tail is None:
            return
        tailbuf = torch.from_numpy(tail).to(self.device)
        flags = np.zeros((t,), np.bool_)
        valid = np.ones((t,), np.bool_)
        scratch = self._zeros(plane, torch.float32)
        if self._raw_mode:
            cuda_fused.absdiff_step_ring(
                self.props, self.height, self.width, tailbuf, self._prev,
                self._baseline, flags, scratch, valid, 1)
        else:
            cuda_fused.batch_step_ring(
                self.props, self.height, self.width, tailbuf, self._ring,
                self._prev, self._baseline, flags, scratch, valid, 0, 1)
        # tail frame j sits in slot j; the next frame overwrites slot 0
        self._ring_off = 0
        self._seeded = True

    def heatmap(self) -> np.ndarray:
        """Accumulated per-pixel |diff|, cropped to the true geometry."""
        return self._heatmap.cpu().numpy()[:self.height, :self.width]

    def save(self, path: str) -> None:
        """Persist streaming state (the JAX engine's .npz format)."""
        state = self.state_dict()
        np.savez_compressed(
            path, frame_index=state["frame_index"],
            baseline=state["baseline"], heatmap=state["heatmap"],
            tail=state["tail"] if state["tail"] is not None
            else np.zeros((0,), np.uint8),
            geometry=np.asarray([self.height, self.width], np.int64))

    def load(self, path: str) -> None:
        z = np.load(path)
        if "geometry" in z.files:
            gh, gw = (int(v) for v in z["geometry"])
            if (gh, gw) != (self.height, self.width):
                raise ValueError(
                    f"checkpoint geometry {gh}x{gw} != engine "
                    f"{self.height}x{self.width}")
        tail = z["tail"]
        self.load_state_dict({
            "frame_index": int(z["frame_index"]),
            "baseline": z["baseline"],
            "heatmap": z["heatmap"],
            "tail": tail if tail.size else None,
        })
