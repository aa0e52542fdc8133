"""DiPsEngine: the streaming pipeline over one stream, on either of the
JAX engine's protocols.

Counterpart of ``dips_tpu/models/pipeline.py``.  The engine owns its
carried state as tensors on ``device`` and each batch's kernel updates it
in place:

* ring-carry (``ring_carry=True``, the default): the filtered temporal
  ring (median modes), the previous plane (PER_FRAME), the baseline and
  the heatmap; the input is the B new frames;
* tail (``ring_carry=False``): the baseline and the heatmap only; the input
  is the raw planar tail of the last T frames followed by the B new ones,
  and the kernel rebuilds the ring from the tail at every launch.  The tail
  stays on the device: after a launch, rows [n, n+T) of the (T+B)-row
  planar batch are the next batch's rows [0, T).

It owns the layout prep (a short batch's padding replicates its last
frame on the device), the launches, the dispatch / collect pair and the
optional FFT denoise of the maps (``denoise_radius``); staging, upload,
crop and interleave, wait and download go through ``models/batchio.py``,
as the fleet's do.  The module also holds what both engines share: the
checked geometry (:class:`EngineBase`) and the one-stream checkpoint,
the JAX engine's .npz of the raw planar u8 tail of the last T frames
(after a load the ring engine rebuilds its ring by running the kernel
over the tail with inert flags and seed 1).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..errors import DeviceError
from ..properties import DiPsProperties, OutputMode
from ..ops import cuda_fused, reference
from ..ops.reference import NUM_STATS, pad_geometry
from ..utils import profiling
from ..utils.staging import TailSlots
from .batchio import BatchIO, capture_flags

_RAW_MODES = (OutputMode.ABSDIFF, OutputMode.THRESHOLD,
              OutputMode.STATS_ONLY)
#: upload buffers of the single-stream engine (one can be filling while
#: the previous one is still being copied)
_UPLOAD_BUFFERS = 2


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


# -- the one-stream checkpoint (DiPsEngine's and a fleet slot's) -----------
def save_slot(path: str, state: dict, height: int, width: int) -> None:
    """Write a ``DiPsEngine.state_dict``-form ``state`` as the JAX engine's
    .npz (an empty tail array when there is no tail)."""
    tail = state["tail"]
    np.savez_compressed(
        path, frame_index=state["frame_index"], baseline=state["baseline"],
        heatmap=state["heatmap"],
        tail=tail if tail is not None else np.zeros((0,), np.uint8),
        geometry=np.asarray([height, width], np.int64))


def load_slot(path: str, height: int, width: int) -> dict:
    """A :func:`save_slot` file as a state dict, its geometry (when it
    records one) checked against ``height`` x ``width``."""
    with np.load(path) as z:
        if "geometry" in z.files:
            gh, gw = (int(v) for v in z["geometry"])
            if (gh, gw) != (height, width):
                raise ValueError(f"checkpoint geometry {gh}x{gw} != engine "
                                 f"{height}x{width}")
        tail = z["tail"]
        return {"frame_index": int(z["frame_index"]),
                "baseline": z["baseline"], "heatmap": z["heatmap"],
                "tail": tail if tail.size else None}


def slot_baseline(baseline, raw_mode: bool, hp: int, wp: int) -> np.ndarray:
    """A checkpoint's per-stream baseline, its shape checked, as a copy in
    the engine's dtype (u8 (3, Hp, Wp) in raw modes, f32 (Hp, Wp) in the
    median modes)."""
    bl = np.asarray(baseline)
    expect = (3, hp, wp) if raw_mode else (hp, wp)
    if bl.shape != expect:
        raise ValueError(
            f"checkpoint baseline shape {bl.shape} != engine's expected "
            f"per-stream {expect} (raw and median modes have different "
            f"baseline representations)")
    return np.array(bl, dtype=np.uint8 if raw_mode else np.float32)


def slot_tail(slots: TailSlots, tail, hp: int, wp: int,
              empty_ok: bool) -> Optional[list]:
    """A checkpoint's tail frames (or None: no tail) as a stream's tail:
    the last T planar frames copied into ``slots``; a short tail replicates
    its oldest frame up to T, as the JAX engine seeds it.  An empty list
    is no tail when ``empty_ok``, else an error."""
    if tail is None:
        return None
    t = slots.t
    tl = [np.asarray(f, np.uint8) for f in tail][-t:]
    if not tl:
        if empty_ok:
            return None
        raise ValueError("checkpoint tail holds no frame")
    if tl[0].shape != (3, hp, wp):
        raise ValueError(f"checkpoint tail frame shape {tl[0].shape} != "
                         f"{(3, hp, wp)}")
    return slots.load([tl[0]] * (t - len(tl)) + tl)


class EngineBase:
    """What both engines share: the checked geometry of their frames and,
    once the engine has built its batch I/O layer (``self._io``, a
    :class:`~dips_tpu_torch.models.batchio.BatchIO`), its ``timers``,
    ``staging`` and ``downloads``."""

    def __init__(self, props: DiPsProperties, height: int, width: int,
                 batch: int, device, input_layout: str, packed_wire: bool,
                 downscale: int):
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
        if packed_wire and (props.output != OutputMode.THRESHOLD
                            or props.out_channels == 0):
            raise ValueError("packed_wire requires THRESHOLD output with "
                             "emit_maps=True (there must be masks to pack)")
        self.packed_wire = bool(packed_wire)
        self.device = resolve_device(device)
        self.input_layout = input_layout
        self._swap_rb, self._prep = reference.make_layout_prep(
            input_layout, self.height, self.width, self.hp, self.wp,
            downscale=self.downscale)
        self._raw_mode = props.output in _RAW_MODES

    @property
    def timers(self) -> Optional[profiling.StageTimers]:
        """The stage timers (None: off); while set, the counters count."""
        return self._io.timers

    @timers.setter
    def timers(self, timers: Optional[profiling.StageTimers]) -> None:
        self._io.timers = timers

    @property
    def staging(self):
        """The batches' staging copies and counts (``utils/staging.py``)."""
        return self._io.staging

    @property
    def downloads(self):
        """The batches' downloads and counts (``utils/downloads.py``)."""
        return self._io.downloads

    @property
    def _tail_len(self) -> int:
        """Rows of raw tail ahead of the new frames in a launch."""
        return 0 if self.ring_carry else self.props.temporal_size

    @property
    def tail_rows(self) -> int:
        """Leading tail rows of a stream's upload buffer: T in the planar
        layout's tail protocol (the JAX engine's layout), else 0.  New
        frames go at ``buf[tail_rows + i]``."""
        return self._tail_len if self.input_layout == "planar" else 0

    @property
    def _buffer_shape(self) -> tuple:
        """Shape of a stream's upload buffer (``new_batch_buffer``)."""
        if self.input_layout == "planar":
            return (self.tail_rows + self.batch, 3, self.hp, self.wp)
        return (self.batch, self.in_height, self.in_width, 3)

    def _planar_input(self, streams: int) -> torch.Tensor:
        """The planar device input of ``streams`` row-stacked streams, the
        tail rows first in the tail protocol: the padding stays zero, only
        the true region of each stream is rewritten per batch."""
        return torch.zeros((self._tail_len + self.batch, 3,
                            streams * self.hp, self.wp),
                           dtype=torch.uint8, device=self.device)

    def _planar_stack(self, tail) -> Optional[np.ndarray]:
        """A tail (frames oldest first; None or empty: no tail) as planar
        RGB (T, 3, Hp, Wp) u8 at the analysis geometry: a planar frame as
        it is, an input-layout frame pooled under ``downscale`` (bit-equal
        to the device prep) and planarized on the host."""
        if not tail:
            return None
        planes = []
        for f in tail:
            if f.shape != (3, self.hp, self.wp):
                if self.downscale > 1:
                    f = reference.pool_frame_host(f, self.downscale)
                f = native.planarize(f, self.hp, self.wp,
                                     swap_rb=self._swap_rb)
            planes.append(f)
        return np.stack(planes)


class DiPsEngine(EngineBase):
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
    None by default; ``staging`` and ``downloads`` count while it is set,
    ``models/batchio.py``) splits the time into ``stage_in`` (the frames,
    planarized in the planar layout, into the upload buffer and the tail's
    newest frames into its slots, in one staging copy), ``tail_keep`` (the
    tail's copies out of a buffer the caller filled), ``h2d``, ``dispatch``
    (layout prep, launch, crop and interleave or packing), ``denoise``
    (with ``denoise_radius``), ``wait`` and ``d2h``; each is a
    ``dips.engine.<stage>`` span while a ``torch.profiler`` records.  The
    host tail lives in T slots the engine reuses (``TailSlots``).

    ``denoise_counts`` (a :class:`~dips_tpu_torch.utils.profiling.StepCounts`)
    counts the denoise step while ``timers`` is set: batches, frames,
    planes and its device time, read at :meth:`collect` after the wait.
    """

    def __init__(self, props: DiPsProperties, height: int, width: int,
                 batch: int = 8, device="cuda", input_layout: str = "hwc",
                 ring_carry: bool = True, packed_wire: bool = False,
                 downscale: int = 1, denoise_radius: Optional[int] = None):
        super().__init__(props, height, width, batch, device, input_layout,
                         packed_wire, downscale)
        self.ring_carry = bool(ring_carry)
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
        self._planar = self._planar_input(1)
        self._io = BatchIO(self.device, self.height, self.width,
                           props.out_channels, self.packed_wire, None,
                           self._buffer_shape, _UPLOAD_BUFFERS)
        self.reset()

    # -- state ------------------------------------------------------------
    @property
    def analysis_pixels(self) -> int:
        """Pixels the per-frame statistics reduce over: the roi area when
        ``props.roi`` is set, else the whole (analysis) frame -- the right
        ``pixels`` for a ``changed_frac`` MotionDetector on this engine."""
        return self.props.analysis_pixels(self.height, self.width)

    def _zeros(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def reset(self) -> None:
        """Clear all streaming state (cursor, tail, ring, baseline,
        heatmap)."""
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
        self._force_snapshot = False
        self._zero_carry()

    def _zero_carry(self) -> None:
        """Fresh ring (median modes) and prev of the ring protocol."""
        plane = (self.hp, self.wp)
        self._ring_off = 0
        self._seeded = False
        self._ring = self._prev = None
        if not self.ring_carry:
            return
        if self._raw_mode:
            self._prev = self._zeros((3,) + plane, torch.uint8)
        else:
            self._ring = self._zeros((self.props.temporal_size,) + plane,
                                     torch.float32)
            self._prev = self._zeros(plane, torch.float32)

    def snapshot(self) -> None:
        """Force a baseline re-capture on the next frame."""
        self._force_snapshot = True

    # -- core ---------------------------------------------------------------
    def _empty_result(self):
        return (np.zeros((0, self.height, self.width,
                          self.props.out_channels), np.uint8),
                np.zeros((0, NUM_STATS), np.float32))

    def new_batch_buffer(self) -> np.ndarray:
        """A host buffer for one batch: (B, H_in, W_in, 3) uint8 in a hwc
        layout, fill rows [0:n]; (tail_rows + B, 3, Hp, Wp) in the planar
        layout, fill rows [tail_rows : tail_rows + n] with padded planar
        frames.  Page-locked on a card, where the upload reads it directly;
        the engine hands it out again once the batch dispatched from it
        was uploaded."""
        return self._io.buffer()

    def process_batch(self, frames: Sequence[np.ndarray],
                      packed: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Process up to ``batch`` (H_in, W_in, 3) uint8 frames; returns
        (outputs uint8 (n, H, W, C), stats float32 (n, 4)), or the packed
        masks with ``packed`` (see :meth:`collect`).  In the planar layout
        the frames are planarized on the host first."""
        return self._process(frames, (self.in_height, self.in_width, 3),
                             self.input_layout == "planar", packed)

    def process_planar(self, planar: Sequence[np.ndarray],
                       packed: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Process up to ``batch`` frames already in padded planar
        (3, Hp, Wp) uint8 layout (``input_layout="planar"`` only)."""
        if self.input_layout != "planar":
            raise ValueError(
                f"process_planar on an input_layout={self.input_layout!r} "
                f"engine: feed (H, W, 3) frames via process_batch instead")
        return self._process(planar, (3, self.hp, self.wp), False, packed)

    def _process(self, frames, shape: tuple, planarize: bool, packed: bool):
        """Check, stage, dispatch and collect one batch of frames."""
        n = len(frames)
        if n == 0:
            return self._empty_result()
        if n > self.batch:
            raise ValueError(f"got {n} frames > batch {self.batch}")
        for f in frames:
            if f.shape != shape:
                raise ValueError(f"frame shape {f.shape} != {shape}")
        with self._io.stage("stage_in"):
            if planarize:
                frames = [native.planarize(f, self.hp, self.wp)
                          for f in frames]
            buf, tail = self._stage_frames(frames)
        return self.collect(self._dispatch(buf, n, tail), packed=packed)

    def _stage_frames(self, frames: Sequence[np.ndarray]):
        """(an upload buffer with the frames in its rows ``[tail_rows:]``,
        the tail after them): the frames into the buffer and the tail's
        newest frames into its slots, straight from the caller's frames,
        in one staging copy."""
        buf = self._io.buffer()
        tr = self.tail_rows
        tail, copies = self._tail_slots.keep(self._tail or None, frames)
        self._io.copy([(buf[tr + i], f) for i, f in enumerate(frames)]
                      + copies)
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
        with self._io.stage("tail_keep"):
            tail, copies = self._tail_slots.keep(self._tail or None,
                                                 list(buf[tr:tr + n]))
            self._io.copy(copies)
        return self._dispatch(buf, n, tail)

    def _dispatch(self, buf: np.ndarray, n: int, tail: List[np.ndarray]):
        """:meth:`dispatch_async` once the tail after the batch, ``tail``,
        is in its slots."""
        t = self.props.temporal_size
        b = self.batch
        first = not self._tail  # the tail starts as T x frame 0
        self._tail = tail

        flags = np.zeros((b,), np.bool_)
        valid = np.zeros((b,), np.bool_)
        valid[:n] = True
        capture_flags(flags, self.frame_index, n, self.props.refresh_markers,
                      self._force_snapshot)
        self._force_snapshot = False

        raw = self._planar
        tr = self._tail_len
        lo = self.tail_rows
        src = self._io.upload(buf, lo, lo + n)
        with self._io.stage("dispatch"):
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
            if self.denoise_radius is None:
                out = self._io.maps(out, n)
        if self.denoise_radius is not None:
            with self._io.stage(profiling.POST_STAGE):
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
                    if self._io.counting else contextlib.nullcontext())
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
        res = self._io.collect(out, stats, n, packed)
        self.denoise_counts.settle()
        return res

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
            "tail": self._planar_stack(self._tail),
            "heatmap": self._heatmap.to("cpu", copy=True).numpy(),
        }

    def load_state_dict(self, state: dict) -> None:
        bl = slot_baseline(state["baseline"], self._raw_mode, self.hp,
                           self.wp)
        self.frame_index = int(state["frame_index"])
        self._baseline = torch.from_numpy(bl).to(self.device)
        # copies: the caller keeps its arrays
        self._tail = slot_tail(self._tail_slots, state["tail"], self.hp,
                               self.wp, empty_ok=True) or []
        if state.get("heatmap") is not None:
            self._heatmap = torch.from_numpy(np.array(
                state["heatmap"], dtype=np.float32)).to(self.device)
        # a snapshot requested before the restore must not fire after it
        self._force_snapshot = False
        if self.ring_carry:
            self._rebuild_ring_state()
        elif self._tail:
            self._planar[:self._tail_len] = torch.from_numpy(
                self._planar_stack(self._tail))

    def _rebuild_ring_state(self) -> None:
        """Rebuild the carried ring / prev from the raw tail: one kernel
        launch over the T tail frames with inert capture flags, all frames
        valid, seed 1 and a scratch heatmap; outputs are discarded."""
        t = self.props.temporal_size
        self._zero_carry()
        tail = self._planar_stack(self._tail)
        if tail is None:
            return
        tailbuf = torch.from_numpy(tail).to(self.device)
        flags = np.zeros((t,), np.bool_)
        valid = np.ones((t,), np.bool_)
        scratch = self._zeros((self.hp, self.wp), torch.float32)
        if self._raw_mode:
            cuda_fused.absdiff_step_ring(
                self.props, self.height, self.width, tailbuf, self._prev,
                self._baseline, flags, scratch, valid, 1)
        else:
            cuda_fused.batch_step_ring(
                self.props, self.height, self.width, tailbuf, self._ring,
                self._prev, self._baseline, flags, scratch, valid, 0, 1)
        # tail frame j sits in slot j (offset 0); the next frame
        # overwrites slot 0
        self._seeded = True

    def heatmap(self) -> np.ndarray:
        """Accumulated per-pixel |diff|, cropped to the true geometry."""
        return self._heatmap.cpu().numpy()[:self.height, :self.width]

    def save(self, path: str) -> None:
        """Persist streaming state (the JAX engine's .npz format)."""
        save_slot(path, self.state_dict(), self.height, self.width)

    def load(self, path: str) -> None:
        self.load_state_dict(load_slot(path, self.height, self.width))
