"""DiPsEngine: the streaming pipeline on the ring-carry protocol.

Counterpart of ``dips_tpu/models/pipeline.py`` with ``ring_carry=True``,
the JAX package's default on its fast backend.  The engine owns its carried
state as tensors on ``device`` -- the filtered temporal ring (median modes),
the previous plane (PER_FRAME), the baseline and the heatmap -- and each
batch's kernel updates them in place (no copy per step).

Per batch: one upload of the (n, H, W, 3) frames (from a pinned host buffer
on a card), the layout prep on the device (permute, optional BGR flip, zero
pad into a planar buffer the engine keeps), one kernel launch, then crop and
interleave on the device before one download of the maps.

Checkpoints are byte-compatible with the JAX engine's: they hold the raw
planar u8 tail of the last T frames, and the ring is rebuilt from it after a
load by running the kernel over the tail with inert flags and seed 1.

Not in this slice: the tail protocol (``ring_carry=False``),
``packed_wire``, ``downscale`` and the planar upload layout; each raises
``NotImplementedError``.
"""

from __future__ import annotations

import collections
from typing import Deque, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..errors import DeviceError
from ..properties import DiPsProperties, OutputMode
from ..ops import cuda_fused, reference
from ..ops.reference import NUM_STATS, pad_geometry

_RAW_MODES = (OutputMode.ABSDIFF, OutputMode.THRESHOLD,
              OutputMode.STATS_ONLY)
#: pinned upload buffers kept per engine on a card (one can be filling
#: while the previous one is still being copied)
_PINNED_BUFFERS = 2


def resolve_device(device) -> torch.device:
    """``None`` -> the first card when one is present, else the CPU; an
    explicit CUDA device without a card raises."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceError(f"device {device!r} requested but torch sees "
                              f"no CUDA device")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise DeviceError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


class DiPsEngine:
    """Stateful streaming engine: feed uint8 (H, W, 3) frames, get diff maps
    and per-frame statistics.

    Args:
      props: pipeline configuration.
      height, width: true frame geometry.
      batch: frames per kernel launch (B).
      device: "cuda", "cuda:N", "cpu" or None (the card when present).  On
        the CPU the kernels' plain PyTorch twins run.
      input_layout: "hwc" (RGB frames) or "hwc_bgr" (cv2's BGR order,
        swapped on the device in the same copy).
      ring_carry, packed_wire, downscale: accepted for signature parity
        with the JAX engine; only the defaults are ported.
    """

    def __init__(self, props: DiPsProperties, height: int, width: int,
                 batch: int = 8, device=None, input_layout: str = "hwc",
                 ring_carry: bool = True, packed_wire: bool = False,
                 downscale: int = 1):
        if height <= 0 or width <= 0:
            raise ValueError(f"bad geometry {height}x{width}")
        if batch < 1:
            raise ValueError("batch must be >= 1")
        if not ring_carry:
            raise NotImplementedError(
                "the tail protocol (ring_carry=False) is not ported: the "
                "port runs the ring-carry protocol only")
        if packed_wire:
            raise NotImplementedError("packed_wire is not ported yet")
        if int(downscale) != 1:
            raise NotImplementedError("downscale is not ported yet")
        self.props = props
        self.height, self.width = int(height), int(width)
        props.roi_bounds(self.height, self.width)  # fail early on a bad roi
        self.hp, self.wp = pad_geometry(self.height, self.width)
        self.batch = int(batch)
        self.device = resolve_device(device)
        self.input_layout = input_layout
        self._swap_rb, self._prep = reference.make_layout_prep(
            input_layout, self.height, self.width, self.hp, self.wp)
        self._raw_mode = props.output in _RAW_MODES
        # planar device batch: the padding stays zero, only the true
        # region is rewritten per batch
        self._planar = torch.zeros((self.batch, 3, self.hp, self.wp),
                                   dtype=torch.uint8, device=self.device)
        self._pinned: List[Tuple[torch.Tensor, np.ndarray, list]] = []
        self._pinned_next = 0
        if self.device.type == "cuda":
            for _ in range(_PINNED_BUFFERS):
                t = torch.empty((self.batch, self.height, self.width, 3),
                                dtype=torch.uint8, pin_memory=True)
                self._pinned.append((t, t.numpy(), [None]))
        self.reset()

    # -- state ------------------------------------------------------------
    def _zeros(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def reset(self) -> None:
        """Clear all streaming state (cursor, tail, ring, baseline,
        heatmap)."""
        t = self.props.temporal_size
        self.frame_index = 0
        # entries are planar (3, Hp, Wp) frames, or (H, W, 3) frames in the
        # input layout, planarized only when a checkpoint asks for them
        self._tail: Deque[np.ndarray] = collections.deque(maxlen=t)
        plane = (self.hp, self.wp)
        if self._raw_mode:
            self._baseline = self._zeros((3,) + plane, torch.uint8)
        else:
            self._baseline = self._zeros(plane, torch.float32)
        self._heatmap = self._zeros(plane, torch.float32)
        self._ring_off = 0
        self._seeded = False
        self._force_snapshot = False
        self._ring = None
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
        frames = [f if f.shape == (3, self.hp, self.wp)
                  else reference.planarize_host(f, self.hp, self.wp,
                                                swap_rb=self._swap_rb)
                  for f in self._tail]
        return np.stack(frames)

    # -- core ---------------------------------------------------------------
    def _empty_result(self):
        return (np.zeros((0, self.height, self.width,
                          self.props.out_channels), np.uint8),
                np.zeros((0, NUM_STATS), np.float32))

    def new_batch_buffer(self) -> np.ndarray:
        """A (B, H, W, 3) uint8 host buffer to fill with frames [0:n].  On a
        card it is pinned memory the upload reads directly; it may be
        handed out again once the batch dispatched from it was uploaded."""
        if not self._pinned:
            return np.empty((self.batch, self.height, self.width, 3),
                            np.uint8)
        _, arr, ev = self._pinned[self._pinned_next]
        self._pinned_next = (self._pinned_next + 1) % len(self._pinned)
        if ev[0] is not None:
            ev[0].synchronize()
            ev[0] = None
        return arr

    def process_batch(self, frames: Sequence[np.ndarray]
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Process up to ``batch`` (H, W, 3) uint8 frames; returns (outputs
        uint8 (n, H, W, C), stats float32 (n, 4))."""
        n = len(frames)
        if n == 0:
            return self._empty_result()
        if n > self.batch:
            raise ValueError(f"got {n} frames > batch {self.batch}")
        buf = self.new_batch_buffer()
        for i, f in enumerate(frames):
            if f.shape != (self.height, self.width, 3):
                raise ValueError(f"frame shape {f.shape} != "
                                 f"{(self.height, self.width, 3)}")
            buf[i] = f
        return self.collect(self.dispatch_async(buf, n))

    def dispatch_async(self, buf: np.ndarray, n: int):
        """Upload and launch one batch without waiting for its results;
        returns a handle for :meth:`collect`.  State (cursor, tail, ring)
        advances at dispatch, so calls must stay ordered."""
        t = self.props.temporal_size
        b = self.batch
        if n < 1 or n > b:
            raise ValueError(f"n={n} outside 1..{b}")
        if buf.shape != (b, self.height, self.width, 3) or \
                buf.dtype != np.uint8:
            raise ValueError(f"batch buffer {buf.shape} {buf.dtype} != "
                             f"{(b, self.height, self.width, 3)} uint8")
        if not self._tail:  # first batch: the tail starts as T x frame 0
            self._tail.extend([buf[0].copy()] * t)
        self._tail.extend(buf[i].copy() for i in range(max(0, n - t), n))

        flags = np.zeros((b,), np.bool_)
        valid = np.zeros((b,), np.bool_)
        valid[:n] = True
        for i in range(n):
            flags[i] = self._is_capture(self.frame_index + i)
        if self._force_snapshot:
            flags[0] = True
            self._force_snapshot = False

        src = torch.from_numpy(buf)[:n]
        if self.device.type == "cuda":
            src = src.to(self.device, non_blocking=True)
            for _, arr, ev in self._pinned:
                if arr.ctypes.data == buf.ctypes.data:
                    ev[0] = torch.cuda.Event()
                    ev[0].record()
        raw = self._planar
        self._prep(src, out=raw[:n])
        if n < b:  # padding replicas of the last frame; state ignores them
            raw[n:] = raw[n - 1]
        seed = 0 if self._seeded else 1
        flags_d = torch.from_numpy(flags).to(self.device)
        valid_d = torch.from_numpy(valid).to(self.device)
        if self._raw_mode:
            out, stats, *_ = cuda_fused.absdiff_step_ring(
                self.props, self.height, self.width, raw, self._prev,
                self._baseline, flags_d, self._heatmap, valid_d, seed)
        else:
            out, stats, *_ = cuda_fused.batch_step_ring(
                self.props, self.height, self.width, raw, self._ring,
                self._prev, self._baseline, flags_d, self._heatmap, valid_d,
                self._ring_off, seed)
        self._ring_off = (self._ring_off + n) % t
        self._seeded = True
        self.frame_index += n
        # crop + interleave on the device: one download per batch
        if out.shape[1]:
            out = out[:n, :, :self.height, :self.width].permute(0, 2, 3, 1)
            out = out.contiguous()
        return out, stats[:n], n

    def collect(self, handle) -> Tuple[np.ndarray, np.ndarray]:
        """Download a :meth:`dispatch_async` handle: (outputs uint8
        (n, H, W, C), stats float32 (n, 4))."""
        out, stats, n = handle
        stats_np = stats.cpu().numpy()
        if out.dim() == 4 and out.shape[1] == 0:  # no maps: stats only
            return np.empty((n, self.height, self.width, 0), np.uint8), \
                stats_np
        return out.cpu().numpy(), stats_np

    def process_frames(self, frames: Sequence[np.ndarray]
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Process any number of frames, batching internally."""
        if len(frames) == 0:
            return self._empty_result()
        outs, stats = [], []
        for i in range(0, len(frames), self.batch):
            o, s = self.process_batch(frames[i:i + self.batch])
            outs.append(o)
            stats.append(s)
        return np.concatenate(outs), np.concatenate(stats)

    # -- checkpoint / resume -------------------------------------------------
    def state_dict(self) -> dict:
        """Streaming state in the JAX engine's format: frame cursor,
        baseline, raw planar tail (T, 3, Hp, Wp) u8, heatmap."""
        return {
            "frame_index": self.frame_index,
            "baseline": self._baseline.cpu().numpy(),
            "tail": self._planar_tail(),
            "heatmap": self._heatmap.cpu().numpy(),
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
        self._baseline = torch.from_numpy(
            np.ascontiguousarray(bl, dtype=np.uint8 if self._raw_mode
                                 else np.float32)).to(self.device)
        self._tail.clear()
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
            self._tail.extend(tl)
        if state.get("heatmap") is not None:
            self._heatmap = torch.from_numpy(np.ascontiguousarray(
                state["heatmap"], dtype=np.float32)).to(self.device)
        # a snapshot requested before the restore must not fire after it
        self._force_snapshot = False
        self._rebuild_ring_state()

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
