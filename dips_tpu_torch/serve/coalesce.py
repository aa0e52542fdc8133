"""Stacked-stream request coalescing: many serving sessions, one device
dispatch (the measured 2x aggregate-throughput path).

Counterpart of ``dips_tpu/serve/coalesce.py``: the slots live on the port's
:class:`~dips_tpu_torch.parallel.MultiStreamEngine`, whose stacked ring
kernel takes every pending session's frames in one launch.  The mesh names
the server's device: "cuda" spreads the cells over the visible cards (as
the JAX coalescer spreads them over its chips), a named device ("cuda:0",
"cpu") puts every cell on that one device."""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional, Tuple

import numpy as np

from ..ops.reference import NUM_STATS
from ..properties import DiPsProperties

log = logging.getLogger("dips_tpu.serve")


class StreamCoalescer:
    """Shares ONE stacked-stream device step across serving sessions.

    Per-session ``DiPsEngine``\\ s dispatch one kernel per request; at many
    cameras the per-dispatch overhead dominates.  This dispatcher instead
    binds each session to a stream slot of a single
    :class:`~dips_tpu_torch.parallel.MultiStreamEngine` and folds concurrently
    pending requests into ONE stacked kernel launch (the measured 2x
    aggregate-throughput path, BASELINE.md multi-stream table) — per-slot
    baseline/ring/cursor state stays private, idle slots ride along masked
    invalid.  Requests wait at most ``window_ms`` for co-tenants before the
    batch dispatches.
    """

    def __init__(self, props: DiPsProperties, height: int, width: int,
                 n_streams: int, batch: int = 1, device="cuda",
                 window_ms: float = 2.0, n_devices: int = 1,
                 mesh_shape: Optional[Tuple[int, int]] = None,
                 input_layout: str = "planar", downscale: int = 1):
        from ..models.pipeline import resolve_device
        from ..parallel import MultiStreamEngine, stream_mesh
        dev = resolve_device(device)
        # "cuda": the visible cards; a named device: every cell on it
        one = None if device is None or str(device) == "cuda" else dev
        if mesh_shape is not None:
            # (S, R) 2-D grid: each device owns a horizontal slab of a
            # subset of slots — the BIG-FRAME serving shape (an 8K camera
            # whose per-card line rate is the bottleneck gets R-way row
            # sharding; on a card the padded height must 8-row-align by R
            # for the slab kernels).  Overrides n_devices.
            from ..parallel.grid2d import grid_mesh
            s_ax, r_ax = (int(v) for v in mesh_shape)
            mesh = grid_mesh(s_ax, r_ax, devices=(
                None if one is None else [one] * (s_ax * r_ax)))
        else:
            # slots shard over the first n_devices cards; the default
            # 1-device mesh serves a whole camera fleet from one card
            n = max(1, int(n_devices))
            mesh = stream_mesh(n, devices=None if one is None
                               else [one] * n)
        self.engine = MultiStreamEngine(props, height, width,
                                        n_streams=n_streams, batch=batch,
                                        device=dev, mesh=mesh,
                                        input_layout=input_layout,
                                        downscale=downscale)
        self.n_streams = int(n_streams)
        self.window_s = window_ms / 1e3
        self._cv = threading.Condition()
        self._elock = threading.Lock()  # serialises engine state access
        self._free = list(range(n_streams - 1, -1, -1))
        self._bound: set = set()
        self._pending: dict = {}   # slot -> frames awaiting dispatch
        self._results: dict = {}   # slot -> (outs, stats) | Exception
        #: observability: device dispatches and total frames folded into
        #: them (mean fill = how well requests coalesce; guarded by _cv)
        self.dispatches = 0
        self.frames_folded = 0
        #: fleet flicker (ops/analysis.FleetFlickerAnalyzer): ONE stacked
        #: scan dispatch updates every armed slot's demodulator planes per
        #: coalesced batch — per-session FlickerAnalyzers would pay one
        #: device dispatch per session per request.  Lazily created on the
        #: first bind; guarded by _elock like the engine.
        self._fleet_flicker = None
        self._stopped = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def bind(self) -> int:
        with self._cv:
            if not self._free:
                raise RuntimeError("no free stream slots")
            slot = self._free.pop()
            self._bound.add(slot)
            return slot

    def rebind(self, slot: int) -> None:
        """Resume a parked (named-session) slot."""
        with self._cv:
            self._bound.add(slot)

    def release(self, slot: int, park: bool = False) -> None:
        """End a session.  ``park`` keeps the slot's state for a named-token
        resume (the slot stays allocated); otherwise the slot is reset and
        returned to the free list."""
        with self._cv:
            self._bound.discard(slot)
            if not park:
                with self._elock:
                    self.engine.reset_stream(slot)
                    if self._fleet_flicker is not None:
                        self._fleet_flicker.disable(slot)
                self._free.append(slot)

    # -- per-slot flicker (fleet analyzer, one dispatch per batch) ---------
    def bind_flicker(self, slot: int, freq_hz: float, fps: float) -> None:
        """Arm (or resume) a slot's flicker analysis.  Rebinding with the
        SAME (freq, fps) keeps the accumulated window (session resume);
        a different configuration raises, mirroring the per-session
        analyzer's contract (serve/analytics._bind_flicker)."""
        with self._elock:
            if self._fleet_flicker is None:
                from ..ops.analysis import FleetFlickerAnalyzer
                self._fleet_flicker = FleetFlickerAnalyzer(
                    self.n_streams, device=self.engine.device)
            old = self._fleet_flicker.config(slot)
            if old is not None:
                if (old[0], old[1]) != (float(freq_hz), float(fps)):
                    raise ValueError(
                        f"session already analyzes {old[0]:g} Hz @ "
                        f"{old[1]:g} fps; reset it before binding "
                        f"{float(freq_hz):g} Hz @ {float(fps):g} fps")
                return  # resume keeps the accumulated window
            self._fleet_flicker.configure(slot, float(freq_hz), float(fps))

    def flicker_state(self, slot: int):
        """(amplitude map, freq_hz, frames_seen) for an armed slot."""
        with self._elock:
            fl = self._fleet_flicker
            if fl is None or fl.config(slot) is None:
                raise ValueError("slot has no flicker analyzer")
            return (fl.amplitude(slot), fl.config(slot)[0],
                    fl.frames_seen[slot])

    def flicker_frames_seen(self, slot: int) -> int:
        with self._elock:
            fl = self._fleet_flicker
            return (0 if fl is None or fl.config(slot) is None
                    else fl.frames_seen[slot])

    def unbind_flicker(self, slot: int) -> None:
        with self._elock:
            if self._fleet_flicker is not None:
                self._fleet_flicker.disable(slot)

    def submit(self, slot: int, frames) -> Tuple[np.ndarray, np.ndarray]:
        """Block until ``frames`` (<= engine.batch) have been dispatched in
        a coalesced batch; returns this slot's (maps, stats)."""
        with self._cv:
            while slot in self._pending and not self._stopped:
                self._cv.wait(0.1)  # one outstanding request per slot
            if self._stopped:
                raise RuntimeError("coalescer shut down")
            self._pending[slot] = list(frames)
            self._cv.notify_all()
            while slot not in self._results and not self._stopped:
                self._cv.wait(0.1)
            res = self._results.pop(slot, None)
        if res is None:
            raise RuntimeError("coalescer shut down")
        if isinstance(res, Exception):
            raise res
        return res

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stopped:
                    self._cv.wait(0.2)
                if self._stopped:
                    self._cv.notify_all()
                    return
                # brief window for the other live sessions' frames to land
                deadline = time.monotonic() + self.window_s
                while (len(self._pending) < len(self._bound)
                       and not self._stopped):
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(left)
                batch, self._pending = self._pending, {}
                self.dispatches += 1
                self.frames_folded += sum(len(f) for f in batch.values())
            results: dict = {}
            try:
                feeds = [batch.get(si, []) for si in range(self.n_streams)]
                with self._elock:
                    outs, stats, _ = self.engine.process_batch(feeds)
                    if self._fleet_flicker is not None:
                        # one stacked scan for every armed slot's planes;
                        # isolated slots' frames are gated off below via
                        # revive(), their flicker window just stalls
                        self._fleet_flicker.update(
                            [fd if si not in self.engine.failed else []
                             for si, fd in enumerate(feeds)])
                    for si, frames in batch.items():
                        err = self.engine.failed.get(si)
                        if err is not None:
                            # per-request isolation: surface the error to
                            # this client, let the session keep streaming
                            self.engine.revive(si)
                            results[si] = RuntimeError(str(err))
                        else:
                            k = len(frames)
                            results[si] = (outs[si, :k], stats[si, :k])
                    # the slots' views alone keep the download alive
                    del outs, stats
            except Exception as e:  # whole-batch failure -> every waiter
                results = {si: RuntimeError(str(e)) for si in batch}
            with self._cv:
                self._results.update(results)
                self._cv.notify_all()

    def snapshot(self, slot: int) -> None:
        with self._elock:
            self.engine.snapshot(slot)

    def reset_slot(self, slot: int) -> None:
        with self._elock:
            self.engine.reset_stream(slot)
            if self._fleet_flicker is not None:
                # mirrors the dedicated-engine reset (server.py sets
                # eng._flicker = None): the window restarts on next bind
                self._fleet_flicker.disable(slot)

    def heatmap(self, slot: int) -> np.ndarray:
        with self._elock:
            return self.engine.heatmaps()[slot]

    def save_slot(self, slot: int, path: str) -> None:
        with self._elock:
            self.engine.save_stream(slot, path)

    def load_slot(self, slot: int, path: str) -> None:
        with self._elock:
            self.engine.load_stream(slot, path)

    def shutdown(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._thread.join(timeout=5.0)


class _CoalescedSession:
    """Engine-shaped adapter binding one serving session to one coalescer
    stream slot (duck-types the ``DiPsEngine`` surface ``_serve_client``
    uses)."""

    packed_wire = False  # host-side packing still applies ("packed": true)

    def __init__(self, co: StreamCoalescer, slot: int):
        self._co = co
        self.slot = slot
        eng = co.engine
        self.props = eng.props
        self.height, self.width = eng.height, eng.width
        self.in_height, self.in_width = eng.in_height, eng.in_width
        self.batch, self.device = eng.batch, eng.device

    @property
    def frame_index(self) -> int:
        return self._co.engine.frame_cursors[self.slot]

    def process_frames(self, frames, packed: bool = False):
        if not len(frames):
            return (np.zeros((0, self.height, self.width,
                              self.props.out_channels), np.uint8),
                    np.zeros((0, NUM_STATS), np.float32))
        outs = stats = None
        b = self._co.engine.batch
        for i in range(0, len(frames), b):
            o, s = self._co.submit(self.slot, frames[i:i + b])
            if outs is None:
                outs = np.empty((len(frames),) + o.shape[1:], o.dtype)
                stats = np.empty((len(frames),) + s.shape[1:], s.dtype)
            outs[i:i + len(o)] = o
            stats[i:i + len(s)] = s
            # this slot's view of the fleet's download goes: the block
            # goes back to the pool once every slot has copied its own
            del o, s
        return outs, stats

    def snapshot(self) -> None:
        self._co.snapshot(self.slot)

    def reset(self) -> None:
        self._co.reset_slot(self.slot)

    def heatmap(self) -> np.ndarray:
        return self._co.heatmap(self.slot)

    def save(self, path: str) -> None:
        """Checkpoint THIS slot's streaming state — the file is
        ``DiPsEngine.save``-compatible, so a session can migrate between a
        dedicated server and a coalesced slot."""
        self._co.save_slot(self.slot, path)

    def load(self, path: str) -> None:
        self._co.load_slot(self.slot, path)

    def bind_flicker(self, freq_hz: float, fps: float) -> "_SlotFlicker":
        """Arm this slot's flicker analysis on the coalescer's FLEET
        analyzer (one stacked dispatch per batch) and return the
        FlickerAnalyzer-shaped view ``_serve_client`` reads/feeds."""
        self._co.bind_flicker(self.slot, freq_hz, fps)
        return _SlotFlicker(self._co, self.slot, float(freq_hz),
                            float(fps))


class _SlotFlicker:
    """FlickerAnalyzer-shaped view of one coalescer slot's share of the
    fleet analyzer: reads pass through; ``update`` is a NO-OP because the
    coalescer's dispatch loop already feeds every armed slot's frames in
    one stacked scan (feeding here would double-count them)."""

    def __init__(self, co: StreamCoalescer, slot: int, freq_hz: float,
                 fps: float):
        self._co = co
        self.slot = slot
        self.freq_hz = freq_hz
        self.fps = fps

    @property
    def frames_seen(self) -> int:
        return self._co.flicker_frames_seen(self.slot)

    def update(self, frames) -> None:
        pass  # fed by the coalescer's dispatch loop (see class docstring)

    def amplitude(self) -> np.ndarray:
        return self._co.flicker_state(self.slot)[0]
