"""Post-analysis ops: temporal DFT, FFT denoise and the streaming per-pixel
flicker analyzers, in PyTorch.

Counterpart of ``dips_tpu/ops/analysis.py``, with its names and signatures
plus ``device=``.  The JAX module reaches no Pallas kernel: its FFTs are
``jnp.fft`` and its flicker update a ``lax.scan`` that XLA fuses.  Here the
FFTs are ``torch.fft`` (cuFFT on a card) and the flicker update is a loop
of plain elementwise torch ops over the frames of a dispatch, its three
(H, W) or (S, H, W) float32 planes kept on the device between dispatches.

Numerics the fleet's bit-identity with the single-stream analyzer rests on:

* one step function serves both analyzers, each operation its own torch
  op (no ``addcmul``, ``lerp`` or compilation that could contract a
  multiply and an add into one rounding);
* every per-frame scalar (``alpha``, cos, sin, the bias denominator) is a
  float32 tensor on the analyzer's device, never a Python float: a CPU
  scalar divisor makes CUDA's division multiply by the reciprocal;
* the host bookkeeping (demodulation phase, ``alpha**n`` denominators) is
  float64 cast to float32 once, and the readout stays host numpy with a
  Python-float bias correction, as in the JAX module.

Array arguments of the functions may be torch tensors, which are computed
on where they lie, or array-likes, which go to ``device`` ("cuda" unless
the caller asks for the CPU; without a card that raises
:class:`~dips_tpu_torch.errors.DeviceError`).  A tensor on another device
than the ``device`` asked for raises ``ValueError``: nothing moves silently.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.pipeline import resolve_device
from ..properties import ChromaFilter

DEFAULT_DENOISE_RADIUS = 75  # ref: image_denoise.py:22


def _as_tensor(x, device) -> torch.Tensor:
    """``x`` as a tensor: a tensor stays where it lies (and must lie on
    ``device`` when one is named); anything else goes to ``device``."""
    if isinstance(x, torch.Tensor):
        if device is not None and x.device != resolve_device(device):
            raise ValueError(f"tensor on {x.device}, but device={device!r} "
                             f"was asked for")
        return x
    return torch.from_numpy(np.array(x)).to(resolve_device(device))


def temporal_dft(traces, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real DFT over the leading (time) axis.

    Args: traces (N, ...) — e.g. a pixel-intensity history or the
      per-frame statistics series; computed in float32.
    Returns: (magnitude (N//2+1, ...), phase (N//2+1, ...)) float32.
    """
    f = torch.fft.rfft(_as_tensor(traces, device).to(torch.float32), dim=0)
    return f.abs(), f.angle()


def _lowpass_mask(h: int, w: int, radius: int, device) -> torch.Tensor:
    """The reference's centred (2r x 2r) square, keeping shifted rows
    c-r .. c+r-1, laid out for the UNshifted spectrum:
    ``fftshift(F) * mask`` then ``ifftshift`` equals
    ``F * ifftshift(mask)`` element for element (a permutation), so the
    spectrum is never copied into shifted order."""
    dr = torch.arange(h, device=device) - h // 2
    dc = torch.arange(w, device=device) - w // 2
    rows = (dr >= -radius) & (dr < radius)
    cols = (dc >= -radius) & (dc < radius)
    return torch.fft.ifftshift(rows[:, None] & cols[None, :]).to(
        torch.complex64)


def fft_denoise(image, radius: int = DEFAULT_DENOISE_RADIUS,
                device=None) -> torch.Tensor:
    """Square low-pass FFT denoise of a grayscale image (H, W), or of
    planes (..., H, W).

    Matches the reference recipe: fft2 -> fftshift -> keep the centered
    (2r x 2r) square -> ifft2 -> magnitude (image_denoise.py:13-30).  The
    kept square [-r, r) is not symmetric, so the filtered spectrum is not
    Hermitian: complex ``fft2`` / ``ifft2`` and ``abs``, not ``rfft2``.
    """
    img = _as_tensor(image, device).to(torch.float32)
    h, w = img.shape[-2], img.shape[-1]
    f = torch.fft.fft2(img)
    f *= _lowpass_mask(h, w, int(radius), img.device)
    return torch.fft.ifft2(f).abs()


def fft_magnitude_spectrum(image, device=None) -> torch.Tensor:
    """20*log(|fftshift(fft2(img))| + 1), the spectrum view the reference
    plots (image_denoise.py:16)."""
    f = torch.fft.fftshift(
        torch.fft.fft2(_as_tensor(image, device).to(torch.float32)),
        dim=(-2, -1))
    return 20.0 * torch.log(f.abs() + 1.0)


def denoise_frames(frames_u8, radius: int, device=None) -> torch.Tensor:
    """Batched FFT low-pass denoise of uint8 frames (N, H, W, C) -> uint8.

    The streaming-pipeline integration of :func:`fft_denoise` (BASELINE
    configs[4]: "4K streaming pipeline with ... denoise post-analysis").
    One frame's C planes at a time: a 4K batch of 16 at once would hold 48
    complex64 planes (3.2 GB) and the transform's workspace.
    """
    frames = _as_tensor(frames_u8, device)
    out = torch.empty_like(frames, dtype=torch.uint8)
    for i in range(frames.shape[0]):
        planes = frames[i].to(torch.float32).permute(2, 0, 1)  # (C, H, W)
        den = fft_denoise(planes, radius).permute(1, 2, 0)
        out[i] = torch.round(den).clamp_(0, 255).to(torch.uint8)
    return out


# ---------------------------------------------------------------------------
# the streaming flicker analyzers
# ---------------------------------------------------------------------------

def _intensity(frames_u8: torch.Tensor, chroma: ChromaFilter
               ) -> torch.Tensor:
    """uint8 RGB (..., 3) -> float32 (...) on the [0, 510] integer scale:
    2x one channel, or HSL lightness max + min (exact in float32)."""
    if chroma == ChromaFilter.RED:
        return frames_u8[..., 0].to(torch.float32) * 2
    if chroma == ChromaFilter.GREEN:
        return frames_u8[..., 1].to(torch.float32) * 2
    if chroma == ChromaFilter.BLUE:
        return frames_u8[..., 2].to(torch.float32) * 2
    return (frames_u8.amax(dim=-1).to(torch.float32)
            + frames_u8.amin(dim=-1).to(torch.float32))


def _flicker_step(state, x, a, k, c, s, denom):
    """One frame of the single-bin demodulator, broadcast over whatever
    leading stream axis the planes have: track and remove the running mean
    (bias-corrected by ``denom``), then demodulate by e^{-i*phase} and
    low-pass.  The same op sequence as the JAX scan body."""
    zr, zi, m = state
    m = a * m + k * x
    centered = x - m / denom
    kc = k * centered
    return a * zr + kc * c, a * zi - kc * s, m


def _flicker_update(chroma_value: int, state, frames_u8: torch.Tensor,
                    coeffs: torch.Tensor, alpha: torch.Tensor):
    """N frames through the demodulator, one step each.

    ``state`` = (zr, zi, m) (H, W) float32 planes; ``frames_u8``
    (N, H, W, 3) uint8 RGB; ``coeffs`` (3, N) float32 — cos(phase_j),
    sin(phase_j) and the mean's bias denominator ``1 - alpha**(n_j+1)``;
    ``alpha`` the float32 EWMA decay; all on one device."""
    chroma = ChromaFilter(chroma_value)
    k = 1.0 - alpha
    for j in range(frames_u8.shape[0]):
        state = _flicker_step(state, _intensity(frames_u8[j], chroma), alpha,
                              k, coeffs[0, j], coeffs[1, j], coeffs[2, j])
    return state


class FlickerAnalyzer:
    """Streaming per-pixel temporal-frequency energy map ("flicker map").

    Answers "which pixels oscillate at ``freq_hz``?" — vibration, mains
    flicker, blinking indicators — over an unbounded frame stream with O(1)
    memory: per pixel it carries a running mean (the DC estimate, removed
    first so static brightness cannot read as flicker) and one complex
    exponentially-weighted single-bin Fourier coefficient (demodulate the
    centered signal at the target frequency, low-pass with time constant
    ``tau_frames``).

    Intensity follows the pipeline's chroma semantics (HSL lightness on the
    [0, 510] integer scale, or 2x a single channel), so ``amplitude()`` is
    in those units: a pixel whose intensity trace is
    ``A*cos(2*pi*freq_hz*t)`` reads ``~A`` once ``2*tau_frames`` frames
    have streamed.  Frames are buffered on the host and dispatched in
    ``batch``-frame steps (flushed remainders frame by frame); the three
    planes stay on ``device`` ("cuda" unless the caller asks for "cpu";
    without a card :class:`~dips_tpu_torch.errors.DeviceError`).  The
    scalar bookkeeping (demodulation phase, ``alpha**n`` startup bias) is
    float64 on the host: drift-free over unbounded streams.
    """

    def __init__(self, freq_hz: float, fps: float,
                 tau_frames: Optional[float] = None,
                 chroma=None, batch: int = 16, device="cuda"):
        if not (math.isfinite(fps) and fps > 0):
            raise ValueError(f"fps must be positive, got {fps!r}")
        if not 0 < freq_hz < fps / 2:
            raise ValueError(
                f"freq_hz must lie in (0, fps/2) = (0, {fps / 2:g}) to be "
                f"resolvable at {fps:g} fps, got {freq_hz!r}")
        if tau_frames is None:
            # low-pass bandwidth well under the target frequency, so the
            # DC term (demodulated, it spins at -freq) averages out; floor
            # keeps very high frequencies from degenerating to tau ~ 1
            tau_frames = max(16.0, 4.0 * fps / freq_hz)
        if not (math.isfinite(tau_frames) and tau_frames >= 2.0):
            raise ValueError(
                f"tau_frames must be finite and >= 2, got {tau_frames!r}")
        self.device = resolve_device(device)
        self.freq_hz = float(freq_hz)
        self.fps = float(fps)
        self.tau_frames = float(tau_frames)
        self.chroma = ChromaFilter.ALL if chroma is None else chroma
        self.batch = max(1, int(batch))
        self._omega = 2.0 * math.pi * self.freq_hz / self.fps
        self._alpha = math.exp(-1.0 / self.tau_frames)  # float64, host
        self._alpha_dev = torch.tensor(np.float32(self._alpha),
                                       dtype=torch.float32,
                                       device=self.device)
        self._state = None          # lazy: sized from the first frame
        self._geometry: Optional[Tuple[int, int]] = None
        self._pending: list = []
        self.frames_seen = 0

    def _init_state(self, h: int, w: int) -> None:
        self._state = tuple(torch.zeros((h, w), dtype=torch.float32,
                                        device=self.device)
                            for _ in range(3))

    def _coefficients(self, n: int):
        """Per-frame inputs for an ``n``-frame dispatch starting at
        absolute frame ``frames_seen``, computed host-side in float64:
        demodulation phase cos/sin (float64 with modular reduction —
        bounded rounding error, no cumulative drift) and the running
        mean's startup-bias denominator ``1 - alpha**(q+1)``, clamped away
        from zero so a tau at the float boundary (alpha == 1.0) yields
        zero flicker instead of 0/0 NaN planes."""
        a, w = self._alpha, self._omega
        n0 = self.frames_seen
        j = np.arange(n, dtype=np.float64)
        phase = math.fmod(w * n0, 2.0 * math.pi) + w * j
        denom = np.maximum(1.0 - a ** (n0 + j + 1.0), 1e-12)
        return np.stack([np.cos(phase), np.sin(phase),
                         denom]).astype(np.float32)

    def _dispatch(self, arr: np.ndarray) -> None:
        if self._state is None:
            self._init_state(*self._geometry)
        coeffs = torch.from_numpy(self._coefficients(arr.shape[0]))
        # synchronous uploads: the host arrays may be reused on return
        self._state = _flicker_update(self.chroma.value, self._state,
                                      torch.from_numpy(arr).to(self.device),
                                      coeffs.to(self.device),
                                      self._alpha_dev)
        self.frames_seen += arr.shape[0]

    def update(self, frames: np.ndarray) -> None:
        """Feed frames: uint8 RGB, (H, W, 3) or (N, H, W, 3)."""
        frames = np.asarray(frames)
        if frames.ndim == 3:
            frames = frames[None]
        if frames.ndim != 4 or frames.shape[-1] != 3 \
                or frames.dtype != np.uint8:
            raise ValueError("expected uint8 RGB (N, H, W, 3) or (H, W, 3), "
                             f"got {frames.dtype} {frames.shape}")
        if self._geometry is None:
            # the first frame fixes the geometry, even before a dispatch:
            # a mixed buffer would otherwise surface as np.stack's generic
            # shape error AFTER dropping the already-popped chunk
            self._geometry = (frames.shape[1], frames.shape[2])
        if frames.shape[1:3] != self._geometry:
            raise ValueError(f"frame geometry {frames.shape[1:3]} != "
                             f"analyzer geometry {self._geometry}")
        self._pending.extend(frames)
        while len(self._pending) >= self.batch:
            chunk, self._pending = (self._pending[:self.batch],
                                    self._pending[self.batch:])
            self._dispatch(np.stack(chunk))

    def flush(self) -> None:
        """Dispatch any buffered partial batch, frame by frame, as the JAX
        analyzer does: ``frames_seen`` and the maps do not depend on how
        the frames were batched."""
        chunk, self._pending = self._pending, []
        for frame in chunk:
            self._dispatch(np.stack([frame]))

    def power(self) -> np.ndarray:
        """(H, W) f32: startup-bias-corrected squared oscillation amplitude
        at ``freq_hz``, in intensity units — ``~A**2`` for a pixel trace
        ``A*cos(2*pi*freq_hz*t + phi)``."""
        self.flush()
        if self._state is None:
            raise RuntimeError("no frames streamed yet")
        zr, zi, _ = self._state
        # EWMA startup-bias correction: with n frames seen the accumulator
        # has only (1 - alpha**n) of its steady-state weight
        corr = max(1e-12, 1.0 - self._alpha ** self.frames_seen)
        z2 = zr.cpu().numpy() ** 2 + zi.cpu().numpy() ** 2
        return 4.0 * z2 / (corr * corr)

    def amplitude(self) -> np.ndarray:
        """(H, W) f32 oscillation amplitude at ``freq_hz`` (see power())."""
        return np.sqrt(self.power())

    def reset(self) -> None:
        self._pending = []
        self.frames_seen = 0
        if self._geometry is not None:
            self._init_state(*self._geometry)


def _flicker_update_fleet(chroma_value: int, state, frames_u8: torch.Tensor,
                          coeffs: torch.Tensor, gates: torch.Tensor,
                          alpha: torch.Tensor):
    """Fleet twin of :func:`_flicker_update`: S streams' planes stepped
    together.

    ``state`` = (zr, zi, m), each (S, H, W) float32; ``frames_u8``
    (N, S, H, W, 3) uint8; ``coeffs`` (3, N, S) float32 (cos, sin, bias
    denominator per frame and stream: streams advance on their own
    cursors); ``gates`` (N, S) bool — False marks a padding cell, whose
    stream's planes stay untouched; ``alpha`` (S,) float32 per-stream
    decay.  Per live stream the arithmetic is :func:`_flicker_step`'s, as
    in the single-stream update, so the maps are bit-identical."""
    chroma = ChromaFilter(chroma_value)
    a3 = alpha[:, None, None]
    k3 = 1.0 - a3
    for j in range(frames_u8.shape[0]):
        c, s, denom = (coeffs[i, j][:, None, None] for i in range(3))
        new = _flicker_step(state, _intensity(frames_u8[j], chroma), a3, k3,
                            c, s, denom)
        live = gates[j][:, None, None]
        state = tuple(torch.where(live, p_new, p)
                      for p_new, p in zip(new, state))
    return state


class FleetFlickerAnalyzer:
    """Per-stream flicker maps for a whole fleet, updated together.

    :class:`FlickerAnalyzer` carries one stream's demodulator planes; this
    class stacks S streams' planes as (S, H, W) on ``device`` and steps
    them all in one pass per frame, with per-stream frequency/fps/tau,
    independent frame cursors (staggered starts, stalls) and per-frame
    validity gating — maps are bit-identical to per-stream analyzers.

    Streams start unconfigured; :meth:`configure` arms one (or
    :meth:`configure_all` all of them).  :meth:`update` takes the same
    ragged per-stream RGB frame lists the multi-stream engine consumes.
    """

    def __init__(self, n_streams: int, chroma=None, device="cuda"):
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        self.device = resolve_device(device)
        self.n_streams = int(n_streams)
        self.chroma = ChromaFilter.ALL if chroma is None else chroma
        self._enabled = [False] * self.n_streams
        self._freq = np.zeros(self.n_streams, np.float64)
        self._fps = np.zeros(self.n_streams, np.float64)
        self._omega = np.zeros(self.n_streams, np.float64)
        self._alpha = np.ones(self.n_streams, np.float64)  # inert until
        self._tau = np.zeros(self.n_streams, np.float64)   # configured
        self.frames_seen = [0] * self.n_streams
        self._geometry: Optional[Tuple[int, int]] = None
        self._state = None
        self._staging: dict = {}   # round length n -> reusable host buffer

    # -- configuration ------------------------------------------------------
    def configure(self, stream: int, freq_hz: float, fps: float,
                  tau_frames: Optional[float] = None) -> None:
        """Arm one stream's analyzer (validation mirrors FlickerAnalyzer);
        re-configuring an armed stream resets its window."""
        if not (math.isfinite(fps) and fps > 0):
            raise ValueError(f"fps must be positive, got {fps!r}")
        if not 0 < freq_hz < fps / 2:
            raise ValueError(
                f"freq_hz must lie in (0, fps/2) = (0, {fps / 2:g}) to be "
                f"resolvable at {fps:g} fps, got {freq_hz!r}")
        if tau_frames is None:
            tau_frames = max(16.0, 4.0 * fps / freq_hz)
        if not (math.isfinite(tau_frames) and tau_frames >= 2.0):
            raise ValueError(
                f"tau_frames must be finite and >= 2, got {tau_frames!r}")
        self._freq[stream] = freq_hz
        self._fps[stream] = fps
        self._tau[stream] = tau_frames
        self._omega[stream] = 2.0 * math.pi * freq_hz / fps
        self._alpha[stream] = math.exp(-1.0 / tau_frames)
        self._enabled[stream] = True
        self.reset_stream(stream)

    def configure_all(self, freq_hz: float, fps: float,
                      tau_frames: Optional[float] = None) -> None:
        for si in range(self.n_streams):
            self.configure(si, freq_hz, fps, tau_frames)

    def config(self, stream: int) -> "Tuple[float, float, float] | None":
        """(freq_hz, fps, tau_frames) of an armed stream, else None."""
        if not self._enabled[stream]:
            return None
        return (float(self._freq[stream]), float(self._fps[stream]),
                float(self._tau[stream]))

    def reset_stream(self, stream: int) -> None:
        self.frames_seen[stream] = 0
        if self._state is not None:
            for p in self._state:
                p[stream] = 0.0

    def disable(self, stream: int) -> None:
        self._enabled[stream] = False
        self.reset_stream(stream)

    # -- streaming ----------------------------------------------------------
    def _init_state(self, h: int, w: int) -> None:
        s = self.n_streams
        self._state = tuple(torch.zeros((s, h, w), dtype=torch.float32,
                                        device=self.device)
                            for _ in range(3))

    def update(self, frames_per_stream) -> None:
        """Feed one fleet round: a sequence of S per-stream frame lists
        (uint8 RGB (H, W, 3) each; empty/short lists allowed — ragged
        tails are gated off).  Unconfigured streams' frames are ignored."""
        if len(frames_per_stream) != self.n_streams:
            raise ValueError(f"expected {self.n_streams} streams, got "
                             f"{len(frames_per_stream)}")
        counts = [len(f) if self._enabled[si] else 0
                  for si, f in enumerate(frames_per_stream)]
        n = max(counts, default=0)
        if n == 0:
            return
        for si, frames in enumerate(frames_per_stream):
            for f in frames:
                f = np.asarray(f)
                if f.ndim != 3 or f.shape[-1] != 3 or f.dtype != np.uint8:
                    raise ValueError(
                        f"stream {si}: expected uint8 RGB (H, W, 3), got "
                        f"{f.dtype} {f.shape}")
                if self._geometry is None:
                    self._geometry = f.shape[:2]
                if f.shape[:2] != self._geometry:
                    raise ValueError(
                        f"stream {si}: frame geometry {f.shape[:2]} != "
                        f"fleet geometry {self._geometry}")
        if self._state is None:
            self._init_state(*self._geometry)
        h, w = self._geometry
        s = self.n_streams
        # one staging buffer per round length n, reused: the upload below
        # is synchronous, so no pending copy can still be reading it when
        # the next round refills it.  Cells this round does not fill keep
        # stale bytes; they are gated off.
        stacked = self._staging.get(n)
        if stacked is None:
            stacked = self._staging[n] = np.empty((n, s, h, w, 3),
                                                  np.uint8)
        gates = np.zeros((n, s), np.bool_)
        coeffs = np.zeros((3, n, s), np.float32)
        j = np.arange(n, dtype=np.float64)
        for si in range(s):
            n_si = counts[si]
            if n_si == 0:
                continue
            for k in range(n_si):
                stacked[k, si] = frames_per_stream[si][k]
            gates[:n_si, si] = True
            a, om, n0 = (self._alpha[si], self._omega[si],
                         self.frames_seen[si])
            phase = math.fmod(om * n0, 2.0 * math.pi) + om * j
            denom = np.maximum(1.0 - a ** (n0 + j + 1.0), 1e-12)
            coeffs[0, :, si] = np.cos(phase)
            coeffs[1, :, si] = np.sin(phase)
            coeffs[2, :, si] = denom
            self.frames_seen[si] += n_si
        dev = self.device
        self._state = _flicker_update_fleet(
            self.chroma.value, self._state,
            torch.from_numpy(stacked).to(dev), torch.from_numpy(coeffs).to(dev),
            torch.from_numpy(gates).to(dev),
            torch.from_numpy(self._alpha.astype(np.float32)).to(dev))

    # -- readout ------------------------------------------------------------
    def power(self, stream: int) -> np.ndarray:
        """(H, W) f32 squared oscillation amplitude for one stream (same
        startup-bias correction as FlickerAnalyzer.power)."""
        if not self._enabled[stream]:
            raise RuntimeError(f"stream {stream} has no flicker analyzer "
                               f"(configure it first)")
        if self._state is None or self.frames_seen[stream] == 0:
            raise RuntimeError(f"stream {stream}: no frames streamed yet")
        zr, zi, _ = self._state
        # python float, not np.float64: NEP-50 would promote the f32
        # planes to float64 and break bit-identity with FlickerAnalyzer
        corr = float(max(
            1e-12, 1.0 - self._alpha[stream] ** self.frames_seen[stream]))
        z2 = zr[stream].cpu().numpy() ** 2 + zi[stream].cpu().numpy() ** 2
        return 4.0 * z2 / (corr * corr)

    def amplitude(self, stream: int) -> np.ndarray:
        return np.sqrt(self.power(stream))

    def amplitudes(self) -> np.ndarray:
        """(S, H, W) f32 amplitude maps (zero planes for unarmed/fresh
        streams)."""
        if self._state is None or self._geometry is None:
            raise RuntimeError("no frames streamed yet")
        h, w = self._geometry
        out = np.zeros((self.n_streams, h, w), np.float32)
        for si in range(self.n_streams):
            if self._enabled[si] and self.frames_seen[si]:
                out[si] = self.amplitude(si)
        return out
