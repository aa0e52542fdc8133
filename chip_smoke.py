#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one card and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA card (sm_90a,
nvcc under CUDA_HOME or /usr/local/cuda).  It builds the port's CUDA
kernels from ``dips_tpu_torch/csrc`` and then drives three paths:

* one stream, ring-carry protocol: each s = 1 ring kernel against its
  plain PyTorch twin at the main path's shapes (``[check]``),
  ``dips_tpu_torch.DiPsEngine`` end to end at 1080p (COLORIZE and ABSDIFF,
  refresh marker, snapshot, checkpoint resume; ``[main]``), and
  ``run_dips_on_file`` on a 1080p clip when cv2 is present (``[file]``);
* the fleet, ring-carry protocol: each stacked ring kernel against its
  plain twin at 1080p x 8 streams and 480p x 3 streams (mixed seeds and
  offsets, an all-invalid stream, contrasting adjacent streams;
  ``[kernels-stacked]``), ``MultiStreamEngine`` at 1080p x 8 streams
  (refresh marker, per-stream snapshot, a stream isolated by a wrong-shape
  frame and revived, checkpoint resume) held stream by stream against
  single-stream engines (``[fleet]``; the ABSDIFF fleet's checkpoint
  resume at 480p x 3 streams), and ``run_dips_on_files`` on three
  1080p clips when cv2 is present, then the same clips over a (3, 3) grid
  of cells on the card, through ``mesh=`` and through the CLI's ``--mesh
  3x3`` (``[fleet-file]``);
* the tail protocol (``ring_carry=False``): each of the four tail kernels
  against its plain twin at 1080p s = 1, 1080p x 8 and 480p x 3, with a
  flagged invalid slot (``[kernels-tail]``); the tail ``DiPsEngine`` at
  1080p against the ring engine over 64 frames in uneven batches,
  COLORIZE and ABSDIFF, OVERALL and PER_FRAME, with checkpoints crossing
  the protocols (``[tail]``); the tail fleet at 1080p x 8 against the ring
  fleet through an idle and an isolated stream, and its checkpoint resume
  at 480p x 3, COLORIZE and ABSDIFF (``[fleet-tail]``);
* the spatial-filter variants: each of the four median wrappers in
  approx_median (w3, w7) and quirk_compat (w1, w3, w5, w7) against its
  plain twin at 1080p s = 1 and 480p x 3 (``[kernels-variants]``);
* the engine options (``[options]``): a 4K ``downscale=2`` engine against
  a 1080p engine fed ``pool_frame_host`` frames (checkpoint resume
  included), a ``packed_wire`` THRESHOLD engine against the unpacked one
  and ``pack_mask_host``, a planar-layout engine against the hwc one, the
  approx w7 and quirk w5 COLORIZE engines over 64 frames with every batch
  held against the plain twins, ring and tail; the 1080p x 8 fleet with
  ``packed_wire``, and 1080p x 8 fleets with ``downscale=2`` in both
  variants, against single-stream engines;
* the box mean of a downscaled engine (``[pool]``): ``cuda_fused.pool_prep``
  (``csrc/pool_prep.cu``) against its plain twin byte for byte at 16 x 4K
  frames in, k = 2, hwc and hwc_bgr; its launches in a
  ``DiPsEngine(downscale=2)`` run of three 4K batches; the kernel and the
  plain prep timed beside the bound;

* the row-slab path (``parallel/grid2d.py``, ``rowsharded.py``): the
  ``dyn_rows`` / ``slab_bands`` forms of the three kernels against their
  plain twins at 1080p in 3 row slabs -- at s = 1 and 2, at the 4 x 360
  rows a cell of the (2, 3) grid launches (bands, the extended
  construction's 376-row sections, raw with an roi) and on the slabs of
  the 8K stream -- and slab compositions against the
  full-height kernels bit for bit -- an 8K stream (4320 x 7680) in 4 slabs
  over two carried ring batches, w5 / w7 / approx w7 / quirk w5, the tail
  protocol, the extended construction, raw ABSDIFF with an roi that one
  slab misses, two streams stacked per cell (``[kernels-slabs]``); then
  ``MultiStreamEngine(mesh=grid_mesh(2, 3, devices=["cuda:0"] * 6))`` at
  1080p x 8 streams held against the fleet without a mesh (maps and
  carried state bit for bit), with exact launch counts per cell, in both
  protocols and both slab constructions (``[grid]``);
* the post-analysis (``ops/analysis.py``: cuFFT and plain torch ops, no
  kernel of the port's own; ``[analysis]``): ``perform_dips`` on a 4K clip
  with ``denoise_radius=75``, two denoised maps a batch held against
  numpy's float64 recipe, a ``FlickerAnalyzer`` on the card fed by the
  frame callback against one on the CPU, its peak on the oscillating
  square, ``temporal_dft`` of the stats against numpy's float64 rfft; a
  ``FleetFlickerAnalyzer`` at 1080p x 8 against 8 single analyzers bit for
  bit over ragged rounds; ``run_dips_on_files(flicker=)`` on the
  ``[fleet-file]`` clips against single analyzers on the decoded frames;
  ``python -m dips_tpu_torch`` with ``--denoise --dft-json --flicker-hz``
  on the 4K clip; device times of each piece with its launches, bytes
  bound and (denoise) memory peak, and the flicker update's share of the
  4K engine's and the fleet's batch walls;

* the single-stream run mode (``[run]``), with every
  ``batch_step_ring`` / ``absdiff_step_ring`` launch of the phase held
  against its plain twin on copies of its state (the engines inside the
  CLI, ``custom_dips_on_files``, ``run_live`` and ``rebuild_engine``
  included): ``python -m dips_tpu_torch`` in this process on a 64-frame
  1080p clip (still, a moving square, a lighting flip) with
  ``--record-events --pre-roll 8 --post-roll 8 --auto-refresh 0.6:3
  --stats-json --events-json --heatmap-png --retime-vfr --profile`` (each
  segment's frame count as listed, ``events.json`` equal to
  ``detect_events`` over ``stats.json``, the re-pin at the flip, the
  output as long as the input); ``--output-mode absdiff --trace-dir`` on
  16 frames, whose Chrome trace must name the raw kernel (``--heatmap-png``
  there writes the PNG or, without matplotlib, exits 1 with the hint);
  ``--dat-dir`` over 24 ``Dat_N.d`` dumps at 273 x 640 with ``--chroma r``
  against an engine on the CPU; ``run_live`` at 1080p, B = 1, 32 frames
  with the keys ``w W t T T m o s e a`` and cv2's window calls stubbed
  (per-frame wall p50 and max); ``--thumbnail`` and ``--subsample 4``.
  The phase's launches are ``run_launches`` in the record;
* the serving slice (``dips_tpu_torch.serve``, ``loadgen``; ``[serve]``),
  servers on cuda:0 in threads of this process and clients over TCP on
  localhost, at 1080p: a dedicated COLORIZE and an ABSDIFF session (3
  requests of 16 frames, a snapshot, the heatmap) against a
  ``DiPsEngine`` bit for bit; 8 concurrent clients on a ``coalesce=8``
  server against single-stream engines, with the coalescer's metrics;
  the same clients on ``coalesce_mesh=(2, 3)`` against the server without
  a mesh, and ABSDIFF x 2 with an roi on the mesh against the engine
  (the band and ``dyn_rows`` forms); THRESHOLD ``packed_wire`` reply bytes against
  ``pack_mask_host``; a named session autosaved, the daemon shut down
  without close and restarted, the restored stream against the
  uninterrupted engine, the serving thread's autosave timed; a
  flicker-armed coalesced session against a ``FlickerAnalyzer``;
  ``python -m dips_tpu_torch.loadgen`` in a process of its own against a
  dedicated and a coalescing server, 40 requests each (frames/s, latency
  p50 / p99 / max, mean fill). The servers' own launches are counted
  (``serve_launches`` in the record);

* the ingest slice (``[ingest]``): ``native.planarize`` / ``interleave``
  against the plain twin on a 1080p frame (and timed against it);
  ``stream_dips`` on a 96-frame 1080p MJPG clip, COLORIZE w3/T4 and
  ABSDIFF, at (decode_workers, pipeline_depth) (1, 1), (4, 1), (1, 2),
  (4, 2) in the hwc layout and (4, 2) in the planar one, each run equal
  to the (1, 1) run bit for bit (indices, maps, stats, timestamps,
  inputs) and every ring launch held against its plain twin, then timed
  unheld with the stage timers; ``python -m dips_tpu_torch
  --decode-workers 4 --pipeline-depth 2 --profile`` in this process
  against the default run's video; GStreamer where its C libraries load
  (a clip written by ``GstVideoWriter`` through
  ``stream_dips(video_backend="gstreamer")`` against an engine, and
  ``perform_dips``'s timestamps read back), else a line saying why;
  ``python -m dips_tpu_torch.doctor --json`` in a process of its own.
  The phase's launches are ``ingest_launches`` in the record;

then times kernels (wrapper, and alone for the variants), plain twins and
every engine with CUDA events (``[time]``), the variants, the slab forms
and the options included, and the raw step in THRESHOLD and STATS_ONLY
beside ABSDIFF (ring and tail, s = 1 and 8); then

* the acceptance check (``[validate]``): ``python -m
  dips_tpu_torch.validate --with-soak 512 --json
  chiprun_out/validate_torch.json`` in a process of its own, every case
  against the numpy oracle on both protocols, the seven gates and the
  512-frame soak on the kernels (the per-case seconds, the soak's frames/s
  and the launches of each wrapper in the run);
* the multi-process engine (``[multihost]``): two ranks of
  ``MultiHostStreamEngine`` in processes of their own (this script with
  ``--multihost-worker``), 4 cells each, all naming cuda:0, joined by
  ``init_multihost`` over gloo: 1080p x 8 streams, B = 16, the ring
  protocol, COLORIZE w3/T4 and STATS_ONLY, four rounds (rank 0 feeds
  nothing in the second, a per-process save and load before the fourth),
  every launch held against its plain twin, each rank's maps and stats
  equal to a single-process fleet on the card bit for bit, the global
  means within 1e-6, the round walls beside the single-process fleet's.
  Two processes on one card: this shows the exchange and the lockstep,
  not scaling across cards;
* the examples (``[examples]``, untimed): ``dips_tpu_torch.examples``'
  first eight in this process with no flag (the card), each through
  ``runpy`` in a working directory of its own, under one ``HeldRing``
  (every ring launch, the servers' threads' too, held against its plain
  twin), and ``multi_host`` as its own two ranks on cuda:0; each card
  run's stdout held against the same example's ``--cpu`` run, made in
  processes beside them, through ``examples._compare``
  (``examples_launches`` in the record);
* the block geometry (``[autotune]``, untimed): two non-default tiles of
  the exact w3 median ring kernel and two non-default blocks of the raw
  ABSDIFF ring kernel, each built for its unit alone, held at 1080p, B =
  16 over two batches against the default geometry's launch (bit for
  bit; median stats within 1e-5) and the plain twin; ``python -m
  dips_tpu_torch.autotune --windows 3 --dry-run`` in a process of its own
  with the store pointed at a scratch file (its probe times printed
  beside this card's line); one engine batch per kernel with a store that
  names a non-default geometry, whose launches must use it and whose
  outputs must equal the default engine's.

Each path's launch counts are set to 0 just before it runs and read just
after.

Phases print on their own lines; any failed check raises, so the exit code
is non-zero and no result is printed.  The line before the last holds the
kernels' record as JSON (with the registers of each timed instance, from
ptxas); the last line is
``{"ok": true, "device": {...}}``.  Without a card, or without the
repository around it, it exits non-zero before printing any result.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

H1080, W1080 = 1080, 1920
B = 16
FLEET = 8  # streams of the fleet phases (BASELINE.json's fleet config)
RAW_TOL = dict(heat_atol=1e-6, stats_rtol=1e-6)
MEDIAN_TOL = dict(lsb=1, flip_frac=1e-4, heat_atol=1e-6, stats_rtol=1e-5)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def moving_square_frames(n, h, w, seed, start=0):
    """Seeded (n, H, W, 3) uint8 RGB frames: a bright square moving over a
    static noise background."""
    rng = np.random.default_rng(seed)
    bg = rng.integers(0, 256, (h, w, 3), np.uint8)
    frames = np.empty((n, h, w, 3), np.uint8)
    side = max(8, h // 10)
    for i in range(n):
        k = start + i
        f = frames[i]
        f[:] = bg
        y = (7 * k) % (h - side)
        x = (13 * k) % (w - side)
        f[y:y + side, x:x + side] = (250, 30, 30)
    return frames


def ptag(props):
    """w<W>/T<T>, and the spatial mode when it is not the exact median."""
    mode = ("approx" if props.approx_median
            else "quirk" if props.quirk_compat else "")
    return f"w{props.window_size}/T{props.temporal_size}" + (
        f" {mode}" if mode else "")


def planar(frames, hp, wp):
    import torch
    n, h, w, _ = frames.shape
    out = np.zeros((n, 3, hp, wp), np.uint8)
    out[:, :, :h, :w] = frames.transpose(0, 3, 1, 2)
    return torch.from_numpy(out)


# ---------------------------------------------------------------------------
# phase 1-2: the card and the build
# ---------------------------------------------------------------------------

def phase_card():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    card = card_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()} "
        f"name {torch.cuda.get_device_name(0)} "
        f"capability {torch.cuda.get_device_capability(0)}")
    from dips_tpu_torch.ops import _build
    nvcc = _build._nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(f"[card] nvcc {nvcc}: {ver[-1]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def instance_regs(ptxas):
    """ptxas's report -> {instance: (registers, spill store bytes)}, an
    instance being ("raw", tail, C, 0) (C the map's channels: 3, 1, 0) or
    (kernel, W, mode, bands) with kernel "median_ring" / "median_tail" and
    mode 0 / 1 / 2 (exact, approx, quirk)."""
    import re
    regs, key = {}, None
    for line in str(ptxas).splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            m = re.search(r"(median_ring|median_tail)_kernelILi(\d)ELi(\d)"
                          r"ELb([01])E", name)
            r = re.search(r"raw_step_kernelILb([01])ELi(\d)E", name)
            key = ((m[1], int(m[2]), int(m[3]), int(m[4])) if m else
                   ("raw", int(r[1]), int(r[2]), 0) if r else None)
        elif key and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line)[1])
            regs[key] = (None, spill)
        elif key and "Used" in line and "registers" in line:
            n = int(re.search(r"Used (\d+) registers", line)[1])
            regs[key] = (n, regs.get(key, (None, 0))[1])
    return regs


def record_instance(name):
    """The compiled instance (as :func:`instance_regs` keys it) that the
    kernels' record entry ``name`` times: ABSDIFF's for the raw kernel, the
    exact w3 median, or the variant the [options] runs use (approx w7,
    quirk w5); bands for the slab_bands forms."""
    base, _, form = name.partition(":")
    if base == "pool_prep":  # a library of its own: not in phase_build's
        return (base,)
    if base.startswith("absdiff"):
        return ("raw", int("ring" not in base), 3, 0)
    kernel = "median_ring" if "ring" in base else "median_tail"
    mode = {"approx_median": 1, "quirk_compat": 2}.get(form, 0)
    w = {1: MAIN_VARIANTS["approx_median"],
         2: MAIN_VARIANTS["quirk_compat"]}.get(mode, 3)
    return (kernel, w, mode, int(form == "slab_bands"))


def phase_build():
    """Build the kernels; log each instance's registers and spills."""
    from dips_tpu_torch.ops import _build
    _build.build(force=True)
    info = dict(_build.build_info)
    _build.lib()
    log(f"[build] {info['seconds']:.2f} s into {info['dir']}")
    regs = instance_regs(info["ptxas"])
    for key in sorted(regs):
        log(f"[build] {key}: {regs[key][0]} registers, {regs[key][1]} bytes "
            f"spill stores")
    return regs


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain twin at the main path's shapes
# ---------------------------------------------------------------------------

def _max_err(a, b):
    import torch
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def _host64(x):
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x, np.float64)


def _check_stats(tag, got, exp, rtol):
    """Counts and maxima exact; the two sums within rtol of their own
    magnitude, or of the mean |diff| (which bounds the rounding error of a
    sum that cancels).  Tensors or arrays (n, 4)."""
    g, e = _host64(got), _host64(exp)
    if not np.array_equal(g[:, 2:], e[:, 2:]):
        raise AssertionError(f"{tag}: counts/max differ")
    scale = np.maximum(np.abs(e[:, :2]), np.abs(e[:, 1:2]))
    bad = np.abs(g[:, :2] - e[:, :2]) > rtol * scale + 1e-12
    if bad.any():
        raise AssertionError(f"{tag}: stats beyond rtol {rtol}: "
                             f"{g[:, :2][bad][:4]} vs {e[:, :2][bad][:4]}")


def _two_batches(hp, wp, h, w, seed, dev):
    """Frames of two consecutive batches: a fresh stream (seed 1, captures
    on frames 0 and 5), then a partial batch (n = 11 of 16, seed 0)."""
    frames = moving_square_frames(2 * B, h, w, seed)
    raw = planar(frames, hp, wp).to(dev)
    f1 = np.zeros(B, bool)
    f1[[0, 5]] = True
    f2 = np.zeros(B, bool)
    f2[3] = True
    v2 = np.zeros(B, bool)
    v2[:11] = True
    v2_raw = raw[B:].clone()
    v2_raw[11:] = v2_raw[10]  # padding replicas of the last real frame
    import torch
    t = lambda a: torch.from_numpy(a).to(dev)
    return [(raw[:B], t(f1), t(np.ones(B, bool)), 0, 1),
            (v2_raw, t(f2), t(v2), B, 0)]


def check_raw(props, h, w, seed):
    import torch
    from dips_tpu_torch.ops import cuda_fused
    from dips_tpu_torch.ops.reference import pad_geometry
    dev = torch.device("cuda")
    hp, wp = pad_geometry(h, w)
    states = [[torch.zeros((3, hp, wp), dtype=torch.uint8, device=dev),
               torch.zeros((3, hp, wp), dtype=torch.uint8, device=dev),
               torch.zeros((hp, wp), device=dev)] for _ in range(2)]
    err = 0.0
    for x, flags, valid, _off, seed_ in _two_batches(hp, wp, h, w, seed,
                                                      dev):
        got = cuda_fused.absdiff_step_ring(props, h, w, x, *states[0][:2],
                                           flags, states[0][2], valid, seed_)
        exp = cuda_fused.absdiff_step_ring_plain(
            props, h, w, x, *states[1][:2], flags, states[1][2], valid,
            seed_)
        torch.cuda.synchronize()
        if not torch.equal(got[0], exp[0]):
            raise AssertionError(f"raw {props.output.name}: maps differ")
        for g, e in zip(got[2:4], exp[2:4]):
            if not torch.equal(g, e):
                raise AssertionError(f"raw {props.output.name}: prev or "
                                     f"baseline differs")
        herr = _max_err(got[4], exp[4])
        if herr > RAW_TOL["heat_atol"]:
            raise AssertionError(f"raw heatmap err {herr}")
        _check_stats(f"raw {props.output.name}", got[1], exp[1],
                     RAW_TOL["stats_rtol"])
        err = max(err, herr, _max_err(got[1], exp[1]))
    return err


def check_median(props, h, w, seed):
    import torch
    from dips_tpu_torch.ops import cuda_fused
    from dips_tpu_torch.ops.reference import pad_geometry
    dev = torch.device("cuda")
    hp, wp = pad_geometry(h, w)
    t = props.temporal_size
    states = [[torch.zeros((t, hp, wp), device=dev)]
              + [torch.zeros((hp, wp), device=dev) for _ in range(3)]
              for _ in range(2)]
    err = 0.0
    tag = (f"median {props.output.name} {props.method.name} "
           f"{ptag(props)} {props.filter.name}")
    for x, flags, valid, off, seed_ in _two_batches(hp, wp, h, w, seed, dev):
        got = cuda_fused.batch_step_ring(props, h, w, x, *states[0][:3],
                                         flags, states[0][3], valid, off % t,
                                         seed_)
        exp = cuda_fused.batch_step_ring_plain(
            props, h, w, x, *states[1][:3], flags, states[1][3], valid,
            off % t, seed_)
        torch.cuda.synchronize()
        d = (got[0][..., :h, :w].to(torch.int16)
             - exp[0][..., :h, :w].to(torch.int16)).abs()
        flips = int((d > 0).sum())
        if d.numel() and (int(d.max()) > MEDIAN_TOL["lsb"]
                          or flips > MEDIAN_TOL["flip_frac"] * d.numel()):
            raise AssertionError(f"{tag}: maps differ (max {int(d.max())}, "
                                 f"{flips} pixels)")
        for g, e in zip(got[2:5], exp[2:5]):
            if not torch.equal(g[..., :h, :w], e[..., :h, :w]):
                raise AssertionError(f"{tag}: ring/prev/baseline differ")
        herr = _max_err(got[5], exp[5])
        if herr > MEDIAN_TOL["heat_atol"]:
            raise AssertionError(f"{tag}: heatmap err {herr}")
        _check_stats(tag, got[1], exp[1], MEDIAN_TOL["stats_rtol"])
        err = max(err, herr, float(d.max()) if d.numel() else 0.0)
        log(f"[check] {tag} {h}x{w}: tie flips {flips}/{d.numel()}")
    return err


def phase_kernels():
    from dips_tpu_torch.properties import (DiPsFilter, DiPsMethod,
                                           DiPsProperties, OutputMode)
    errs = {"absdiff_step_ring": 0.0, "batch_step_ring": 0.0}
    for props in (DiPsProperties(output=OutputMode.ABSDIFF),
                  DiPsProperties(output=OutputMode.ABSDIFF,
                                 method=DiPsMethod.PER_FRAME),
                  DiPsProperties(output=OutputMode.THRESHOLD),
                  DiPsProperties(output=OutputMode.STATS_ONLY)):
        e = check_raw(props, H1080, W1080, 11)
        errs["absdiff_step_ring"] = max(errs["absdiff_step_ring"], e)
        log(f"[check] raw {props.output.name} {props.method.name} 1080p "
            f"B={B}: maps and state byte-equal, max err {e}")
    for props, (h, w) in (
            (DiPsProperties(), (H1080, W1080)),
            (DiPsProperties(output=OutputMode.GRAYSCALE,
                            method=DiPsMethod.PER_FRAME,
                            filter=DiPsFilter.INVERSE_SIGMOID,
                            window_size=5, temporal_size=3),
             (H1080, W1080)),
            (DiPsProperties(window_size=7, temporal_size=16), (480, 640)),
            (DiPsProperties(window_size=1, temporal_size=1), (480, 640))):
        e = check_median(props, h, w, 12)
        errs["batch_step_ring"] = max(errs["batch_step_ring"], e)
    return errs


# ---------------------------------------------------------------------------
# phase 4: the main path end to end
# ---------------------------------------------------------------------------

def run_engine(props, frames_for, n_frames, snapshot_at=None, start=0,
               engine=None):
    from dips_tpu_torch import DiPsEngine
    eng = engine or DiPsEngine(props, H1080, W1080, batch=B, device="cuda")
    outs, stats = [], []
    for i in range(start, n_frames, B):
        if snapshot_at is not None and i == snapshot_at:
            eng.snapshot()
        o, s = eng.process_batch(list(frames_for(i, min(B, n_frames - i))))
        outs.append(o)
        stats.append(s)
    return eng, np.concatenate(outs), np.concatenate(stats)


def phase_main_path(card):
    import torch
    from dips_tpu_torch import DiPsEngine, DiPsProperties, OutputMode
    from dips_tpu_torch.ops import cuda_fused
    n = 96
    frames = moving_square_frames(n, H1080, W1080, 21)

    def frames_for(i, k):
        return frames[i:i + k]

    colorize = DiPsProperties(refresh_markers=(48,))
    absdiff = DiPsProperties(output=OutputMode.ABSDIFF,
                             refresh_markers=(48,))
    cuda_fused.reset_launch_counts()
    _, out, stats = run_engine(colorize, frames_for, n, snapshot_at=64)
    _, aout, astats = run_engine(absdiff, frames_for, n, snapshot_at=64)
    torch.cuda.synchronize()
    launches = {name: k for name, k in cuda_fused.launch_counts().items()
                if name in ("absdiff_step_ring", "batch_step_ring")}
    log(f"[main] launches during the engine runs: "
        f"{cuda_fused.launch_counts()}")
    for name, k in launches.items():
        if k <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    # everything below re-runs engines for checks; the record keeps the
    # counts of the main-path run itself

    capture = {0, 48, 64}
    # frame 1 diffs nothing either: the seeded T=4 ring holds frame 0 three
    # times, so its (upper) temporal median is still frame 0
    motion = [f for f in range(2, n) if f not in capture]
    if out.shape != (n, H1080, W1080, 3) or stats.shape != (n, 4):
        raise AssertionError(f"bad shapes {out.shape} {stats.shape}")
    if not np.isfinite(stats).all() or not np.isfinite(astats).all():
        raise AssertionError("non-finite stats")
    red = int((out[motion, ..., 0] > 200).sum())
    green = int((out[motion, ..., 1] > 200).sum())
    if red == 0 or green == 0:
        raise AssertionError(f"no red/green pixels ({red}, {green})")
    if not (stats[motion, 3] > 0).all() or (stats[sorted(capture), 3] != 0).any():
        raise AssertionError(f"changed counts wrong: {stats[:, 3]}")
    for f in capture:  # capture frames render the new baseline gray
        if not np.array_equal(out[f, ..., 0], out[f, ..., 1]):
            raise AssertionError(f"capture frame {f} is not gray")
    log(f"[main] COLORIZE 1080p {n} frames: red px {red}, green px {green}, "
        f"changed>0 on {len(motion)} motion frames, 0 on captures "
        f"{sorted(capture)}")

    # ABSDIFF is |frame - baseline| byte for byte (cv2.absdiff parity)
    base = {f: (48 if f >= 48 else 0) for f in range(n)}
    for f in range(64, n):
        base[f] = 64
    try:
        import cv2
        absdiff_fn = cv2.absdiff
        how = "cv2.absdiff"
    except ImportError:
        def absdiff_fn(a, b):
            return np.abs(a.astype(np.int16) - b.astype(np.int16)) \
                .astype(np.uint8)
        how = "numpy |a - b|"
    for f in range(n):
        if not np.array_equal(aout[f], absdiff_fn(frames[f],
                                                  frames[base[f]])):
            raise AssertionError(f"ABSDIFF frame {f} != {how}")
    log(f"[main] ABSDIFF 1080p {n} frames equal {how} byte for byte")

    # checkpoint: save after 48 frames, resume in a fresh engine
    work = os.path.join("build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    for props, ref_out, ref_stats in ((colorize, out, stats),
                                      (absdiff, aout, astats)):
        eng, _, _ = run_engine(props, frames_for, 48)
        ck = os.path.join(work, "resume.npz")
        eng.save(ck)
        fresh = DiPsEngine(props, H1080, W1080, batch=B, device="cuda")
        fresh.load(ck)
        _, o2, s2 = run_engine(props, frames_for, n, snapshot_at=64,
                               start=48, engine=fresh)
        if not (np.array_equal(o2, ref_out[48:])
                and np.array_equal(s2, ref_stats[48:])):
            raise AssertionError(f"{props.output.name}: resumed run differs "
                                 f"from the uninterrupted one")
    log("[main] save after 48 frames + load into a fresh engine: frames "
        "48..95 equal the uninterrupted run (COLORIZE and ABSDIFF)")

    # the card engine against the CPU engine (plain twins) on a small input
    small = moving_square_frames(20, 64, 200, 5)
    for props in (DiPsProperties(refresh_markers=(7,)),
                  DiPsProperties(output=OutputMode.THRESHOLD)):
        res = []
        for dev in ("cuda", "cpu"):
            e = DiPsEngine(props, 64, 200, batch=6, device=dev)
            res.append(e.process_frames(list(small)))
        d = np.abs(res[0][0].astype(np.int16) - res[1][0].astype(np.int16))
        if d.max() > 1 or not np.allclose(res[0][1], res[1][1], rtol=1e-5,
                                          atol=1e-7):
            raise AssertionError(f"{props.output.name}: card engine != CPU "
                                 f"engine")
    log("[main] card engine == CPU engine (plain twins) on 20 frames 64x200")

    try:
        import cv2
    except ImportError:
        log("[file] cv2 is not installed: the run_dips_on_file phase did not "
            "run")
        return launches
    from dips_tpu_torch import run_dips_on_file
    src, dst = os.path.join(work, "in.avi"), os.path.join(work, "out.avi")
    vw = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"MJPG"), 30,
                         (W1080, H1080))
    for f in frames[:48]:
        vw.write(np.ascontiguousarray(f[..., ::-1]))
    vw.release()
    t0 = time.perf_counter()
    st = run_dips_on_file(src, dst, properties=DiPsProperties(), batch=B,
                          device="cuda")
    dt = time.perf_counter() - t0
    cap = cv2.VideoCapture(dst)
    count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    if st.shape != (48, 4) or count != 48:
        raise AssertionError(f"run_dips_on_file: {st.shape} stats, {count} "
                             f"frames written")
    log(f"[file] run_dips_on_file 1080p MJPG 48 frames -> {count} frames "
        f"written in {dt:.2f} s (decode+encode included; {card})")
    return launches


# ---------------------------------------------------------------------------
# phase 5: each stacked kernel against its plain twin, s streams per launch
# ---------------------------------------------------------------------------

def stacked_frames(n, h, w, s, seed, dev):
    """(n, 3, s*Hp, Wp) u8 on the card: even streams a moving square over
    seeded noise, odd streams white with a moving dark square, so a median
    tap or a mask that crosses a stream edge changes a result."""
    import torch
    from dips_tpu_torch.ops.reference import pad_geometry
    hp, wp = pad_geometry(h, w)
    raw = torch.zeros((n, 3, s * hp, wp), dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(seed)
    side = max(8, h // 10)
    for si in range(s):
        r0 = si * hp
        if si % 2 == 0:
            raw[:, :, r0:r0 + h, :w] = torch.from_numpy(
                rng.integers(0, 256, (3, h, w), np.uint8)).to(dev)
            color = (250, 30, 30)
        else:
            raw[:, :, r0:r0 + h, :w] = 255
            color = (40, 40, 40)
        col = torch.tensor(color, dtype=torch.uint8, device=dev)[:, None,
                                                                 None]
        for i in range(n):
            y = (7 * i + 11 * si) % (h - side)
            x = (13 * i + 29 * si) % (w - side)
            raw[i, :, r0 + y:r0 + y + side, x:x + side] = col
    return raw


def _stacked_batches(s, t, b=None):
    """Per-stream arguments of two consecutive batches of ``b`` (default B)
    frames: captures on different frames per stream, mixed seeds and ring
    offsets, the last stream all-invalid in the first batch, a partial
    second batch."""
    b = B if b is None else b
    f1, f2 = np.zeros((s, b), bool), np.zeros((s, b), bool)
    v1, v2 = np.ones((s, b), bool), np.zeros((s, b), bool)
    for si in range(s):
        f1[si, (3 * si) % b] = True
        f2[si, (si + 5) % b] = True
    v1[s - 1] = False
    v2[:, :11 * b // 16] = True
    v2[0] = True
    seeds1 = [0 if si % 3 == 2 else 1 for si in range(s)]
    seeds2 = [1 if si == s - 1 else 0 for si in range(s)]
    return [(f1, v1, [si % t for si in range(s)], seeds1),
            (f2, v2, [(si + b) % t for si in range(s)], seeds2)]


def check_stacked(props, h, w, s, seed):
    import torch
    from dips_tpu_torch.ops import cuda_fused
    from dips_tpu_torch.ops.reference import pad_geometry
    from dips_tpu_torch.properties import OutputMode
    dev = torch.device("cuda")
    hp, wp = pad_geometry(h, w)
    t = props.temporal_size
    rows = (s * hp, wp)
    raw_mode = props.output in (OutputMode.ABSDIFF, OutputMode.THRESHOLD,
                                OutputMode.STATS_ONLY)
    if raw_mode:
        kernel = cuda_fused.absdiff_step_ring_stacked
        plain = cuda_fused.absdiff_step_ring_stacked_plain
        mk = lambda: [torch.zeros((3,) + rows, dtype=torch.uint8,
                                  device=dev) for _ in range(2)] + [
            torch.zeros(rows, device=dev)]
    else:
        kernel = cuda_fused.batch_step_ring_stacked
        plain = cuda_fused.batch_step_ring_stacked_plain
        mk = lambda: [torch.zeros((t,) + rows, device=dev)] + [
            torch.zeros(rows, device=dev) for _ in range(3)]
    states = [mk(), mk()]
    raw = stacked_frames(2 * B, h, w, s, seed, dev)
    tag = (f"stacked {props.output.name} {props.method.name} "
           f"{ptag(props)} {h}x{w} s={s}")
    tol = RAW_TOL if raw_mode else MEDIAN_TOL
    err, flips, n_px = 0.0, 0, 0
    for i, (flags, valid, offs, seeds) in enumerate(_stacked_batches(s, t)):
        x = raw[i * B:(i + 1) * B]
        fl = torch.from_numpy(flags).to(dev)
        va = torch.from_numpy(valid).to(dev)
        res = []
        for fn, st in zip((kernel, plain), states):
            if raw_mode:
                res.append(fn(props, h, w, s, x, st[0], st[1], fl, st[2],
                              va, seeds))
            else:
                res.append(fn(props, h, w, s, x, *st[:3], fl, st[3], va,
                              offs, seeds))
        torch.cuda.synchronize()
        got, exp = res
        per = lambda a: a.view(a.shape[:-2] + (s, hp, wp))[..., :h, :w]
        d = (per(got[0]).to(torch.int16) - per(exp[0]).to(torch.int16)).abs()
        if d.numel():
            lsb = 0 if raw_mode else tol["lsb"]
            flips += int((d > 0).sum())
            n_px += d.numel()
            if int(d.max()) > lsb or flips > MEDIAN_TOL["flip_frac"] * n_px:
                raise AssertionError(f"{tag}: maps differ (max "
                                     f"{int(d.max())}, {flips} pixels)")
            err = max(err, float(d.max()))
        for g, e in zip(got[2:-1], exp[2:-1]):
            if not torch.equal(per(g), per(e)):
                raise AssertionError(f"{tag}: carried state differs")
        herr = _max_err(got[-1], exp[-1])
        if herr > tol["heat_atol"]:
            raise AssertionError(f"{tag}: heatmap err {herr}")
        for si in range(s):
            _check_stats(f"{tag} stream {si}", got[1][si], exp[1][si],
                         tol["stats_rtol"])
        err = max(err, herr, _max_err(got[1], exp[1]))
    log(f"[kernels-stacked] {tag} B={B}: maps, state and stats match the "
        f"plain twin; tie flips {flips}/{n_px}, max err {err}")
    return err


def phase_kernels_stacked():
    from dips_tpu_torch.properties import (DiPsFilter, DiPsMethod,
                                           DiPsProperties, OutputMode)
    errs = {"absdiff_step_ring_stacked": 0.0, "batch_step_ring_stacked": 0.0}
    for props, (h, w, s) in (
            (DiPsProperties(output=OutputMode.ABSDIFF),
             (H1080, W1080, FLEET)),
            (DiPsProperties(), (H1080, W1080, FLEET)),
            (DiPsProperties(method=DiPsMethod.PER_FRAME,
                            output=OutputMode.GRAYSCALE,
                            filter=DiPsFilter.INVERSE_SIGMOID,
                            window_size=7, temporal_size=3,
                            roi=(40, 60, 440, 600)), (480, 640, 3)),
            (DiPsProperties(output=OutputMode.THRESHOLD,
                            method=DiPsMethod.PER_FRAME,
                            change_threshold=20, roi=(40, 60, 440, 600)),
             (480, 640, 3))):
        name = ("absdiff_step_ring_stacked"
                if props.output in (OutputMode.ABSDIFF, OutputMode.THRESHOLD)
                else "batch_step_ring_stacked")
        errs[name] = max(errs[name], check_stacked(props, h, w, s, 61))
    return errs


# ---------------------------------------------------------------------------
# phase 5b: each tail kernel against its plain twin
# ---------------------------------------------------------------------------

def _tail_batches(s, t):
    """Per-stream flags / valid of two consecutive tail batches: captures
    on different frames per stream, a fresh stream, then a partial batch
    whose slot 12 is flagged but invalid (the tail kernels capture on it all
    the same) and, with s > 1, a stream all-invalid in the first batch.
    Returns [(first frame of the batch's tail, flags, valid)]."""
    f1, f2 = np.zeros((s, B), bool), np.zeros((s, B), bool)
    v1, v2 = np.ones((s, B), bool), np.zeros((s, B), bool)
    for si in range(s):
        f1[si, (3 * si) % B] = True
        f2[si, (si + 5) % 11] = True
    f2[:, 12] = True
    v2[:, :11] = True
    if s > 1:
        v1[s - 1] = False
    return [(0, f1, v1), (B, f2, v2)]


def check_tail(props, h, w, s, seed):
    """The tail wrapper (s = 1: the single-stream one) against its plain
    twin over two batches of T+B frames; returns (max error, tie flips,
    pixels compared)."""
    import torch
    from dips_tpu_torch.ops import cuda_fused
    from dips_tpu_torch.ops.reference import pad_geometry
    from dips_tpu_torch.properties import OutputMode
    dev = torch.device("cuda")
    hp, wp = pad_geometry(h, w)
    t = props.temporal_size
    rows = (s * hp, wp)
    raw_mode = props.output in (OutputMode.ABSDIFF, OutputMode.THRESHOLD,
                                OutputMode.STATS_ONLY)
    if raw_mode:
        fns = ((cuda_fused.absdiff_step, cuda_fused.absdiff_step_plain)
               if s == 1 else (cuda_fused.absdiff_step_stacked,
                               cuda_fused.absdiff_step_stacked_plain))
        mk = lambda: [torch.zeros((3,) + rows, dtype=torch.uint8,
                                  device=dev), torch.zeros(rows, device=dev)]
    else:
        fns = ((cuda_fused.batch_step, cuda_fused.batch_step_plain)
               if s == 1 else (cuda_fused.batch_step_stacked,
                               cuda_fused.batch_step_stacked_plain))
        mk = lambda: [torch.zeros(rows, device=dev) for _ in range(2)]
    states = [mk(), mk()]
    raw = (stacked_frames(t + 2 * B, h, w, s, seed, dev) if s > 1
           else planar(moving_square_frames(t + 2 * B, h, w, seed), hp,
                       wp).to(dev))
    tag = (f"tail {props.output.name} {props.method.name} "
           f"{ptag(props)} {h}x{w} s={s}")
    tol = RAW_TOL if raw_mode else MEDIAN_TOL
    err, flips, n_px = 0.0, 0, 0
    for start, flags, valid in _tail_batches(s, t):
        x = raw[start:start + t + B].clone()
        n = int(valid[0].sum())
        x[t + n:] = x[t + n - 1]  # padding replicas of the last frame
        fl = torch.from_numpy(flags if s > 1 else flags[0]).to(dev)
        va = torch.from_numpy(valid if s > 1 else valid[0]).to(dev)
        res = []
        for fn, st in zip(fns, states):
            args = (props, h, w) + ((s,) if s > 1 else ())
            res.append(fn(*args, x, st[0], fl, st[1], va))
        torch.cuda.synchronize()
        got, exp = res
        per = lambda a: a.view(a.shape[:-2] + (s, hp, wp))[..., :h, :w]
        d = (per(got[0]).to(torch.int16) - per(exp[0]).to(torch.int16)).abs()
        if d.numel():
            flips += int((d > 0).sum())
            n_px += d.numel()
            lsb = 0 if raw_mode else tol["lsb"]
            if int(d.max()) > lsb or flips > MEDIAN_TOL["flip_frac"] * n_px:
                raise AssertionError(f"{tag}: maps differ (max "
                                     f"{int(d.max())}, {flips} pixels)")
            err = max(err, float(d.max()))
        if not torch.equal(per(got[2]), per(exp[2])):
            raise AssertionError(f"{tag}: baseline differs")
        herr = _max_err(got[3], exp[3])
        if herr > tol["heat_atol"]:
            raise AssertionError(f"{tag}: heatmap err {herr}")
        gs, es = (a.reshape(s, B, 4) for a in (got[1], exp[1]))
        for si in range(s):
            _check_stats(f"{tag} stream {si}", gs[si], es[si],
                         tol["stats_rtol"])
        err = max(err, herr, _max_err(got[1], exp[1]))
    log(f"[kernels-tail] {tag} B={B}: maps, baseline and stats match the "
        f"plain twin, with a flagged invalid slot; tie flips "
        f"{flips}/{n_px}, max err {err}")
    return err


def phase_kernels_tail():
    from dips_tpu_torch.properties import (DiPsFilter, DiPsMethod,
                                           DiPsProperties, OutputMode)
    errs = {"absdiff_step": 0.0, "batch_step": 0.0,
            "absdiff_step_stacked": 0.0, "batch_step_stacked": 0.0}
    roi = (40, 60, 440, 600)
    for props, (h, w, s) in (
            (DiPsProperties(output=OutputMode.ABSDIFF), (H1080, W1080, 1)),
            (DiPsProperties(output=OutputMode.ABSDIFF,
                            method=DiPsMethod.PER_FRAME), (H1080, W1080, 1)),
            (DiPsProperties(), (H1080, W1080, 1)),
            (DiPsProperties(output=OutputMode.ABSDIFF),
             (H1080, W1080, FLEET)),
            (DiPsProperties(), (H1080, W1080, FLEET)),
            (DiPsProperties(method=DiPsMethod.PER_FRAME,
                            output=OutputMode.GRAYSCALE,
                            filter=DiPsFilter.INVERSE_SIGMOID,
                            window_size=7, temporal_size=16, roi=roi),
             (480, 640, 3)),
            (DiPsProperties(output=OutputMode.THRESHOLD,
                            method=DiPsMethod.PER_FRAME,
                            change_threshold=20, roi=roi), (480, 640, 3))):
        name = ("absdiff_step" if props.output in (OutputMode.ABSDIFF,
                                                   OutputMode.THRESHOLD)
                else "batch_step") + ("_stacked" if s > 1 else "")
        errs[name] = max(errs[name], check_tail(props, h, w, s, 63))
    return errs


# ---------------------------------------------------------------------------
# phase 5c: the tail protocol's single-stream engine end to end
# ---------------------------------------------------------------------------

#: batch sizes of the tail-vs-ring runs: partial batches among full ones
SPLITS = (16, 16, 11, 16, 5, 16, 16)
#: frames the split runs stream: the batches that start before frame 64
#: (both partial batches, the refresh marker at 48 and the snapshot before
#: frame 59 stay inside)
SPLIT_FRAMES = 64


def run_split(props, frames, ring_carry, engine=None, start=0, stop=None):
    """Frames [start:stop] through a DiPsEngine of the given protocol in
    SPLITS's batch sizes (start and stop on batch edges), snapshot before
    frame 59."""
    from dips_tpu_torch import DiPsEngine
    eng = engine or DiPsEngine(props, H1080, W1080, batch=B, device="cuda",
                               ring_carry=ring_carry)
    stop = len(frames) if stop is None else stop
    outs, stats, i = [], [], 0
    for k in SPLITS:
        if start <= i < stop:
            if i == 59:
                eng.snapshot()
            o, st = eng.process_batch(list(frames[i:i + k]))
            outs.append(o)
            stats.append(st)
        i += k
    return eng, np.concatenate(outs), np.concatenate(stats)


def _same_run(tag, got, exp):
    """Maps byte for byte, stats within 1e-5 relative."""
    if not np.array_equal(got[0], exp[0]):
        d = np.abs(got[0].astype(np.int16) - exp[0].astype(np.int16))
        raise AssertionError(f"{tag}: maps differ (max {d.max()}, "
                             f"{int((d > 0).sum())} pixels)")
    _check_stats(tag, got[1], exp[1], 1e-5)


def phase_tail(card):
    import torch
    from dips_tpu_torch import DiPsEngine, DiPsMethod, DiPsProperties, \
        OutputMode
    from dips_tpu_torch.ops import cuda_fused
    n = SPLIT_FRAMES
    frames = moving_square_frames(n, H1080, W1080, 23)
    configs = [
        ("COLORIZE OVERALL", DiPsProperties(refresh_markers=(48,))),
        ("COLORIZE PER_FRAME", DiPsProperties(method=DiPsMethod.PER_FRAME)),
        ("ABSDIFF OVERALL", DiPsProperties(output=OutputMode.ABSDIFF,
                                           refresh_markers=(48,))),
        ("ABSDIFF PER_FRAME", DiPsProperties(output=OutputMode.ABSDIFF,
                                             method=DiPsMethod.PER_FRAME))]
    cuda_fused.reset_launch_counts()
    tails = {label: run_split(props, frames, False)
             for label, props in configs}
    torch.cuda.synchronize()
    counts = cuda_fused.launch_counts()
    launches = {k: counts[k] for k in ("absdiff_step", "batch_step")}
    log(f"[tail] launches during the tail-engine runs: {counts}")
    for name, k in launches.items():
        if k <= 0:
            raise AssertionError(f"{name} never launched on the tail path")
    for label, props in configs:
        ring_eng, *ring = run_split(props, frames, True)
        tail_eng, *tail = tails[label]
        _same_run(f"[tail] {label}", tail, ring)
        for a, b_ in ((tail_eng.heatmap(), ring_eng.heatmap()),):
            if np.abs(a - b_).max() > 1e-5 * max(1.0, np.abs(b_).max()):
                raise AssertionError(f"[tail] {label}: heatmaps differ")
        tb, rb = (e.state_dict()["baseline"] for e in (tail_eng, ring_eng))
        if not np.array_equal(tb[..., :H1080, :W1080],
                              rb[..., :H1080, :W1080]):
            raise AssertionError(f"[tail] {label}: baselines differ")
        if not np.isfinite(tail[1]).all() or tail[0].shape[0] != n:
            raise AssertionError(f"[tail] {label}: bad output")
        # a checkpoint taken in one protocol continues in the other
        work = os.path.join("build", "chip_smoke")
        os.makedirs(work, exist_ok=True)
        cut = sum(SPLITS[:3])  # after the partial batch
        for save_ring in (False, True):
            src, _, _ = run_split(props, frames, save_ring, stop=cut)
            ck = os.path.join(work, "tail_resume.npz")
            src.save(ck)
            dst = DiPsEngine(props, H1080, W1080, batch=B, device="cuda",
                             ring_carry=not save_ring)
            dst.load(ck)
            _, o2, s2 = run_split(props, frames, not save_ring, engine=dst,
                                  start=cut)
            _same_run(f"[tail] {label} resumed", (o2, s2),
                      (ring[0][cut:], ring[1][cut:]))
        log(f"[tail] {label} 1080p {n} frames in batches {SPLITS} (those "
            f"that start before frame {n}): the "
            f"tail engine equals the ring engine (maps byte for byte, stats "
            f"within 1e-5, baseline exact); a checkpoint from either "
            f"protocol continues in the other")
        del tails[label], ring, tail
    return launches


# ---------------------------------------------------------------------------
# phase 6b: the tail protocol's fleet end to end
# ---------------------------------------------------------------------------

def phase_fleet_tail(card):
    import torch
    from dips_tpu_torch import DiPsProperties, OutputMode
    from dips_tpu_torch.ops import cuda_fused
    frame = FleetFrames(73)
    work = os.path.join("build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    launches = {"absdiff_step_stacked": 0, "batch_step_stacked": 0}
    idle = 2
    for label, props in (
            ("COLORIZE w3/T4", DiPsProperties(refresh_markers=(24,))),
            ("ABSDIFF", DiPsProperties(output=OutputMode.ABSDIFF,
                                       refresh_markers=(24,)))):
        name = ("absdiff_step_stacked" if props.output == OutputMode.ABSDIFF
                else "batch_step_stacked")
        # no checkpoint at 1080p x 8 (a fleet save compresses 0.35 GB):
        # the tail fleets' resume is held at 480p x 3 below; a tail
        # engine's, across the protocols, in [tail]
        cuda_fused.reset_launch_counts()
        tail = run_fleet(props, frame, work, ring_carry=False, idle=idle,
                         checkpoint=False)
        torch.cuda.synchronize()
        counts = cuda_fused.launch_counts()
        if counts[name] <= 0:
            raise AssertionError(f"{name} never launched on the tail fleet")
        launches[name] += counts[name]
        log(f"[fleet-tail] {label}: launches during the tail fleet run "
            f"{counts}")
        ring = run_fleet(props, frame, work, ring_carry=True, idle=idle,
                         checkpoint=False)
        n_px = 0
        for bi, ((idx, to, ts), (_, ro, rs)) in enumerate(zip(tail, ring)):
            for si, ids in enumerate(idx):
                if ids is None:
                    continue
                k = len(ids)
                _same_run(f"[fleet-tail] {label} stream {si} batch {bi}",
                          (to[si, :k], ts[si, :k]), (ro[si, :k], rs[si, :k]))
                n_px += to[si, :k].size
        log(f"[fleet-tail] {label} 1080p x {FLEET} streams, B={B}, 3 "
            f"batches: the tail fleet equals the ring fleet stream by stream "
            f"({n_px} map bytes equal, stats within 1e-5), through the "
            f"lagging stream 7, idle stream {idle}, the snapshot of stream "
            f"3, stream 5 isolated and revived")
        del tail, ring
        fleet_resume_small(f"[fleet-tail] {label} resume", props, False, work)
    return launches


# ---------------------------------------------------------------------------
# phase 6: the fleet path end to end
# ---------------------------------------------------------------------------

class FleetFrames:
    """Seeded host frames of the fleet: stream si's frame k is a bright
    square moving over the stream's own noise."""

    def __init__(self, seed, h=H1080, w=W1080):
        rng = np.random.default_rng(seed)
        self.h, self.w = h, w
        self.bgs = [rng.integers(0, 256, (h, w, 3), np.uint8)
                    for _ in range(FLEET)]
        self.side = max(8, h // 10)

    def __call__(self, si, k):
        f = self.bgs[si].copy()
        y = (7 * k + 40 * si) % (self.h - self.side)
        x = (13 * k + 90 * si) % (self.w - self.side)
        f[y:y + self.side, x:x + self.side] = (250, 30, 30)
        return f


def run_fleet(props, frame, work, ring_carry=True, idle=None,
              checkpoint=True, mesh=None, slab_impl="bands", keep=None):
    """Three batches of the 8-stream fleet: stream 7 lags by 6 frames,
    stream 3 takes a snapshot before batch 1, stream 5 sends a wrong-shape
    frame in batch 1 (isolated), the fleet is saved after batch 1 and
    resumed in a fresh engine (unless ``checkpoint`` is False: the save
    compresses 0.35 GB; "load": the fresh engine resumes from the file an
    earlier run of the same props and frames saved) and stream 5 revived;
    stream ``idle``, when given, sends nothing in batch 1.  ``mesh`` /
    ``slab_impl`` split the fleet over a mesh's cells.  Returns, per batch,
    each stream's frame indices (None where rejected or idle) and the
    outputs; ``keep``, a dict, receives the final fleet's carried
    "baseline" and "heatmaps"."""
    from dips_tpu_torch import MultiStreamEngine
    mk = lambda: MultiStreamEngine(props, H1080, W1080, FLEET, batch=B,
                                   device="cuda", ring_carry=ring_carry,
                                   mesh=mesh, slab_impl=slab_impl)
    fleet = mk()
    nxt = [0] * FLEET
    batches = []
    for bi in range(3):
        if bi == 1:
            fleet.snapshot(stream=3)
        if bi == 2:
            if checkpoint:
                ck = os.path.join(work, "fleet.npz")
                if checkpoint != "load":
                    fleet.save(ck)
                fleet = mk()
                fleet.load(ck)
                if set(fleet.failed) != {5}:
                    raise AssertionError(f"restored failures "
                                         f"{fleet.failed}")
            fleet.revive(5)
        idx = [list(range(nxt[si], nxt[si] + (10 if bi == 0 and si == 7
                                               else B)))
               for si in range(FLEET)]
        if bi == 1 and idle is not None:
            idx[idle] = []
        feeds = [[frame(si, k) for k in ids] for si, ids in enumerate(idx)]
        if bi == 1:
            feeds[5][7] = np.zeros((H1080, W1080 // 2, 3), np.uint8)
        out, stats, gmean = fleet.process_batch(feeds)
        if bi == 1:
            if set(fleet.failed) != {5}:
                raise AssertionError(f"stream 5 not isolated: "
                                     f"{fleet.failed}")
            idx[5] = None
        if bi == 1 and idle is not None:
            idx[idle] = None
        for si, ids in enumerate(idx):
            if ids is not None:
                nxt[si] += len(ids)
        valid = [stats[si, :len(ids), 1] for si, ids in enumerate(idx)
                 if ids is not None]
        exp_g = float(np.mean(np.concatenate(valid)))
        if not np.isfinite(stats).all() or \
                abs(gmean - exp_g) > 1e-5 * max(exp_g, 1e-12):
            raise AssertionError(f"gmean {gmean} != {exp_g}")
        batches.append((idx, out, stats))
    cursors = [48] * 5 + [32] + [48, 42]
    if idle is not None:
        cursors[idle] -= B
    if fleet.frame_cursors != cursors:
        raise AssertionError(f"cursors {fleet.frame_cursors}")
    if keep is not None:
        keep.update(baseline=fleet.state_dict()["baseline"],
                    heatmaps=fleet.heatmaps())
    return batches


#: the COLORIZE ring fleet's run without a mesh, kept for [grid]
FLEET_REF = {}

#: the geometry of the small fleets whose checkpoint resume is held
RESUME_H, RESUME_W, RESUME_S = 480, 640, 3


def fleet_resume_small(tag, props, ring_carry, work):
    """A 480p x 3 fleet saved after two batches (a snapshot of stream 1
    before the second) and resumed in a fresh engine equals the
    uninterrupted fleet over the third: maps byte for byte, stats within
    1e-6, carried baseline and heatmaps exact."""
    from dips_tpu_torch import MultiStreamEngine
    frame = FleetFrames(139, RESUME_H, RESUME_W)
    mk = lambda: MultiStreamEngine(props, RESUME_H, RESUME_W, RESUME_S,
                                   batch=B, device="cuda",
                                   ring_carry=ring_carry)
    feeds = [[[frame(si, bi * B + k) for k in range(B)]
              for si in range(RESUME_S)] for bi in range(3)]
    ref, cut = mk(), mk()
    for bi in range(2):
        if bi == 1:
            ref.snapshot(stream=1)
            cut.snapshot(stream=1)
        ref.process_batch(feeds[bi])
        cut.process_batch(feeds[bi])
    ck = os.path.join(work, "fleet_small.npz")
    cut.save(ck)
    resumed = mk()
    resumed.load(ck)
    exp = ref.process_batch(feeds[2])
    got = resumed.process_batch(feeds[2])
    if not np.array_equal(got[0], exp[0]):
        raise AssertionError(f"{tag}: resumed maps differ")
    for si in range(RESUME_S):
        _check_stats(f"{tag} stream {si}", got[1][si], exp[1][si], 1e-6)
    a, b = resumed.state_dict(), ref.state_dict()
    if not np.array_equal(a["baseline"], b["baseline"]) or \
            not np.array_equal(resumed.heatmaps(), ref.heatmaps()):
        raise AssertionError(f"{tag}: resumed state differs")
    if resumed.frame_cursors != [3 * B] * RESUME_S or \
            ref.frame_cursors != [3 * B] * RESUME_S:
        raise AssertionError(f"{tag}: cursors {resumed.frame_cursors}")
    log(f"{tag} 480p x {RESUME_S} streams, B={B}: saved after 2 batches "
        f"(stream 1's snapshot before the second), resumed in a fresh "
        f"engine, batch 3 equals the uninterrupted fleet (maps byte for "
        f"byte, stats within 1e-6, baseline and heatmaps exact)")



def phase_fleet(card):
    import torch
    from dips_tpu_torch import DiPsEngine, DiPsProperties, OutputMode
    from dips_tpu_torch.ops import cuda_fused
    frame = FleetFrames(71)
    work = os.path.join("build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    launches = {"absdiff_step_ring_stacked": 0, "batch_step_ring_stacked": 0}
    for label, props in (
            ("COLORIZE w3/T4", DiPsProperties(refresh_markers=(24,))),
            ("ABSDIFF", DiPsProperties(output=OutputMode.ABSDIFF,
                                       refresh_markers=(24,)))):
        exact = props.output == OutputMode.ABSDIFF
        cuda_fused.reset_launch_counts()
        # the ring fleet's checkpoint resume runs once, in the COLORIZE
        # fleet (the save compresses 0.35 GB); [grid] holds its own
        state = {}
        batches = run_fleet(props, frame, work, checkpoint=not exact,
                            keep=state)
        torch.cuda.synchronize()
        counts = cuda_fused.launch_counts()
        name = ("absdiff_step_ring_stacked" if exact
                else "batch_step_ring_stacked")
        if counts[name] <= 0:
            raise AssertionError(f"{name} never launched on the fleet path")
        launches[name] += counts[name]
        log(f"[fleet] {label}: launches during the fleet run {counts}")
        # each stream against a single-stream engine fed the frames the
        # fleet accepted for it
        worst, flips, n_px = 0, 0, 0
        for si in range(FLEET):
            eng = DiPsEngine(props, H1080, W1080, batch=B, device="cuda")
            for bi, (idx, out, stats) in enumerate(batches):
                if idx[si] is None:
                    continue
                if bi == 1 and si == 3:
                    eng.snapshot()
                o, st = eng.process_batch([frame(si, k) for k in idx[si]])
                n = len(idx[si])
                d = np.abs(out[si, :n].astype(np.int16) - o.astype(np.int16))
                worst = max(worst, int(d.max(initial=0)))
                flips += int((d > 0).sum())
                n_px += d.size
                if worst > (0 if exact else MEDIAN_TOL["lsb"]) or \
                        flips > MEDIAN_TOL["flip_frac"] * n_px:
                    raise AssertionError(f"[fleet] {label} stream {si} "
                                         f"batch {bi}: maps differ from the "
                                         f"single-stream engine")
                _check_stats(f"[fleet] {label} stream {si} batch {bi}",
                             stats[si, :n], st, 1e-6)
            del eng
        _, out, stats = batches[1]
        if stats[3, 0, 3] != 0 or stats[0, 0, 3] == 0:
            raise AssertionError("per-stream snapshot: stream 3 did not "
                                 "re-capture alone")
        if stats[0, 24 - B, 3] != 0:  # refresh marker 24 on stream 0
            raise AssertionError("refresh marker 24 did not re-capture")
        log(f"[fleet] {label} 1080p x {FLEET} streams, B={B}, 3 batches: "
            f"every stream equals a single-stream DiPsEngine on its frames "
            f"(max diff {worst}, {flips} of {n_px} pixels differ), "
            f"including the snapshot of stream 3, stream 5 isolated by a "
            f"wrong-shape frame and revived"
            + ("" if exact else ", and the checkpoint resume"))
        if not exact:  # [grid] holds the grid fleet against this run
            FLEET_REF.update(props=props, frame=frame, batches=batches,
                             state=state)
        del batches, out, stats
    # the ABSDIFF fleet's resume, at a geometry whose save is quick
    fleet_resume_small("[fleet] ABSDIFF resume",
                       DiPsProperties(output=OutputMode.ABSDIFF,
                                      refresh_markers=(24,)), True, work)
    return launches


def phase_fleet_file(card):
    try:
        import cv2
    except ImportError:
        log("[fleet-file] cv2 is not installed: the run_dips_on_files "
            "phase did not run")
        return
    from dips_tpu_torch import (DiPsProperties, run_dips_on_file,
                                run_dips_on_files)
    frame = FleetFrames(81)
    work = os.path.join("build", "chip_smoke", "fleet_file")
    os.makedirs(work, exist_ok=True)
    paths, lens = [], (20, 14, 24)
    for si, n in enumerate(lens):
        p = os.path.join(work, f"cam{si}.avi")
        vw = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"MJPG"), 30,
                             (W1080, H1080))
        for k in range(n):
            vw.write(np.ascontiguousarray(frame(si, k)[..., ::-1]))
        vw.release()
        paths.append(p)
    props = DiPsProperties(refresh_markers=(12,))
    t0 = time.perf_counter()
    counts, stats = run_dips_on_files(paths, os.path.join(work, "out"),
                                      encoding="HFYU", properties=props,
                                      batch=B, device="cuda",
                                      collect_stats=True)
    dt = time.perf_counter() - t0
    if list(counts) != list(lens):
        raise AssertionError(f"run_dips_on_files counts {list(counts)}")

    def read(path):
        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(f)
        cap.release()
        return np.stack(frames)

    for si, p in enumerate(paths):
        one = os.path.join(work, f"single{si}.avi")
        st = run_dips_on_file(p, one, encoding="HFYU", properties=props,
                              batch=B, device="cuda")
        a = read(os.path.join(work, "out", f"cam{si}.dips.avi"))
        b = read(one)
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        if a.shape != b.shape or d.max() > MEDIAN_TOL["lsb"]:
            raise AssertionError(f"[fleet-file] cam{si}: the fleet's video "
                                 f"differs from run_dips_on_file's")
        _check_stats(f"[fleet-file] cam{si}", stats[si], st, 1e-6)
    log(f"[fleet-file] run_dips_on_files on 3 1080p MJPG clips "
        f"({sum(lens)} frames) in {dt:.2f} s (decode + HFYU encode "
        f"included; {card}); each diff video equals run_dips_on_file's")

    # the same files through a (3, 3) grid of cells on this card: the
    # library entry point with bands, the CLI with --slab-impl extended
    from dips_tpu_torch import cli
    from dips_tpu_torch.ops import cuda_fused
    name = "batch_step_ring_stacked"
    before = cuda_fused.launch_counts()
    gcounts, gstats = run_dips_on_files(
        paths, os.path.join(work, "grid"), encoding="HFYU", properties=props,
        batch=B, device="cuda", collect_stats=True, mesh=one_card_mesh(3, 3))
    mid = cuda_fused.launch_counts()
    rc = cli.main(["--inputs", *paths, "--output-dir",
                   os.path.join(work, "cli"), "--encoding", "HFYU",
                   "--batch", str(B), "--mesh", "3x3", "--device", "cuda:0",
                   "--slab-impl", "extended", "12"])
    after = cuda_fused.launch_counts()
    if rc != 0 or list(gcounts) != list(lens):
        raise AssertionError(f"[fleet-file] grid: counts {list(gcounts)}, "
                             f"--mesh 3x3 exit code {rc}")
    n_b = -(-max(lens) // B) * 9  # one launch per cell and batch
    n_bands = mid[f"{name}:slab_bands"] - before[f"{name}:slab_bands"]
    n_ext = after[f"{name}:dyn_rows"] - mid[f"{name}:dyn_rows"]
    if n_bands < n_b or n_ext < n_b \
            or after[name] - before[name] != n_bands + n_ext:
        raise AssertionError(f"[fleet-file] grid: {n_bands} band and "
                             f"{n_ext} extended launches of "
                             f"{after[name] - before[name]}, expected at "
                             f"least {n_b} each and no other")
    for si in range(len(paths)):
        a = read(os.path.join(work, "out", f"cam{si}.dips.avi"))
        for run in ("grid", "cli"):
            g = read(os.path.join(work, run, f"cam{si}.dips.avi"))
            if g.shape != a.shape or not np.array_equal(g, a):
                raise AssertionError(f"[fleet-file] cam{si}: the {run} run's "
                                     f"video differs from the run without "
                                     f"a mesh")
        _check_stats(f"[fleet-file] grid cam{si}", gstats[si], stats[si],
                     1e-5)
    log(f"[fleet-file] run_dips_on_files(mesh=(3, 3) cells on this card) "
        f"and the CLI's --mesh 3x3 --device cuda:0 --slab-impl extended: "
        f"{n_bands} and {n_ext} slab launches, the videos equal the run's "
        f"without a mesh byte for byte, stats within 1e-5")


# ---------------------------------------------------------------------------
# phase 8: the spatial-filter variants of both median kernels
# ---------------------------------------------------------------------------

#: (mode, window) of the variant checks and timings
VARIANTS = (("approx_median", 3), ("approx_median", 7), ("quirk_compat", 1),
            ("quirk_compat", 3), ("quirk_compat", 5), ("quirk_compat", 7))
#: the variants the [options] engines and fleets run (the record's rows)
MAIN_VARIANTS = {"approx_median": 7, "quirk_compat": 5}


def variant_props(mode, w, **kw):
    from dips_tpu_torch.properties import DiPsProperties
    return DiPsProperties(window_size=w, **{mode: True}, **kw)


def phase_kernels_variants():
    """Each median wrapper in each variant against its plain twin: 1080p
    s = 1 and 480p x 3 stacked streams (noisy next to white); the
    [options] variants (approx w7, quirk w5) also at the shapes their
    engines, fleets and timings give them: 1080p x 8 stacked, and the
    downscale fleet's 540 x 960 (Hp 544: padding rows) at s = 1 and x 8.
    The tail checks have a flagged invalid slot.  Carried state exact on
    the true region, maps within MEDIAN_TOL, stats within 1e-5."""
    from dips_tpu_torch.properties import (DiPsFilter, DiPsMethod,
                                           OutputMode)
    checks = {"batch_step_ring": check_median,
              "batch_step_ring_stacked": check_stacked,
              "batch_step": lambda p, h, w, seed: check_tail(p, h, w, 1,
                                                             seed),
              "batch_step_stacked": check_tail}
    shapes = {"batch_step_ring": [(H1080, W1080)],
              "batch_step_ring_stacked": [(480, 640, 3)],
              "batch_step": [(H1080, W1080)],
              "batch_step_stacked": [(480, 640, 3)]}
    main_shapes = {"batch_step_ring": [(540, 960)],
                   "batch_step_ring_stacked": [(H1080, W1080, FLEET),
                                               (540, 960, FLEET)],
                   "batch_step": [(540, 960)],
                   "batch_step_stacked": [(H1080, W1080, FLEET),
                                          (540, 960, FLEET)]}
    errs, n = {}, 0
    for i, (mode, w) in enumerate(VARIANTS):
        # alternate the method, output and filter across the variants
        kw = [dict(), dict(method=DiPsMethod.PER_FRAME,
                           output=OutputMode.GRAYSCALE,
                           filter=DiPsFilter.INVERSE_SIGMOID,
                           temporal_size=3)][i % 2]
        runs = [(variant_props(mode, w, **kw), shapes)]
        if MAIN_VARIANTS.get(mode) == w:  # the [options] runs' properties
            runs.append((variant_props(mode, w), main_shapes))
        for props, at in runs:
            for name, fn in checks.items():
                key = f"{name}:{mode}"
                for args in at[name]:
                    errs[key] = max(errs.get(key, 0.0),
                                    fn(props, *args, 65 + i))
                    n += 1
    log(f"[kernels-variants] {n} checks of {len(VARIANTS)} variants x 4 "
        f"median wrappers: carried state exact, maps within "
        f"{MEDIAN_TOL['lsb']} LSB, stats within {MEDIAN_TOL['stats_rtol']}")
    return errs


# ---------------------------------------------------------------------------
# phase 9: the engine options (downscale, packed_wire, planar) and the
# variant engines and fleets
# ---------------------------------------------------------------------------

H4K, W4K = 2160, 3840


def _equal(tag, got, exp):
    """Maps byte for byte, stats bit for bit."""
    if not (np.array_equal(got[0], exp[0]) and np.array_equal(got[1],
                                                              exp[1])):
        raise AssertionError(f"{tag}: outputs differ")


def options_downscale(work):
    """A 4K engine with downscale=2 against a 1080p engine fed
    pool_frame_host frames, COLORIZE (ring) and THRESHOLD (tail), with a
    checkpoint resume before the third batch."""
    from dips_tpu_torch import DiPsEngine, DiPsProperties, OutputMode
    from dips_tpu_torch.ops.reference import pool_frame_host
    batches = [moving_square_frames(B, H4K, W4K, 51, start=i * B)
               for i in range(3)]
    pooled = [np.stack([pool_frame_host(f, 2) for f in fb]) for fb in batches]
    for label, props, ring in (
            ("COLORIZE ring", DiPsProperties(refresh_markers=(24,)), True),
            ("THRESHOLD tail", DiPsProperties(output=OutputMode.THRESHOLD,
                                              refresh_markers=(24,)), False)):
        ek = DiPsEngine(props, H4K, W4K, batch=B, device="cuda",
                        ring_carry=ring, downscale=2)
        e1 = DiPsEngine(props, H1080, W1080, batch=B, device="cuda",
                        ring_carry=ring)
        if (ek.height, ek.width, ek.in_height) != (H1080, W1080, H4K):
            raise AssertionError(f"downscale geometry {ek.height}x{ek.width}")
        for bi in range(3):
            if bi == 2:
                ck = os.path.join(work, "downscale.npz")
                ek.save(ck)
                resumed = DiPsEngine(props, H4K, W4K, batch=B, device="cuda",
                                     ring_carry=ring, downscale=2)
                resumed.load(ck)
                r = resumed.process_batch(list(batches[bi]))
            got = ek.process_batch(list(batches[bi]))
            _equal(f"[options] downscale {label} batch {bi}", got,
                   e1.process_batch(list(pooled[bi])))
        _equal(f"[options] downscale {label} resumed", r, got)
        log(f"[options] downscale=2 {label}: a 4K engine equals a 1080p "
            f"engine fed pool_frame_host frames over {3 * B} frames, byte "
            f"for byte, checkpoint resume included")


def options_packed():
    """A packed_wire THRESHOLD engine against the unpacked one, ring and
    tail; packed batches equal pack_mask_host of the padded masks."""
    from dips_tpu_torch import DiPsEngine, DiPsProperties, OutputMode
    from dips_tpu_torch.ops import wire
    from dips_tpu_torch.ops.reference import pad_geometry
    hp, wp = pad_geometry(H1080, W1080)
    props = DiPsProperties(output=OutputMode.THRESHOLD, refresh_markers=(20,))
    frames = moving_square_frames(3 * B, H1080, W1080, 53)
    for ring in (True, False):
        pk = DiPsEngine(props, H1080, W1080, batch=B, device="cuda",
                        ring_carry=ring, packed_wire=True)
        un = DiPsEngine(props, H1080, W1080, batch=B, device="cuda",
                        ring_carry=ring)
        n_bytes = [0, 0]
        for bi in range(3):
            fb = list(frames[bi * B:(bi + 1) * B])
            exp = un.process_batch(fb)
            if bi % 2:  # the engine unpacks
                _equal(f"[options] packed_wire batch {bi}",
                       pk.process_batch(fb), exp)
                continue
            packed, st = pk.process_batch(fb, packed=True)
            pad = np.zeros((B, 1, hp, wp), np.uint8)
            pad[:, 0, :H1080, :W1080] = exp[0][..., 0]
            if not (np.array_equal(packed, wire.pack_mask_host(pad))
                    and np.array_equal(st, exp[1])):
                raise AssertionError(f"[options] packed_wire batch {bi}: "
                                     f"packed bytes differ")
            n_bytes[0] += packed.nbytes
            n_bytes[1] += exp[0].nbytes
        log(f"[options] packed_wire THRESHOLD 1080p {'ring' if ring else 'tail'}"
            f": equals the unpacked engine over {3 * B} frames, and the "
            f"packed batches equal pack_mask_host of the padded masks "
            f"({n_bytes[0]} packed bytes for {n_bytes[1]} unpacked)")


def options_planar():
    """A planar-layout engine (host planarize) against the hwc one."""
    from dips_tpu_torch import DiPsEngine, DiPsProperties
    props = DiPsProperties(refresh_markers=(20,))
    frames = moving_square_frames(3 * B, H1080, W1080, 55)
    for ring in (True, False):
        engs = [DiPsEngine(props, H1080, W1080, batch=B, device="cuda",
                           ring_carry=ring, input_layout=layout)
                for layout in ("planar", "hwc")]
        if engs[0].tail_rows != (0 if ring else props.temporal_size):
            raise AssertionError(f"planar tail_rows {engs[0].tail_rows}")
        for bi, k in enumerate((B, 11, B)):
            fb = list(frames[bi * B:bi * B + k])
            _equal(f"[options] planar batch {bi}",
                   *(e.process_batch(fb) for e in engs))
    log(f"[options] input_layout='planar' COLORIZE 1080p, ring and tail: "
        f"equals the hwc engine over 3 batches (one partial), byte for "
        f"byte")


def held_engine(eng):
    """Wrap ``eng``'s launches so that each batch also runs the plain twin
    of its step on a copy of the same state and input, and is held
    against it (MEDIAN_TOL; carried state exact on the true region)."""
    import torch
    from dips_tpu_torch.ops import cuda_fused as cf
    h, w, props = eng.height, eng.width, eng.props
    launch_ring, launch_tail = eng._launch_ring, eng._launch_tail
    held = {"batches": 0, "flips": 0, "px": 0}

    def compare(tag, got, exp, state_got, state_exp):
        d = (got[0][..., :h, :w].to(torch.int16)
             - exp[0][..., :h, :w].to(torch.int16)).abs()
        held["flips"] += int((d > 0).sum())
        held["px"] += d.numel()
        if int(d.max()) > MEDIAN_TOL["lsb"] or \
                held["flips"] > MEDIAN_TOL["flip_frac"] * held["px"]:
            raise AssertionError(f"{tag}: maps differ")
        for g, e in zip(state_got[:-1], state_exp[:-1]):
            if not torch.equal(g[..., :h, :w], e[..., :h, :w]):
                raise AssertionError(f"{tag}: carried state differs")
        if _max_err(state_got[-1], state_exp[-1]) > MEDIAN_TOL["heat_atol"]:
            raise AssertionError(f"{tag}: heatmap differs")
        _check_stats(tag, got[1], exp[1], MEDIAN_TOL["stats_rtol"])
        held["batches"] += 1

    def ring_step(raw, flags, valid):
        state = [x.clone() for x in (eng._ring, eng._prev, eng._baseline,
                                     eng._heatmap)]
        off, seed = eng._ring_off, 0 if eng._seeded else 1
        x = raw.clone()
        got = launch_ring(raw, flags, valid)
        exp = cf.batch_step_ring_plain(props, h, w, x, *state[:3], flags,
                                       state[3], valid, off, seed)
        compare(f"[options] {ptag(props)} ring batch {held['batches']}",
                got, exp, [eng._ring, eng._prev, eng._baseline,
                           eng._heatmap], state)
        return got

    def tail_step(raw, flags, valid):
        state = [eng._baseline.clone(), eng._heatmap.clone()]
        x = raw.clone()
        got = launch_tail(raw, flags, valid)
        exp = cf.batch_step_plain(props, h, w, x, state[0], flags, state[1],
                                  valid)
        compare(f"[options] {ptag(props)} tail batch {held['batches']}",
                got, exp, [eng._baseline, eng._heatmap], state)
        return got

    eng._launch_ring, eng._launch_tail = ring_step, tail_step
    return held


def options_variant_engines(card):
    """The approx w7 and quirk w5 COLORIZE engines over 64 frames in
    uneven batches with a refresh marker and a snapshot, ring and tail,
    every batch held against the plain twins of its step.  Returns the
    variants' launches during these runs."""
    import torch
    from dips_tpu_torch import DiPsEngine
    from dips_tpu_torch.ops import cuda_fused
    frames = moving_square_frames(SPLIT_FRAMES, H1080, W1080, 57)
    cuda_fused.reset_launch_counts()
    helds = []
    for mode, w in MAIN_VARIANTS.items():
        props = variant_props(mode, w, refresh_markers=(48,))
        for ring in (True, False):
            eng = DiPsEngine(props, H1080, W1080, batch=B, device="cuda",
                             ring_carry=ring)
            helds.append(held_engine(eng))
            _, out, stats = run_split(props, frames, ring, engine=eng)
            if out.shape != (len(frames), H1080, W1080, 3) or \
                    not np.isfinite(stats).all():
                raise AssertionError(f"[options] {ptag(props)}: bad output")
            if (stats[[0, 48, 59], 3] != 0).any() or stats[20, 3] == 0:
                raise AssertionError(f"[options] {ptag(props)}: captures "
                                     f"{stats[:, 3]}")
    torch.cuda.synchronize()
    counts = cuda_fused.launch_counts()
    launches = {k: counts[k] for k in counts if ":" in k
                and not k.split(":")[0].endswith("stacked")}
    log(f"[options] launches during the variant engine runs: {launches}")
    log(f"[options] approx w7 and quirk w5 COLORIZE 1080p, ring and tail, "
        f"{len(frames)} frames in batches {SPLITS} (those that start before "
        f"frame {len(frames)}): {sum(h['batches'] for h in helds)} "
        f"batches held against the plain twins on the same state; tie flips "
        f"{sum(h['flips'] for h in helds)}/{sum(h['px'] for h in helds)}")
    return launches


def _fleet_vs_engines(tag, props, frame, ring, **kw):
    """Two batches of a 1080p x 8 fleet (stream 7 partial in the first)
    against single-stream engines fed each stream's frames: maps byte for
    byte, stats within 1e-6."""
    from dips_tpu_torch import DiPsEngine, MultiStreamEngine
    fleet = MultiStreamEngine(props, H1080, W1080, FLEET, batch=B,
                              device="cuda", ring_carry=ring, **kw)
    single = [DiPsEngine(props, H1080, W1080, batch=B, device="cuda",
                         ring_carry=ring, downscale=kw.get("downscale", 1))
              for _ in range(FLEET)]
    nxt = [0] * FLEET
    for bi in range(2):
        feeds = [[frame(si, nxt[si] + k)
                  for k in range(10 if bi == 0 and si == 7 else B)]
                 for si in range(FLEET)]
        out, stats, _ = fleet.process_batch(feeds)
        for si, fs in enumerate(feeds):
            o, st = single[si].process_batch(fs)
            if not np.array_equal(out[si, :len(fs)], o):
                raise AssertionError(f"{tag} stream {si} batch {bi}: maps "
                                     f"differ from the single engine")
            _check_stats(f"{tag} stream {si} batch {bi}",
                         stats[si, :len(fs)], st, 1e-6)
            nxt[si] += len(fs)


def options_fleets(card):
    """The 1080p x 8 fleet with packed_wire (THRESHOLD), and 1080p x 8
    fleets with downscale=2 running the approx w7 and quirk w5 variants,
    ring and tail, each against single-stream engines.  Returns the
    stacked variants' launches during the downscale fleets."""
    import torch
    from dips_tpu_torch import DiPsProperties, OutputMode
    from dips_tpu_torch.ops import cuda_fused
    frame = FleetFrames(75)
    for ring in (True, False):
        _fleet_vs_engines(f"[options] packed fleet {ring}", DiPsProperties(
            output=OutputMode.THRESHOLD), frame, ring, packed_wire=True)
    log("[options] packed_wire THRESHOLD fleet 1080p x 8, ring and tail: "
        "every stream equals its single-stream engine byte for byte")
    cuda_fused.reset_launch_counts()
    for mode, w in MAIN_VARIANTS.items():
        for ring in (True, False):
            _fleet_vs_engines(f"[options] downscale fleet {mode} {ring}",
                              variant_props(mode, w, refresh_markers=(8,)),
                              frame, ring, downscale=2)
    torch.cuda.synchronize()
    counts = cuda_fused.launch_counts()
    launches = {k: counts[k] for k in counts if ":" in k
                and k.split(":")[0].endswith("stacked")}
    log(f"[options] launches during the downscale fleets: {launches}")
    log("[options] downscale=2 fleets 1080p x 8 (540x960 analysis), approx "
        "w7 and quirk w5, ring and tail: every stream equals a "
        "single-stream downscale engine (maps byte for byte, stats within "
        "1e-6)")
    return launches


def phase_options(card):
    work = os.path.join("build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    options_downscale(work)
    options_packed()
    options_planar()
    launches = options_variant_engines(card)
    launches.update(options_fleets(card))
    return launches


# ---------------------------------------------------------------------------
# phase 6d': the box mean of a downscaled engine (csrc/pool_prep.cu)
# ---------------------------------------------------------------------------

def pool_bound_ms(h, w, k):
    """Least ms per frame of a pool launch, a frame analysed at ``h`` x
    ``w``: each input byte read once (3k² an output pixel) and each output
    byte written once (3), over the memory rate."""
    return h * w * 3 * (k * k + 1) / HBM_BYTES_PER_S * 1e3


def phase_pool(card):
    """``[pool]``: ``cuda_fused.pool_prep`` against ``pool_prep_plain``
    byte for byte (padding included) at the main path's shapes, 16 x 4K
    frames in, k = 2, hwc and hwc_bgr; the launches of a
    ``DiPsEngine(downscale=2)`` main-path run, the counts reset just
    before; the kernel and the plain prep timed (CUDA events, ms a
    frame) beside the bound.  Returns the record's errs, launches and
    times."""
    import torch
    from dips_tpu_torch import DiPsEngine, DiPsProperties
    from dips_tpu_torch.ops import cuda_fused
    from dips_tpu_torch.ops.reference import pad_geometry
    name, k = "pool_prep", 2
    dev = torch.device("cuda")
    hp, wp = pad_geometry(H1080, W1080)
    frames = torch.from_numpy(moving_square_frames(B, H4K, W4K, 61)).to(dev)
    got = torch.full((B, 3, hp, wp), 0x5A, dtype=torch.uint8, device=dev)
    exp = torch.full_like(got, 0x5A)
    for swap in (False, True):
        cuda_fused.pool_prep(frames, got, k, swap)
        cuda_fused.pool_prep_plain(frames, exp, k, swap)
        torch.cuda.synchronize()
        if not torch.equal(got, exp):
            bad = int((got != exp).sum())
            raise AssertionError(f"[pool] {'hwc_bgr' if swap else 'hwc'}: "
                                 f"{bad} bytes differ from the plain prep")
    log(f"[pool] pool_prep 4K -> 1080p k={k} B={B}, hwc and hwc_bgr: "
        f"byte-equal to the plain prep, padding included")

    batches = [moving_square_frames(B, H4K, W4K, 62, start=i * B)
               for i in range(3)]
    eng = DiPsEngine(DiPsProperties(), H4K, W4K, batch=B, device="cuda",
                     downscale=k)
    cuda_fused.reset_launch_counts()
    for fb in batches:
        eng.process_batch(list(fb))
    torch.cuda.synchronize()
    counts = cuda_fused.launch_counts()
    launches = {name: counts[name]}
    log(f"[pool] launches during the DiPsEngine(downscale=2) run: {counts}")
    if counts[name] != len(batches) or counts["batch_step_ring"] != len(
            batches):
        raise AssertionError(f"[pool] {counts[name]} pool and "
                             f"{counts['batch_step_ring']} median launches "
                             f"over {len(batches)} batches")
    del eng

    ms = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = cuda_fused.pool_prep if which == "kernel" else \
            cuda_fused.pool_prep_plain
        ms[which].append(_time(lambda: fn(frames, got, k), 20) / B)
    res = {w: float(np.mean(v)) for w, v in ms.items()}
    res.update(bound_ms=pool_bound_ms(H1080, W1080, k), bound_by="bytes")
    log(f"[time] pool_prep 4K -> 1080p k={k} B={B}: kernel "
        f"{res['kernel']:.5f} ms/frame ({ms['kernel']}), plain "
        f"{res['plain']:.5f} ms/frame ({ms['plain']}), bound "
        f"{res['bound_ms']:.5f} ms/frame by bytes "
        f"({100 * res['bound_ms'] / res['kernel']:.1f}%); {card}")
    return {"errs": {name: 0.0}, "launches": launches,
            "times": {name: res}}


# ---------------------------------------------------------------------------
# phase 6e: the row-slab forms of the kernels
# ---------------------------------------------------------------------------

H8K, W8K = 4320, 7680
#: the row-slab forms in the kernels' record
SLAB_NAMES = ("absdiff_step_ring_stacked:dyn_rows",
              "absdiff_step_stacked:dyn_rows",
              "batch_step_ring_stacked:slab_bands",
              "batch_step_stacked:slab_bands",
              "batch_step_ring_stacked:dyn_rows",
              "batch_step_stacked:dyn_rows")


def one_card_mesh(s_ax, r_ax):
    """A (stream, rows) grid whose cells all name this one card."""
    from dips_tpu_torch.parallel import grid_mesh
    return grid_mesh(s_ax, r_ax, devices=["cuda:0"] * (s_ax * r_ax))


def noise_frames(n, h, w, s, seed, dev):
    """(n, 3, s*Hp, Wp) u8 on the card: fresh seeded noise in every frame
    of every stream's true region, so every tap matters."""
    import torch
    from dips_tpu_torch.ops.reference import pad_geometry
    hp, wp = pad_geometry(h, w)
    g = torch.Generator(device=dev).manual_seed(seed)
    raw = torch.zeros((n, 3, s, hp, wp), dtype=torch.uint8, device=dev)
    raw[..., :h, :w] = torch.randint(0, 256, (n, 3, s, h, w), generator=g,
                                     dtype=torch.uint8, device=dev)
    return raw.view(n, 3, s * hp, wp)


def _raw_mode(props):
    from dips_tpu_torch.properties import OutputMode
    return props.output in (OutputMode.ABSDIFF, OutputMode.THRESHOLD,
                            OutputMode.STATS_ONLY)


def _slab_state(props, rows, ring, dev):
    """Zero carried state of row-stacked ``rows``: [ring, prev,] baseline,
    heatmap (raw modes: [prev,] baseline, heatmap)."""
    import torch
    t = props.temporal_size
    if _raw_mode(props):
        st = [torch.zeros((3,) + rows, dtype=torch.uint8, device=dev)
              for _ in range(2 if ring else 1)]
    else:
        st = ([torch.zeros((t,) + rows, device=dev),
               torch.zeros(rows, device=dev)] if ring else []) + [
            torch.zeros(rows, device=dev)]
    return st + [torch.zeros(rows, device=dev)]


def _slab_call(fn, props, h, w, s, x, st, flags, valid, offs, seeds, ring,
               **kw):
    """One stacked step in either protocol and mode, state ``st`` as
    :func:`_slab_state` lays it out."""
    if ring and _raw_mode(props):
        return fn(props, h, w, s, x, st[0], st[1], flags, st[2], valid, seeds,
                  **kw)
    if ring:
        return fn(props, h, w, s, x, *st[:3], flags, st[3], valid, offs,
                  seeds, **kw)
    return fn(props, h, w, s, x, st[0], flags, st[1], valid, **kw)


def _step_fns(props, ring):
    from dips_tpu_torch.ops import cuda_fused as cf
    name = ("absdiff_step" if _raw_mode(props) else "batch_step") + (
        "_ring" if ring else "") + "_stacked"
    return name, getattr(cf, name), getattr(cf, name + "_plain")


def check_slab_twin(props, h, w, r_ax, s, ring, seed, bands=True,
                    extended=False, b=None):
    """Each of the r_ax row slabs of s stacked streams through the slab
    form of its kernel and through the plain twin, two carried batches of
    ``b`` (default B) frames: maps byte-equal or within 1 LSB, state exact
    on the true columns, stats within 1e-5.  ``extended``: the halo-extended
    construction as ``grid2d._slab_body`` / ``_slab_body_ring`` launch it --
    the bands concatenated around every section (Hs + 16 rows), the state
    zero-padded in and its owned rows sliced out, the row window shifted by
    8, no band inputs.  Returns (record name, max error)."""
    import torch
    from dips_tpu_torch.ops.reference import pad_geometry
    from dips_tpu_torch.parallel import grid2d
    from dips_tpu_torch.parallel.mesh import Layout
    b = B if b is None else b
    dev = torch.device("cuda")
    hp, wp = pad_geometry(h, w)
    hs = hp // r_ax
    t = props.temporal_size
    raw_mode = _raw_mode(props)
    name, kernel, plain = _step_fns(props, ring)
    lay = Layout(one_card_mesh(1, r_ax), s, hp, wp)
    states = [[_slab_state(props, (s * hs, wp), ring, dev)
               for _ in range(r_ax)] for _ in range(2)]
    tol = RAW_TOL if raw_mode else MEDIAN_TOL
    bands = bands and not raw_mode and not extended
    form = "slab_bands" if bands else "dyn_rows"
    tag = (f"{name}:{form} {props.output.name} {props.method.name} "
           f"{ptag(props)} {h}x{w} R={r_ax} s={s}"
           + (f" extended ({hs + 2 * grid2d._EXT}-row sections)"
              if extended else ""))
    err, flips, n_px = 0.0, 0, 0
    frames = noise_frames((0 if ring else t) + 2 * b, h, w, s, seed, dev)
    for bi, (flags, valid, offs, seeds) in enumerate(
            _stacked_batches(s, t, b)):
        if s == 1 and bi == 0:  # the all-invalid stream needs a neighbour
            valid = np.ones_like(valid)
        x = frames[bi * b:bi * b + (0 if ring else t) + b]
        cells = lay.scatter(x)[0]
        exch = grid2d._band_exchange_u8(cells, s)
        for j in range(r_ax):
            if raw_mode:
                kw = dict(row_bounds=grid2d._raw_grid_bounds(props, h, w, hs,
                                                             j))
            else:
                kw = dict(row_bounds=grid2d._slab_row_bounds(
                    props, h, w, hs, j, ext=grid2d._EXT if extended else 0))
                if bands:
                    kw["bands"] = exch[j]
            xj = (grid2d._extend(cells[j], s, *exch[j]) if extended
                  else cells[j])
            res = []
            for fn, st in zip((kernel, plain), states):
                if not extended:
                    res.append(_slab_call(fn, props, h, w, s, xj, st[j],
                                          flags, valid, offs, seeds, ring,
                                          **kw))
                    continue
                ext = [grid2d._extend(v, s) for v in st[j]]
                out, stats, *_ = _slab_call(fn, props, h, w, s, xj, ext,
                                            flags, valid, offs, seeds, ring,
                                            **kw)
                for dst, src in zip(st[j], ext):
                    grid2d._sections(dst, s).copy_(grid2d._owned(src, s))
                res.append((grid2d._stacked(grid2d._owned(out, s)), stats))
            got, exp = res
            torch.cuda.synchronize()
            d = (got[0][..., :w].to(torch.int16)
                 - exp[0][..., :w].to(torch.int16)).abs()
            if d.numel():
                flips += int((d > 0).sum())
                n_px += d.numel()
                lsb = 0 if raw_mode else tol["lsb"]
                if int(d.max()) > lsb or \
                        flips > MEDIAN_TOL["flip_frac"] * n_px:
                    raise AssertionError(f"{tag}: maps differ (max "
                                         f"{int(d.max())}, {flips} pixels)")
                err = max(err, float(d.max()))
            for g, e in zip(states[0][j][:-1], states[1][j][:-1]):
                if not torch.equal(g[..., :w], e[..., :w]):
                    raise AssertionError(f"{tag}: carried state differs")
            herr = _max_err(states[0][j][-1], states[1][j][-1])
            if herr > tol["heat_atol"]:
                raise AssertionError(f"{tag}: heatmap err {herr}")
            for si in range(s):
                _check_stats(f"{tag} slab {j} stream {si}", got[1][si],
                             exp[1][si], tol["stats_rtol"])
            err = max(err, herr, _max_err(got[1], exp[1]))
    log(f"[kernels-slabs] {tag} B={b}: every slab's maps, state and stats "
        f"match the plain twin over two batches; tie flips {flips}/{n_px}, "
        f"max err {err}")
    return f"{name}:{form}", err


def check_slab_grid(props, h, w, r_ax, s, ring, impl, seed, b=B):
    """s streams split into r_ax row slabs (one cell each, the streams
    stacked in the cell) through ``grid2d``'s step against the full-height
    stacked kernel, two carried batches: maps and carried state bit for
    bit, stats within 1e-5."""
    import torch
    from dips_tpu_torch.ops.reference import pad_geometry
    from dips_tpu_torch.parallel import grid2d
    dev = torch.device("cuda")
    hp, wp = pad_geometry(h, w)
    t = props.temporal_size
    raw_mode = _raw_mode(props)
    mesh = one_card_mesh(1, r_ax)
    step = (grid2d.make_grid_ring_step(props, h, w, mesh, slab_impl=impl)
            if ring else grid2d.make_grid_step(props, h, w, mesh,
                                               backend="kernel",
                                               slab_impl=impl))
    _, kernel, _ = _step_fns(props, ring)
    full = _slab_state(props, (s * hp, wp), ring, dev)
    # the grid step's arguments lead with the stream axis
    lead = [1 if x.dim() == 3 else 0 for x in full]
    grid = [x.view(x.shape[:d] + (s, hp, wp)).movedim(d, 0).clone()
            for x, d in zip(full, lead)]
    tag = (f"{props.output.name} {props.method.name} {ptag(props)} {h}x{w} "
           f"R={r_ax} s={s} {'ring' if ring else 'tail'} {impl}")
    frames = noise_frames((0 if ring else t) + 2 * b, h, w, s, seed, dev)
    offs, seeds = np.arange(s) % t, np.ones(s, np.int64)
    for bi in range(2):
        x = frames[bi * b:bi * b + (0 if ring else t) + b]
        flags = np.zeros((s, b), bool)
        flags[:, (bi + 1) % b] = True
        valid = np.ones((s, b), bool)
        valid[s - 1, b - 1] = bi == 0
        exp = _slab_call(kernel, props, h, w, s, x, full, flags, valid, offs,
                         seeds, ring)
        xs = x.view(x.shape[:2] + (s, hp, wp)).movedim(2, 0)
        if ring and raw_mode:
            got = step(xs, grid[0], grid[1], flags, grid[2], valid, seeds)
        elif ring:
            got = step(xs, *grid[:3], flags, grid[3], valid, offs, seeds)
        else:
            got = step(xs, grid[0], flags, grid[1], valid)
        torch.cuda.synchronize()
        out = got[0].movedim(0, 2).reshape(exp[0].shape)
        if not torch.equal(out, exp[0]):
            raise AssertionError(f"[kernels-slabs] {tag} batch {bi}: the "
                                 f"slabs' maps differ from the full-height "
                                 f"kernel's")
        for g, f, d in zip(grid, full, lead):
            if not torch.equal(g.movedim(0, d).reshape(f.shape), f):
                raise AssertionError(f"[kernels-slabs] {tag} batch {bi}: "
                                     f"carried state differs")
        for si in range(s):
            _check_stats(f"[kernels-slabs] {tag} stream {si}", got[1][si],
                         exp[1][si], 1e-5)
        offs, seeds = (offs + b) % t, np.zeros(s, np.int64)
    log(f"[kernels-slabs] {tag} B={b}: {r_ax} slabs equal the full-height "
        f"kernel bit for bit (maps, carried state; stats within 1e-5) over "
        f"two carried batches")


def phase_kernels_slabs():
    from dips_tpu_torch.ops import cuda_fused
    from dips_tpu_torch.properties import (DiPsFilter, DiPsMethod,
                                           DiPsProperties, OutputMode)
    errs = dict.fromkeys(SLAB_NAMES, 0.0)
    roi = (400, 100, 1000, 1700)  # misses the first of three 360-row slabs
    raw = DiPsProperties(output=OutputMode.ABSDIFF, roi=roi)
    w5 = DiPsProperties(window_size=5, temporal_size=3,
                        method=DiPsMethod.PER_FRAME,
                        output=OutputMode.GRAYSCALE,
                        filter=DiPsFilter.INVERSE_SIGMOID)
    # rows 5, 9 and 13 of the kernel table against their plain twins
    for props, s, ring, bands in (
            (DiPsProperties(roi=roi), 2, True, True),
            (w5, 1, True, True),
            (DiPsProperties(window_size=7, temporal_size=2), 1, False, True),
            (variant_props("approx_median", 7), 2, False, True),
            (variant_props("quirk_compat", 5), 1, True, True),
            (DiPsProperties(roi=roi), 2, True, False),
            (w5, 1, False, False),
            (raw, 2, True, True), (raw, 2, False, True),
            (DiPsProperties(output=OutputMode.THRESHOLD,
                            method=DiPsMethod.PER_FRAME, roi=roi), 1, True,
             True)):
        name, e = check_slab_twin(props, H1080, W1080, 3, s, ring, 81, bands)
        errs[name] = max(errs[name], e)
    # the same at the shapes the main path ([grid]) launches: a cell of the
    # (2, 3) grid stacks FLEET / 2 = 4 streams' 360-row slabs -- COLORIZE
    # w3/T4 with bands and in the extended construction (376-row sections,
    # the row window shifted by 8), ABSDIFF with the roi, both protocols --
    # and the slabs of the 8K stream below (R = 4, B = 4)
    s_l = FLEET // GRID[0]
    for props, ring, kw in (
            (DiPsProperties(), True, {}), (DiPsProperties(), False, {}),
            (DiPsProperties(), True, dict(extended=True)),
            (DiPsProperties(), False, dict(extended=True)),
            (raw, True, {}), (raw, False, {})):
        name, e = check_slab_twin(props, H1080, W1080, GRID[1], s_l, ring,
                                  84, **kw)
        errs[name] = max(errs[name], e)
    name, e = check_slab_twin(DiPsProperties(), H8K, W8K, 4, 1, True, 85,
                              b=4)
    errs[name] = max(errs[name], e)
    # the slab compositions against the full-height kernels, bit for bit
    before = cuda_fused.launch_counts()
    check_slab_grid(DiPsProperties(), H8K, W8K, 4, 1, True, "bands", 82, b=4)
    for props, s, ring, impl in (
            (w5, 1, True, "bands"),
            (DiPsProperties(window_size=7, temporal_size=2), 1, True,
             "bands"),
            (variant_props("approx_median", 7), 1, True, "bands"),
            (variant_props("quirk_compat", 5), 1, True, "bands"),
            (DiPsProperties(roi=roi), 2, False, "bands"),
            (w5, 1, True, "extended"),
            (DiPsProperties(window_size=7, temporal_size=2), 2, False,
             "extended"),
            (raw, 1, True, "bands"), (raw, 2, False, "bands")):
        check_slab_grid(props, H1080, W1080, 3, s, ring, impl, 83)
    after = cuda_fused.launch_counts()
    for name in SLAB_NAMES:
        if after[name] <= before[name]:
            raise AssertionError(f"{name} was not launched by the slab "
                                 f"compositions")
    return errs


# ---------------------------------------------------------------------------
# phase 6f: the fleet on a (stream, rows) grid
# ---------------------------------------------------------------------------

GRID = (2, 3)  # stream shards x row slabs: 4 streams x 360 rows per cell


def _same_fleet_runs(tag, got, exp):
    """Two fleet runs batch by batch: the same streams accepted, maps byte
    for byte, stats within 1e-5."""
    for bi, ((idx, go, gs), (eidx, eo, es)) in enumerate(zip(got, exp)):
        if idx != eidx:
            raise AssertionError(f"{tag} batch {bi}: accepted frames differ")
        for si, ids in enumerate(idx):
            if ids is not None:
                k = len(ids)
                _same_run(f"{tag} stream {si} batch {bi}",
                          (go[si, :k], gs[si, :k]), (eo[si, :k], es[si, :k]))


def _same_fleet_state(tag, got, exp):
    for key in ("baseline", "heatmaps"):
        if not np.array_equal(got[key], exp[key]):
            raise AssertionError(f"{tag}: carried {key} differs")


def run_grid_batches(props, frame, n_batches, ring_carry, mesh,
                     slab_impl="bands"):
    """``n_batches`` full batches of the 8-stream fleet -> ([(indices,
    out, stats)], carried state)."""
    from dips_tpu_torch import MultiStreamEngine
    fleet = MultiStreamEngine(props, H1080, W1080, FLEET, batch=B,
                              device="cuda", ring_carry=ring_carry,
                              mesh=mesh, slab_impl=slab_impl)
    batches = []
    for bi in range(n_batches):
        idx = [list(range(bi * B, (bi + 1) * B))] * FLEET
        out, stats, _ = fleet.process_batch(
            [[frame(si, k) for k in ids] for si, ids in enumerate(idx)])
        if not np.isfinite(stats).all():
            raise AssertionError("non-finite stats")
        batches.append((idx, out, stats))
    return batches, dict(baseline=fleet.state_dict()["baseline"],
                         heatmaps=fleet.heatmaps())


def phase_grid(card):
    """The row-slab path at full width through the fleet engine: 1080p x 8
    streams on a (2, 3) grid of cells that all name this card."""
    import torch
    from dips_tpu_torch import DiPsProperties, OutputMode
    from dips_tpu_torch.ops import cuda_fused
    work = os.path.join("build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    cells = GRID[0] * GRID[1]
    mesh = one_card_mesh(*GRID)
    launches = dict.fromkeys(SLAB_NAMES, 0)

    def counted(name, expect, fn, *args, **kw):
        """Run one grid path with the counts at 0; it must launch slab form
        ``name`` exactly ``expect`` times and no full-height kernel."""
        cuda_fused.reset_launch_counts()
        res = fn(*args, **kw)
        torch.cuda.synchronize()
        counts = cuda_fused.launch_counts()
        base = name.split(":")[0]
        if counts[name] != expect or counts[base] != expect:
            raise AssertionError(f"[grid] {name}: {counts[name]} launches "
                                 f"of {counts[base]}, expected {expect}")
        launches[name] += counts[name]
        return res

    # COLORIZE w3/T4, ring-carry, bands: the three batches of [fleet] (a
    # lagging stream, a snapshot, an isolated and revived stream).  Before
    # the third batch a fresh grid fleet resumes from the checkpoint that
    # the fleet without a mesh saved at that point in [fleet] (the state is
    # scattered over the cells and each cell rebuilds its ring: one more
    # launch per cell); the grid's own state comes back through its gather
    # in the comparison of the carried state below.
    ref = FLEET_REF
    state = {}
    got = counted("batch_step_ring_stacked:slab_bands", cells * 4, run_fleet,
                  ref["props"], ref["frame"], work, mesh=mesh, keep=state,
                  checkpoint="load")
    _same_fleet_runs("[grid] COLORIZE w3/T4", got, ref["batches"])
    _same_fleet_state("[grid] COLORIZE w3/T4", state, ref["state"])
    log(f"[grid] COLORIZE w3/T4 1080p x {FLEET} streams on a {GRID} grid "
        f"(Hs = {H1080 // GRID[1]}), ring-carry, bands, B={B}, 3 batches: "
        f"every stream equals the fleet without a mesh (maps, baseline and "
        f"heatmap bit for bit, stats within 1e-5), through the lagging "
        f"stream 7, the snapshot of stream 3, stream 5 isolated and revived "
        f"and a resume from the checkpoint of the fleet without a mesh; "
        f"{cells} launches per batch")
    del got
    FLEET_REF.clear()

    frame = FleetFrames(75)
    roi = (400, 100, 1000, 1700)
    absdiff = DiPsProperties(output=OutputMode.ABSDIFF, roi=roi,
                             refresh_markers=(24,))
    colorize = DiPsProperties()
    for label, props, ring, impl, name, n_b in (
            ("ABSDIFF roi ring", absdiff, True, "bands",
             "absdiff_step_ring_stacked:dyn_rows", 2),
            ("ABSDIFF roi tail", absdiff, False, "bands",
             "absdiff_step_stacked:dyn_rows", 1),
            ("COLORIZE w3/T4 tail bands", colorize, False, "bands",
             "batch_step_stacked:slab_bands", 1),
            ("COLORIZE w3/T4 tail extended", colorize, False, "extended",
             "batch_step_stacked:dyn_rows", 1),
            ("COLORIZE w3/T4 ring extended", colorize, True, "extended",
             "batch_step_ring_stacked:dyn_rows", 2)):
        got, gstate = counted(name, cells * n_b, run_grid_batches, props,
                              frame, n_b, ring, mesh, impl)
        exp, estate = run_grid_batches(props, frame, n_b, ring, None)
        _same_fleet_runs(f"[grid] {label}", got, exp)
        _same_fleet_state(f"[grid] {label}", gstate, estate)
        log(f"[grid] {label} 1080p x {FLEET} streams on a {GRID} grid, "
            f"B={B}, {n_b} batch(es): equal to the fleet without a mesh "
            f"(maps and carried state bit for bit, stats within 1e-5); "
            f"{cells} launches of {name} per batch")
        del got, exp
    return launches


# ---------------------------------------------------------------------------
# phase 6g: the post-analysis (ops/analysis.py: cuFFT and plain torch ops)
# ---------------------------------------------------------------------------

#: the [analysis] phase's clip rate and flicker frequency
FPS, FLICKER_HZ = 30.0, 5.0
#: the reference's denoise radius (image_denoise.py:22)
DENOISE_R = 75
#: where the 4K clip's square oscillates (away from the moving square)
OSC = (1500, 3000, 64)


def flicker_frames(n, h, w, seed):
    """moving_square_frames plus a grey square whose level swings at
    FLICKER_HZ (level 128 +- 100, so the lightness swings +- 200)."""
    frames = moving_square_frames(n, h, w, seed)
    y, x, side = OSC
    for k in range(n):
        v = 128 + 100 * np.cos(2 * np.pi * FLICKER_HZ * k / FPS)
        frames[k, y:y + side, x:x + side] = int(round(v))
    return frames


def write_avi(path, frames_rgb, fps=FPS):
    import cv2
    h, w = frames_rgb.shape[1:3]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
    for f in frames_rgb:
        vw.write(np.ascontiguousarray(f[..., ::-1]))
    vw.release()


def read_rgb(path):
    import cv2
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(np.ascontiguousarray(f[..., ::-1]))
    cap.release()
    return frames


def denoise_f64(maps_u8, radius):
    """numpy's float64 recipe of fft_denoise (the reference's
    image_denoise.py:13-30) on (H, W, C) uint8 maps, rounded to uint8;
    scipy's FFT on all host cores where scipy is installed."""
    try:
        import scipy.fft as sfft
        fft2 = lambda a: sfft.fft2(a, axes=(0, 1), workers=-1)  # noqa: E731
        ifft2 = lambda a: sfft.ifft2(a, axes=(0, 1),  # noqa: E731
                                     workers=-1)
    except ImportError:
        fft2 = lambda a: np.fft.fft2(a, axes=(0, 1))  # noqa: E731
        ifft2 = lambda a: np.fft.ifft2(a, axes=(0, 1))  # noqa: E731
    h, w = maps_u8.shape[:2]
    f = np.fft.fftshift(fft2(maps_u8.astype(np.float64)), axes=(0, 1))
    mask = np.zeros((h, w, 1))
    mask[max(h // 2 - radius, 0):h // 2 + radius,
         max(w // 2 - radius, 0):w // 2 + radius] = 1
    back = np.abs(ifft2(np.fft.ifftshift(f * mask, axes=(0, 1))))
    return np.clip(np.rint(back), 0, 255).astype(np.uint8)


def _lsb(tag, got, exp, flip_frac=1e-3):
    d = np.abs(got.astype(np.int16) - exp.astype(np.int16))
    flips = float((d > 0).mean())
    if got.shape != exp.shape or d.max() > 1 or flips > flip_frac:
        raise AssertionError(f"{tag}: max {d.max()} LSB, {flips:.2e} "
                             f"flipped (allowed 1 LSB, {flip_frac})")
    return int(d.max()), flips


def _amp_err(tag, got, exp, bit_for_bit):
    """Amplitude maps: equal bit for bit, or within rtol 1e-5 + atol
    1e-4; returns the maximum error."""
    err = float(np.abs(got.astype(np.float64) - exp).max())
    if bit_for_bit:
        if not np.array_equal(got, exp):
            raise AssertionError(f"{tag}: not bit for bit (max error "
                                 f"{err:.3e})")
    elif not np.allclose(got, exp, rtol=1e-5, atol=1e-4):
        raise AssertionError(f"{tag}: max error {err:.3e} beyond rtol "
                             f"1e-5 + atol 1e-4")
    return err


def median_ms(fn, trials=5, reps=3):
    """Median over ``trials`` of the CUDA-event ms per call of ``fn``."""
    return float(np.median([_time(fn, reps) for _ in range(trials)]))


def device_launches(fn):
    """(kernel launches, device ms) of one call of ``fn``, from a
    ``torch.profiler`` trace (copies and memsets not counted)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.events() if e.device_type == DeviceType.CUDA
          and not e.name.startswith(("Memcpy", "Memset"))]
    return len(ks), sum(e.time_range.end - e.time_range.start
                        for e in ks) / 1e3


def analysis_4k(card, work):
    """perform_dips on a 4K clip with denoise and a flicker callback:
    denoised maps against numpy's float64 recipe, the card's analyzer
    against the CPU's, the peak at the oscillating square, temporal_dft of
    the stats against numpy's float64 rfft."""
    from dips_tpu_torch import DiPsJob, DiPsProperties, perform_dips
    from dips_tpu_torch.ops import analysis
    n = 2 * B
    clip = os.path.abspath(os.path.join(work, "clip4k.avi"))
    write_avi(clip, flicker_frames(n, H4K, W4K, 101))
    on_card = analysis.FlickerAnalyzer(FLICKER_HZ, FPS, tau_frames=8.0,
                                       device="cuda")
    on_cpu = analysis.FlickerAnalyzer(FLICKER_HZ, FPS, tau_frames=8.0,
                                      device="cpu")

    def observe(idx, inp, out, stats):
        on_card.update(inp)
        on_cpu.update(inp)

    # (raw maps, denoised maps) of the first two frames a batch: the
    # engine denoises its device maps one frame's planes at a time
    held = []
    real = analysis.denoise_planes
    calls = [0]

    def spy(planes_u8, mask):
        den = real(planes_u8, mask)
        if calls[0] % B == 0:
            held.append(([], []))
        if calls[0] % B < 2:
            held[-1][0].append(planes_u8.permute(1, 2, 0).cpu().numpy())
            held[-1][1].append(den.permute(1, 2, 0).cpu().numpy())
        calls[0] += 1
        return den

    job = DiPsJob(properties=DiPsProperties(), video_path=clip,
                  output_path=os.path.join(work, "out4k.avi"), batch=B,
                  device="cuda", denoise_radius=DENOISE_R, frame_callback=observe)
    analysis.denoise_planes = spy
    try:
        t0 = time.perf_counter()
        stats = perform_dips(job)
        wall = time.perf_counter() - t0
    finally:
        analysis.denoise_planes = real
    if stats.shape != (n, 4) or len(held) != 2:
        raise AssertionError(f"[analysis] 4K run: stats {stats.shape}, "
                             f"{len(held)} denoised batches")
    worst = (0, 0.0)
    for raw, den in held:
        for i in range(2):
            got = _lsb("[analysis] 4K denoise vs numpy float64", den[i],
                       denoise_f64(raw[i], DENOISE_R))
            worst = max(worst, got)
    if np.array_equal(held[0][0][0], held[0][1][0]):
        raise AssertionError("[analysis] denoise left a map unchanged")
    log(f"[analysis] perform_dips 4K COLORIZE w3/T4 B={B}, {n} frames, "
        f"denoise_radius={DENOISE_R}, flicker callback: {wall:.2f} s (decode, CPU "
        f"analyzer and MJPG encode included); 4 denoised maps against "
        f"numpy's float64 recipe: max {worst[0]} LSB, {worst[1]:.2e} "
        f"flipped; {card}")
    a_card, a_cpu = on_card.amplitude(), on_cpu.amplitude()
    err = _amp_err("[analysis] 4K flicker, card vs CPU", a_card, a_cpu,
                   bit_for_bit=False)
    py, px = np.unravel_index(int(np.argmax(a_card)), a_card.shape)
    y, x, side = OSC
    if not (y <= py < y + side and x <= px < x + side):
        raise AssertionError(f"[analysis] 4K flicker peak at ({py}, {px}), "
                             f"not in the oscillating square")
    log(f"[analysis] FlickerAnalyzer(cuda) over the callback's {n} 4K "
        f"frames against FlickerAnalyzer(cpu): max error {err:.3e}, bit "
        f"for bit: {bool(np.array_equal(a_card, a_cpu))}; peak "
        f"{float(a_card[py, px]):.1f} at y={py} x={px}, inside the "
        f"oscillating square")
    mag, phase = analysis.temporal_dft(stats, device="cuda")
    f64 = np.fft.rfft(stats.astype(np.float64), axis=0)
    scale = np.abs(f64).max(axis=0)
    rel = float((np.abs(mag.cpu().numpy() - np.abs(f64)) / scale).max())
    if mag.shape != (n // 2 + 1, 4) or rel > 1e-5:
        raise AssertionError(f"[analysis] temporal_dft of the stats: "
                             f"shape {tuple(mag.shape)}, max error {rel:.2e}"
                             f" of the column maximum")
    log(f"[analysis] temporal_dft of the run's ({n}, 4) stats against "
        f"numpy's float64 rfft: max error {rel:.2e} of each column's "
        f"maximum")
    return clip, stats


def analysis_fleet(card, frame):
    """FleetFlickerAnalyzer at 1080p x 8 against 8 single-stream analyzers
    on the card, bit for bit, over ragged rounds with stream 2 gated off
    in the first."""
    from dips_tpu_torch.ops import analysis
    fleet = analysis.FleetFlickerAnalyzer(FLEET, device="cuda")
    fleet.configure_all(FLICKER_HZ, FPS)
    singles = [analysis.FlickerAnalyzer(FLICKER_HZ, FPS, batch=B,
                                        device="cuda")
               for _ in range(FLEET)]
    rounds = ((16, 16, 0, 16, 16, 16, 16, 16),
              (16, 9, 16, 3, 16, 0, 16, 12),
              (7, 16, 16, 16, 1, 16, 16, 16))
    cursor = [0] * FLEET
    for counts in rounds:
        feeds = []
        for si, c in enumerate(counts):
            feeds.append([frame(si, k)
                          for k in range(cursor[si], cursor[si] + c)])
            cursor[si] += c
            if c:
                singles[si].update(np.stack(feeds[-1]))
        fleet.update(feeds)
    for si in range(FLEET):
        _amp_err(f"[analysis] fleet stream {si} vs its single analyzer",
                 fleet.amplitude(si), singles[si].amplitude(),
                 bit_for_bit=True)
        if fleet.frames_seen[si] != cursor[si]:
            raise AssertionError(f"[analysis] fleet stream {si} saw "
                                 f"{fleet.frames_seen[si]} frames")
    log(f"[analysis] FleetFlickerAnalyzer 1080p x {FLEET} over ragged "
        f"rounds {[list(r) for r in rounds]}: each stream equals its "
        f"single-stream analyzer on the card bit for bit")


def analysis_files(card):
    """run_dips_on_files(flicker=) on the [fleet-file] clips against
    single analyzers fed the same decoded RGB frames."""
    from dips_tpu_torch import DiPsProperties, OutputMode, run_dips_on_files
    from dips_tpu_torch.ops import analysis
    work = os.path.join("build", "chip_smoke", "fleet_file")
    paths = [os.path.join(work, f"cam{si}.avi") for si in range(3)]
    counts, maps = run_dips_on_files(
        paths, os.path.join(work, "flicker"),
        properties=DiPsProperties(output=OutputMode.STATS_ONLY), batch=B,
        device="cuda", flicker=dict(freq_hz=FLICKER_HZ))
    if maps.shape != (3, H1080, W1080):
        raise AssertionError(f"[analysis] flicker maps {maps.shape}")
    from dips_tpu_torch.io.video import VideoReader
    for si, p in enumerate(paths):
        reader = VideoReader(p)
        fps = reader.fps
        reader.close()
        single = analysis.FlickerAnalyzer(FLICKER_HZ, fps, batch=B,
                                          device="cuda")
        frames = read_rgb(p)
        single.update(np.stack(frames))
        if counts[si] != len(frames):
            raise AssertionError(f"[analysis] cam{si}: {counts[si]} frames "
                                 f"run, {len(frames)} decoded")
        _amp_err(f"[analysis] run_dips_on_files flicker cam{si}", maps[si],
                 single.amplitude(), bit_for_bit=True)
    log(f"[analysis] run_dips_on_files(flicker=) on the three 1080p clips "
        f"({[int(c) for c in counts]} frames): each map equals a single analyzer's on "
        f"the decoded RGB frames bit for bit")


def analysis_cli(card, clip, work):
    """python -m dips_tpu_torch on the 4K clip with the post-analysis
    flags."""
    import sys
    dft = os.path.abspath(os.path.join(work, "dft.json"))
    root = os.path.dirname(os.path.abspath(__file__))
    res = subprocess.run(
        [sys.executable, "-m", "dips_tpu_torch", "--input", clip, "--output",
         os.path.abspath(os.path.join(work, "cli4k.avi")), "--batch", str(B), "--denoise",
         str(DENOISE_R), "--dft-json", dft, "--flicker-hz", f"{FLICKER_HZ:g}",
         "--flicker-tau", "8", "--device", "cuda"], cwd=root,
        capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"[analysis] CLI exit code {res.returncode}: "
                             f"{res.stderr[-2000:]}")
    with open(dft) as f:
        doc = json.load(f)
    if len(doc["magnitude"]) != B + 1 or len(doc["phase"]) != B + 1:
        raise AssertionError(f"[analysis] --dft-json has "
                             f"{len(doc['magnitude'])} bins")
    peak = [ln for ln in res.stdout.splitlines() if ln.startswith("flicker")]
    import re
    m = re.search(r"x=(\d+) y=(\d+)", peak[0] if peak else "")
    y, x, side = OSC
    if not m or not (y <= int(m[2]) < y + side and x <= int(m[1]) < x + side):
        raise AssertionError(f"[analysis] CLI flicker peak not in the "
                             f"oscillating square: {peak}")
    log(f"[analysis] python -m dips_tpu_torch --input <4K clip> --denoise "
        f"{DENOISE_R} --dft-json --flicker-hz {FLICKER_HZ:g} --device cuda: exit 0, "
        f"{B + 1} DFT bins; {peak[0] if peak else 'no flicker line'}")


def analysis_times(card):
    """Device time of each piece on device-resident inputs: the flicker
    update per frame (4K, s = 1) and per frame-round (1080p x 8), denoise
    per 4K batch with its memory peak, temporal_dft; each beside a bytes
    bound at 3.35 TB/s, with its kernel launches."""
    import torch
    from dips_tpu_torch.ops import analysis
    from dips_tpu_torch.properties import ChromaFilter
    dev = torch.device("cuda")
    out = []

    def record(name, route, ms, per, nbytes, launches, **extra):
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        out.append(dict(name=name, route=route, ms=ms, per=per,
                        bound_ms=bound, bound_by="bytes",
                        launches=launches, **extra))
        log(f"[analysis] time {name}: {ms:.4f} ms per {per} (median of 5 "
            f"trials, CUDA events), {launches} kernel launches; bytes "
            f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s); "
            f"{card}")

    def host_wall(label, fn, nbytes):
        """Median host-clock ms of ``fn`` (host frames in, synchronized):
        the analyzer's staging and upload included."""
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        ms = float(np.median(walls))
        out.append(dict(name=label, route="plain torch", ms=ms,
                        per=f"batch of {B}", clock="host",
                        host_mb=nbytes / 1e6))
        log(f"[analysis] time {label}: {ms:.2f} ms per batch of {B} "
            f"(host clock, median of 5; {nbytes / 1e6:.0f} MB of frames "
            f"staged and uploaded); {card}")

    all_ = ChromaFilter.ALL.value
    host = flicker_frames(B, H4K, W4K, 102)
    fa = analysis.FlickerAnalyzer(FLICKER_HZ, FPS, device="cuda")
    host_wall("FlickerAnalyzer.update 4K", lambda: fa.update(host),
              host.nbytes)
    del fa
    frames = torch.from_numpy(host).to(dev)
    state = tuple(torch.zeros((H4K, W4K), device=dev) for _ in range(3))
    coeffs = torch.rand((3, B), device=dev) + 0.5
    alpha = torch.tensor(0.9, device=dev)
    step = lambda: analysis._flicker_update(all_, state, frames,  # noqa
                                            coeffs, alpha)
    n_l, _ = device_launches(step)
    px = H4K * W4K
    record("flicker update 4K s=1", "plain torch", median_ms(step) / B,
           "frame", px * (3 + 6 * 4), n_l)
    del frames, state
    shost = np.stack([flicker_frames(B, H1080, W1080, 103 + si)
                      for si in range(FLEET)], axis=1)
    fleet = analysis.FleetFlickerAnalyzer(FLEET, device="cuda")
    fleet.configure_all(FLICKER_HZ, FPS)
    feeds = [list(shost[:, si]) for si in range(FLEET)]
    host_wall(f"FleetFlickerAnalyzer.update 1080p x {FLEET}",
              lambda: fleet.update(feeds), shost.nbytes)
    del fleet, feeds
    sframes = torch.from_numpy(shost).to(dev)
    sstate = tuple(torch.zeros((FLEET, H1080, W1080), device=dev)
                   for _ in range(3))
    scoeffs = torch.rand((3, B, FLEET), device=dev) + 0.5
    gates = torch.ones((B, FLEET), dtype=torch.bool, device=dev)
    salpha = torch.full((FLEET,), 0.9, device=dev)
    fstep = lambda: analysis._flicker_update_fleet(  # noqa: E731
        all_, sstate, sframes, scoeffs, gates, salpha)
    n_l, _ = device_launches(fstep)
    record(f"flicker update 1080p x {FLEET}", "plain torch",
           median_ms(fstep) / B, "frame-round",
           FLEET * H1080 * W1080 * (3 + 6 * 4), n_l)
    del sframes, sstate
    maps = torch.from_numpy(flicker_frames(B, H4K, W4K, 104)).to(dev)
    den = lambda: analysis.denoise_frames(maps, DENOISE_R)  # noqa: E731
    n_l, _ = device_launches(den)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    den()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    record(f"denoise_frames 4K radius {DENOISE_R}", "cuFFT", median_ms(den, reps=1),
           f"batch of {B}", 2 * maps.numel(), n_l, peak_mib=peak)
    log(f"[analysis] denoise_frames 4K batch of {B}: device memory peak "
        f"{peak:.1f} MiB above the {base / 2 ** 20:.1f} MiB held before")
    del maps
    traces = torch.rand((64, H1080, W1080), device=dev)
    dft = lambda: analysis.temporal_dft(traces)  # noqa: E731
    n_l, _ = device_launches(dft)
    record("temporal_dft 64 x 1080p pixel traces", "cuFFT",
           median_ms(dft), "call",
           traces.numel() * 4 + 2 * 33 * H1080 * W1080 * 4, n_l)
    series = torch.rand((2 * B, 4), device=dev)
    sdft = lambda: analysis.temporal_dft(series)  # noqa: E731
    n_l, _ = device_launches(sdft)
    record(f"temporal_dft ({2 * B}, 4) stats series", "cuFFT",
           median_ms(sdft), "call", series.numel() * 4 + 2 * 17 * 4 * 4,
           n_l)
    return out


def batch_walls(card):
    """ms per batch of the 4K COLORIZE engine and of the 1080p x 8
    COLORIZE fleet, host frames in and host maps out: the walls the
    flicker update is weighed against."""
    import torch
    from dips_tpu_torch import DiPsEngine, DiPsProperties, MultiStreamEngine
    frames = list(moving_square_frames(B, H4K, W4K, 105))
    eng = DiPsEngine(DiPsProperties(), H4K, W4K, batch=B, device="cuda")
    eng.process_batch(frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        eng.process_batch(frames)
    w4k = (time.perf_counter() - t0) / 3 * 1e3
    del eng
    frame = FleetFrames(106)
    feeds = [[frame(si, k) for k in range(B)] for si in range(FLEET)]
    fleet = MultiStreamEngine(DiPsProperties(), H1080, W1080, FLEET,
                              batch=B, device="cuda")
    fleet.process_batch(feeds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        fleet.process_batch(feeds)
    wfleet = (time.perf_counter() - t0) / 2 * 1e3
    log(f"[analysis] batch walls, host frames in and maps out: 4K "
        f"COLORIZE engine {w4k:.1f} ms, 1080p x {FLEET} COLORIZE fleet "
        f"{wfleet:.1f} ms per batch of {B}; {card}")
    return w4k, wfleet


def phase_analysis(card):
    try:
        import cv2  # noqa: F401
    except ImportError:
        raise AssertionError("[analysis] needs cv2 for its clips")
    work = os.path.join("build", "chip_smoke", "analysis")
    os.makedirs(work, exist_ok=True)
    clip, _ = analysis_4k(card, work)
    analysis_fleet(card, FleetFrames(107))
    analysis_files(card)
    analysis_cli(card, clip, work)
    times = analysis_times(card)
    w4k, wfleet = batch_walls(card)
    for t in times:
        name = t["name"]
        wall = (w4k if "4K" in name else wfleet if "1080p" in name
                else None)
        if wall is not None and "lick" in name:
            per_batch = t["ms"] * (B if t["per"] != f"batch of {B}" else 1)
            t["share_of_batch_wall"] = per_batch / wall
            log(f"[analysis] {name}: {per_batch:.2f} ms per batch of {B}, "
                f"{100 * t['share_of_batch_wall']:.1f}% of the engine's "
                f"{wall:.1f} ms batch wall")
    log("[analysis] " + json.dumps({"device_code": times}))


# ---------------------------------------------------------------------------
# the single-stream run mode: the CLI's artifacts, raw dumps, live preview
# ---------------------------------------------------------------------------

#: the ring kernels the single-stream run mode launches
RUN_KERNELS = ("absdiff_step_ring", "batch_step_ring")
#: the [run] clip: still, a moving square, a lighting flip
RUN_STILL, RUN_MOVING, RUN_LIT = 16, 24, 24
#: side of the [run] clip's square: 4.9% of a 1080p frame, over the
#: default --event-on of 1% changed
RUN_SIDE = 320


#: the stacked ring kernels, which the fleets launch
FLEET_KERNELS = ("absdiff_step_ring_stacked", "batch_step_ring_stacked")


class _Held:
    """Stands in for ring wrapper ``kernel`` in ``cuda_fused`` while a
    :class:`HeldRing` block lasts.  The wrapper finds its launch counters
    through its module name (``_count_launch``), so this object's
    counters are the kernel's own: callers in several threads (servers,
    coalescers) all go through it, and none of their launches escapes the
    hold."""

    def __init__(self, ring, name, kernel, plain):
        self.ring, self.name = ring, name
        self.kernel, self.plain = kernel, plain
        self.stacked = name.endswith("_stacked")

    @property
    def launches(self):
        return self.kernel.launches

    @launches.setter
    def launches(self, value):
        self.kernel.launches = value

    @property
    def mode_launches(self):
        return self.kernel.mode_launches

    @property
    def form_launches(self):
        return self.kernel.form_launches

    @property
    def geometry_launches(self):
        return self.kernel.geometry_launches

    def __call__(self, props, h, w, *args, **kw):
        import torch
        ring = self.ring
        t0 = time.perf_counter()
        # the plain twin gets copies of every tensor argument
        copies = [a.clone() if hasattr(a, "clone") else a for a in args]
        t1 = time.perf_counter()
        got = self.kernel(props, h, w, *args, **kw)
        torch.cuda.synchronize()
        with ring.lock:
            t2 = time.perf_counter()
            exp = self.plain(props, h, w, *copies, **kw)
            ring._compare(self.name, props, h, w,
                          args[0] if self.stacked else 1, got, exp)
            ring.seconds += (t1 - t0) + (time.perf_counter() - t2)
        return got


class HeldRing:
    """For the duration of the block, every launch of the ring wrappers
    ``names`` (``batch_step_ring`` / ``absdiff_step_ring`` by default, by
    whichever engine: the CLI's, ``custom_dips_on_files``'s,
    ``run_live``'s, ``rebuild_engine``'s rebuild of the ring; the stacked
    ones of a fleet; from any thread) also runs the plain twin on copies
    of its state and input and is held against it, stream section by
    stream section: median maps within MEDIAN_TOL, raw maps exact, carried
    state exact on the true region, heatmap and stats within tolerance.
    Counts the kernels' launches from 0 (``counts``); the twins count
    nothing.  A name with a form (``name:dyn_rows``) is counted, and held
    through its wrapper.  ``tag`` starts its messages; ``seconds`` is the
    host time spent on the copies, the twins and the comparisons (the
    kernel synchronised first), which a timed caller takes off its
    wall."""

    def __init__(self, tag="[run]", names=RUN_KERNELS):
        import threading
        self.tag, self.names = tag, names
        self.counts = dict.fromkeys(names, 0)
        self.held = dict.fromkeys(names, 0)
        self.err = dict.fromkeys(names, 0.0)
        self.flips = self.px = 0
        self.seconds = 0.0
        self.lock = threading.Lock()

    def _compare(self, name, props, h, w, s, got, exp):
        import torch

        def true(x):  # each stream section's true region
            x = x.view(*x.shape[:-2], s, x.shape[-2] // s, x.shape[-1])
            return x[..., :h, :w]

        d = (true(got[0]).to(torch.int16)
             - true(exp[0]).to(torch.int16)).abs()
        raw = name.startswith("absdiff")
        self.flips += int((d > 0).sum())
        self.px += d.numel()
        worst = int(d.max()) if d.numel() else 0  # no maps: none to hold
        if worst > (0 if raw else MEDIAN_TOL["lsb"]) or \
                self.flips > MEDIAN_TOL["flip_frac"] * self.px:
            raise AssertionError(f"{self.tag} {name} {ptag(props)}: maps "
                                 f"differ from the plain twin")
        for g, e in zip(got[2:-1], exp[2:-1]):
            if not torch.equal(true(g), true(e)):
                raise AssertionError(f"{self.tag} {name}: carried state "
                                     f"differs")
        self.err[name] = max(self.err[name], _max_err(got[-1], exp[-1]))
        if self.err[name] > MEDIAN_TOL["heat_atol"]:
            raise AssertionError(f"{self.tag} {name}: heatmap differs")
        _check_stats(f"{self.tag} {name} {ptag(props)}",
                     got[1].reshape(-1, 4), exp[1].reshape(-1, 4),
                     RAW_TOL["stats_rtol"] if raw
                     else MEDIAN_TOL["stats_rtol"])
        self.held[name] += 1

    def __enter__(self):
        from dips_tpu_torch.ops import cuda_fused as cf
        cf.reset_launch_counts()
        self._saved = {}
        for name in self.names:
            if ":" in name:  # a form: held through its wrapper
                continue
            kernel = self._saved[name] = getattr(cf, name)
            setattr(cf, name, _Held(self, name, kernel,
                                    getattr(cf, name + "_plain")))
        return self

    def __exit__(self, *exc):
        import torch
        from dips_tpu_torch.ops import cuda_fused as cf
        for name, kernel in self._saved.items():
            setattr(cf, name, kernel)
        torch.cuda.synchronize()
        counts = cf.launch_counts()
        for name in self.names:
            self.counts[name] += counts[name]


def run_clip_frames(seed):
    """The [run] clip: RUN_STILL still frames (a colour gradient with a
    little noise: MJPG encodes every copy of it alike, where a pure-noise
    frame's first copy decodes differently from the rest), RUN_MOVING with
    a RUN_SIDE square moving over it, RUN_LIT still ones 90 levels
    brighter."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H1080, 0:W1080]
    bg = np.stack([yy * 150 // H1080, xx * 150 // W1080,
                   (yy + xx) * 80 // (H1080 + W1080) + 40], -1)
    bg = (bg + rng.integers(0, 8, bg.shape)).astype(np.uint8)
    n = RUN_STILL + RUN_MOVING + RUN_LIT
    frames = np.empty((n, H1080, W1080, 3), np.uint8)
    frames[:] = bg
    for k in range(RUN_MOVING):
        y, x = 100 + 15 * k, 200 + 45 * k
        frames[RUN_STILL + k, y:y + RUN_SIDE, x:x + RUN_SIDE] = (250, 60, 30)
    frames[RUN_STILL + RUN_MOVING:] += 90
    return frames


def _cli(argv):
    """dips_tpu_torch.cli.main in this process (the held wrappers apply):
    (exit code, stdout, stderr)."""
    import contextlib
    import io
    from dips_tpu_torch.cli import main as cli_main
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(argv)
    return rc, out.getvalue(), err.getvalue()


def _frame_count(path):
    import cv2
    cap = cv2.VideoCapture(path)
    n = 0
    while cap.grab():
        n += 1
    cap.release()
    return n


def run_cli(card, work, clip, held, has_mpl):
    """The CLI's single-stream run with every artifact flag, COLORIZE."""
    from dips_tpu_torch import DiPsProperties
    from dips_tpu_torch.ops.events import detect_events
    from dips_tpu_torch.ops.reference import STAT_NAMES
    n = RUN_STILL + RUN_MOVING + RUN_LIT
    rec = os.path.join(work, "rec")
    art = {k: os.path.join(work, f"{k}.json") for k in ("stats", "events")}
    argv = ["--input", clip, "--output", os.path.join(work, "out.avi"),
            "--device", "cuda", "--batch", str(B), "--record-events", rec,
            "--pre-roll", "8", "--post-roll", "8", "--auto-refresh",
            "0.6:3", "--stats-json", art["stats"], "--events-json",
            art["events"], "--retime-vfr", "--profile"]
    if has_mpl:
        argv += ["--heatmap-png", os.path.join(work, "heatmap.png")]
    t0 = time.perf_counter()
    with held:
        rc, out, err = _cli(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"[run] CLI exit {rc}: {err[-2000:]}")
    with open(os.path.join(rec, "segments.json")) as f:
        segs = json.load(f)
    if not segs:
        raise AssertionError("[run] no event segment recorded")
    for s in segs:
        got = _frame_count(s["path"])
        if got != s["frames"]:
            raise AssertionError(f"[run] segment {s['path']}: {got} frames, "
                                 f"segments.json says {s['frames']}")
    with open(art["stats"]) as f:
        stats = np.asarray([[r[k] for k in STAT_NAMES] for r in json.load(f)],
                           np.float32)
    with open(art["events"]) as f:
        events = json.load(f)
    exp = [e.to_dict() for e in detect_events(
        [stats], on_threshold=0.01, off_threshold=None,
        metric="changed_frac", min_frames=2, cooldown=0,
        pixels=DiPsProperties().analysis_pixels(H1080, W1080))]
    if events != exp or not events:
        raise AssertionError(f"[run] events.json {events} != detect_events "
                             f"over stats.json {exp}")
    fired = [ln for ln in out.splitlines()
             if ln.startswith("auto-refresh fired at frame(s): ")]
    first = int(fired[0].split(": ")[1].split(",")[0]) if fired else -1
    flip = RUN_STILL + RUN_MOVING
    if not flip <= first < flip + B:
        raise AssertionError(f"[run] auto-refresh did not fire at the flip "
                             f"(frame {flip}): {fired}")
    after = stats[(first // B + 1) * B:, 3]  # the re-pin's next batch on
    if stats.shape[0] != n or not after.size or after.max() > 0:
        raise AssertionError("[run] the lit scene still diffs after the "
                             "re-pin")
    frames_out = _frame_count(os.path.join(work, "out.avi"))
    if frames_out != n:
        raise AssertionError(f"[run] output has {frames_out} frames, the "
                             f"input {n}")
    if has_mpl and not os.path.getsize(os.path.join(work, "heatmap.png")):
        raise AssertionError("[run] empty heatmap PNG")
    log(f"[run] python -m dips_tpu_torch --input <1080p clip, {n} frames> "
        f"--record-events --pre-roll 8 --post-roll 8 --auto-refresh 0.6:3 "
        f"--stats-json --events-json --retime-vfr --profile"
        + (" --heatmap-png" if has_mpl else "") + f": exit 0 in "
        f"{wall:.1f} s; {len(segs)} segment(s) "
        f"{[(s['start_frame'], s['end_frame'], s['frames']) for s in segs]} "
        f"(each file's frame count as listed); events.json equals "
        f"detect_events over stats.json ({len(events)} event(s)); "
        f"auto-refresh fired at {first} (flip at {flip}); {frames_out} "
        f"frames out, as in; card {card}")
    timers = [ln for ln in out.splitlines() if ln.startswith("  ")]
    log("[run] stage timers: " + "; ".join(t.strip() for t in timers))
    return wall


def run_trace(card, work, frames, held, has_mpl):
    """--output-mode absdiff --trace-dir on the clip's first 16 frames:
    the Chrome trace names the raw kernel; --heatmap-png either writes
    the PNG or, without matplotlib, exits 1 with the install hint."""
    clip16 = os.path.join(work, "clip16.avi")
    write_avi(clip16, frames[:B])
    tdir = os.path.join(work, "trace")
    hm = os.path.join(work, "heatmap16.png")
    with held:
        rc, out, err = _cli(["--input", clip16, "--output",
                             os.path.join(work, "abs.avi"), "--device",
                             "cuda", "--batch", str(B), "--output-mode",
                             "absdiff", "--trace-dir", tdir,
                             "--heatmap-png", hm])
    if has_mpl and rc != 0:
        raise AssertionError(f"[run] traced run exit {rc}: {err[-2000:]}")
    if not has_mpl and (rc != 1 or "chart rendering needs matplotlib"
                        not in err):
        raise AssertionError(f"[run] --heatmap-png without matplotlib: "
                             f"exit {rc}, {err[-500:]}")
    (name,) = os.listdir(tdir)
    with open(os.path.join(tdir, name)) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted({e["name"] for e in events
                      if e.get("cat") == "kernel"})
    ours = [k for k in kernels if "raw_step_kernel" in k]
    if not ours:
        raise AssertionError(f"[run] the trace names no raw kernel: "
                             f"{kernels[:20]}")
    size = os.path.getsize(os.path.join(tdir, name))
    log(f"[run] --output-mode absdiff --trace-dir on {B} frames: exit {rc}"
        + ("" if has_mpl else " (no matplotlib: the --heatmap-png hint)")
        + f"; the trace ({size / 1e6:.1f} MB, {len(events)} events, "
        f"{len(kernels)} kernel names) names {ours[0][:80]}")


def run_dat(card, work, held):
    """--dat-dir over 24 Dat_N.d dumps at the dumps' 273 x 640, red
    chroma, against the same dumps through an engine on the CPU."""
    from dips_tpu_torch import ChromaFilter, DiPsEngine, DiPsProperties
    from dips_tpu_torch.io.datfiles import read_dat_dir
    from dips_tpu_torch.ops.reference import STAT_NAMES
    w, h, n = 273, 640, 24
    ddir = os.path.join(work, "dat")
    os.makedirs(ddir, exist_ok=True)
    rng = np.random.default_rng(113)
    base = rng.integers(0, 256, (h, w, 4), np.uint8)
    for i in range(n):
        f = base.copy()
        y, x = 20 + 17 * i, 5 + 7 * i
        f[y:y + 64, x:x + 64, 0] = 250
        f[y + 32:y + 96, x:x + 64, 2] = 20
        with open(os.path.join(ddir, f"Dat_{i}.d"), "wb") as fh:
            fh.write(b"\0" * 4 + f.tobytes())
    sj = os.path.join(work, "dat_stats.json")
    t0 = time.perf_counter()
    with held:
        rc, out, err = _cli(["--dat-dir", ddir, "--output",
                             os.path.join(work, "dat.avi"), "--chroma", "r",
                             "--dat-geometry", f"{w}x{h}", "--stats-json",
                             sj, "--device", "cuda"])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"[run] --dat-dir exit {rc}: {err[-2000:]}")
    with open(sj) as f:
        got = np.asarray([[r[k] for k in STAT_NAMES] for r in json.load(f)],
                         np.float32)
    cpu = DiPsEngine(DiPsProperties(chroma=ChromaFilter.RED), h, w,
                     batch=8, device="cpu")
    _, exp = cpu.process_frames(list(read_dat_dir(ddir, w, h)))
    _check_stats("[run] --dat-dir against the CPU", got, exp,
                 MEDIAN_TOL["stats_rtol"])
    if got.shape != (n, 4) or got[:, 3].max() <= 0:
        raise AssertionError("[run] --dat-dir: no change seen")
    log(f"[run] --dat-dir, {n} dumps at {w} x {h} (an 819-byte RGB row), "
        f"--chroma r: exit 0 in {wall:.1f} s; stats equal an engine on the "
        f"CPU (counts and maxima exact, sums within "
        f"{MEDIAN_TOL['stats_rtol']})")


def run_live_1080(card, held):
    """run_live at 1080p, B = 1, 32 frames from an injected reader, cv2's
    window calls stubbed, the keys w W t T T m o s e a pressed after
    frames 2-11: each rebuild builds an engine and rebuilds its ring from
    the carried tail with one kernel launch."""
    import cv2
    from dips_tpu_torch import DiPsProperties
    from dips_tpu_torch.live import run_live
    frames = moving_square_frames(32, H1080, W1080, 127)
    stamps, shown = [], []

    class Reader:
        def __init__(self):
            self.i = 0

        def read(self):
            stamps.append(time.perf_counter())
            if self.i >= len(frames):
                return None
            self.i += 1
            return frames[self.i - 1]

        def close(self):
            pass

    keys = dict(zip(range(2, 12), "wWtTTmosea"))
    shown_i = iter(range(10**6))
    stubs = {"namedWindow": lambda *a, **k: None,
             "imshow": lambda _w, img: shown.append(img.shape),
             "setWindowTitle": lambda *a: None,
             "waitKey": lambda _ms: ord(keys.get(next(shown_i), "\xff")),
             "destroyAllWindows": lambda: None}
    saved = {k: getattr(cv2, k) for k in stubs}
    display = os.environ.get("DISPLAY")
    os.environ["DISPLAY"] = ":0"
    try:
        for k, v in stubs.items():
            setattr(cv2, k, v)
        with held:
            rc = run_live(DiPsProperties(), reader=Reader(), device="cuda",
                          auto_refresh={"threshold": 0.6})
    finally:
        for k, v in saved.items():
            setattr(cv2, k, v)
        if display is None:
            del os.environ["DISPLAY"]
        else:
            os.environ["DISPLAY"] = display
    if rc != 0 or len(shown) != 32 or set(shown) != {(H1080, W1080, 3)}:
        raise AssertionError(f"[run] run_live: exit {rc}, {len(shown)} "
                             f"frames shown {set(shown)}")
    walls = np.diff(stamps[:33]) * 1e3  # read to read, one frame each
    log(f"[run] run_live 1080p, B = 1, 32 frames, keys w W t T T m o s e a: "
        f"exit 0; per-frame wall p50 {np.median(walls):.1f} ms, max "
        f"{walls.max():.1f} ms over {len(walls)} frames (the first builds "
        f"the engine, each key a rebuild); card {card}")
    return {"count": int(len(walls)), "p50_ms": float(np.median(walls)),
            "max_ms": float(walls.max())}


def run_utilities(work, clip):
    """--thumbnail and --subsample 4 on the clip."""
    import cv2
    thumb = os.path.join(work, "thumb.png")
    rc, out, err = _cli(["--thumbnail", thumb, "--input", clip])
    img = cv2.imread(thumb)
    if rc != 0 or img is None or img.shape != (240, 427, 3):
        raise AssertionError(f"[run] --thumbnail: exit {rc}, "
                             f"{None if img is None else img.shape}")
    sub = os.path.join(work, "sub.avi")
    rc, out, err = _cli(["--input", clip, "--output", sub,
                         "--subsample", "4"])
    n = RUN_STILL + RUN_MOVING + RUN_LIT
    if rc != 0 or _frame_count(sub) != n // 4:
        raise AssertionError(f"[run] --subsample 4: exit {rc}, "
                             f"{_frame_count(sub)} frames")
    log(f"[run] --thumbnail: a 240 x 427 PNG; --subsample 4: {n // 4} of "
        f"{n} frames")


def phase_run(card):
    try:
        import cv2  # noqa: F401
    except ImportError:
        raise AssertionError("[run] needs cv2 for its clips")
    try:
        import matplotlib  # noqa: F401
        has_mpl = True
    except ImportError:
        has_mpl = False
    work = os.path.abspath(os.path.join("build", "chip_smoke", "run"))
    os.makedirs(work, exist_ok=True)
    frames = run_clip_frames(131)
    clip = os.path.join(work, "clip.avi")
    write_avi(clip, frames)
    held = HeldRing()
    walls = {"cli": run_cli(card, work, clip, held, has_mpl)}
    run_trace(card, work, frames, held, has_mpl)
    run_dat(card, work, held)
    live = run_live_1080(card, held)
    run_utilities(work, clip)
    for name in RUN_KERNELS:
        if held.counts[name] <= 0 or held.held[name] != held.counts[name]:
            raise AssertionError(f"[run] {name}: {held.counts[name]} "
                                 f"launches, {held.held[name]} held")
    log(f"[run] every launch held against its plain twin: {held.held} "
        f"(maps: {held.flips} of {held.px} values differ by 1 LSB; "
        f"heatmap max error {held.err})")
    log("[run] " + json.dumps({"cli_wall_s": walls["cli"], "live": live,
                               "card": card}))
    return held.counts


# ---------------------------------------------------------------------------
# the ingest slice: native framepump, decode workers, pipeline depth,
# GStreamer, the doctor
# ---------------------------------------------------------------------------

#: the [ingest] clip's length (the [run] clip and the start of another)
INGEST_N = 96
#: (decode_workers, pipeline_depth, input_layout) of the [ingest] runs,
#: the first the reference the others must equal bit for bit
INGEST_RUNS = ((1, 1, "hwc"), (4, 1, "hwc"), (1, 2, "hwc"), (4, 2, "hwc"),
               (4, 2, "planar"))


def ingest_clip_frames():
    """The [run] clip followed by the first 32 frames of another seed's."""
    return np.concatenate([run_clip_frames(131),
                           run_clip_frames(137)[:INGEST_N - 64]])


def ingest_native(card):
    """native.planarize / interleave against the plain twin on a 1080p
    frame, both swaps, and ms a frame of each (median of 9 calls)."""
    from dips_tpu_torch import native
    from dips_tpu_torch.ops.reference import pad_geometry, planarize_host
    if not native.NATIVE_AVAILABLE:
        raise AssertionError("[ingest] the framepump library did not build "
                             "or load (NATIVE_AVAILABLE is false)")
    tier = native.SIMD_NAMES[native.simd_level()]
    h, w = H1080, W1080
    hp, wp = pad_geometry(h, w)
    frame = np.random.default_rng(151).integers(0, 256, (h, w, 3), np.uint8)
    for swap in (False, True):
        got = native.planarize(frame, hp, wp, swap_rb=swap)
        if not np.array_equal(got, planarize_host(frame, hp, wp,
                                                  swap_rb=swap)):
            raise AssertionError(f"[ingest] native.planarize (swap {swap}) "
                                 f"differs from planarize_host")
        if not np.array_equal(native.interleave(got, h, w, swap_rb=swap),
                              frame):
            raise AssertionError(f"[ingest] native.interleave (swap {swap}) "
                                 f"does not invert planarize")

    def ms(fn):
        walls = []
        for _ in range(9):
            t0 = time.perf_counter()
            fn()
            walls.append(time.perf_counter() - t0)
        return float(np.median(walls)) * 1e3

    res = {"simd": tier,
           "native_ms": ms(lambda: native.planarize(frame, hp, wp,
                                                    swap_rb=True)),
           "plain_ms": ms(lambda: planarize_host(frame, hp, wp,
                                                 swap_rb=True)),
           "interleave_ms": ms(lambda: native.interleave(got, h, w))}
    log(f"[ingest] native: NATIVE_AVAILABLE, SIMD tier {tier}; planarize "
        f"{h}x{w} BGR -> padded planar RGB equals planarize_host (both "
        f"swaps), interleave inverts it; planarize {res['native_ms']:.3f} "
        f"ms/frame native, {res['plain_ms']:.3f} ms/frame numpy "
        f"(planarize_host); interleave {res['interleave_ms']:.3f} ms/frame; "
        f"median of 9 calls on the host; {card}")
    return res


def _shares(timers, wall):
    """{stage: share of the run's wall} and decode ms a frame (the mean
    over the decode workers of each one's ms a call)."""
    shares = {k: v / wall for k, v in sorted(timers.totals.items())}
    dec = [timers.totals[k] / timers.counts[k] for k in timers.totals
           if k.startswith("decode") and timers.counts[k]]
    return shares, float(np.mean(dec)) * 1e3 if dec else None


def _stream(clip, props, workers, depth, layout, inputs):
    """One stream_dips run: (items, job, wall s); items are (index, input
    or None, map, stats, pts)."""
    from dips_tpu_torch.app import DiPsJob, stream_dips
    job = DiPsJob(properties=props, video_path=clip, batch=B, device="cuda",
                  decode_workers=workers, pipeline_depth=depth,
                  input_layout=layout, yield_inputs=inputs, profile=True)
    t0 = time.perf_counter()
    items = [(i, inp, out, st) for i, inp, out, st in stream_dips(job)]
    wall = time.perf_counter() - t0
    return [it + (p,) for it, p in zip(items, job.frame_pts)], job, wall


def _same_items(tag, got, ref):
    if len(got) != len(ref):
        raise AssertionError(f"{tag}: {len(got)} frames, the (1, 1) run "
                             f"{len(ref)}")
    for g, r in zip(got, ref):
        if g[0] != r[0] or g[4] != r[4] or not np.array_equal(g[2], r[2]) \
                or not np.array_equal(g[3], r[3]) or (
                    g[1] is not None and not np.array_equal(g[1], r[1])):
            raise AssertionError(f"{tag}: frame {r[0]} differs from the "
                                 f"(1, 1) run (index, pts, map, stats or "
                                 f"input)")


def ingest_streams(card, clip, held):
    """stream_dips at each INGEST_RUNS configuration, COLORIZE w3/T4 and
    ABSDIFF: a held run with the inputs yielded (every launch against its
    plain twin), then a timed run with the stage timers; each equals the
    (1, 1) run bit for bit.  The timings are one run each, under a second:
    a reading of each configuration, too short to rank them."""
    from dips_tpu_torch import DiPsProperties, OutputMode
    out = {}
    n = None
    for mode, props in (("colorize", DiPsProperties(window_size=3,
                                                    temporal_size=4)),
                        ("absdiff", DiPsProperties(
                            output=OutputMode.ABSDIFF))):
        ref = None
        for workers, depth, layout in INGEST_RUNS:
            tag = f"[ingest] {mode} ({workers}, {depth}) {layout}"
            with held:
                items, _, _ = _stream(clip, props, workers, depth, layout,
                                      True)
            if ref is None:
                ref, n = items, len(items)
            _same_items(tag, items, ref)
            items, job, wall = _stream(clip, props, workers, depth, layout,
                                       False)
            _same_items(tag + " (timed)", items, ref)
            shares, dec_ms = _shares(job.timers, wall)
            out[f"{mode} {workers} {depth} {layout}"] = {
                "wall_s": wall, "fps": n / wall, "decode_ms": dec_ms,
                "shares": shares}
            log(f"{tag}: {n} frames at {H1080}x{W1080}, B = {B}, equal to "
                f"the (1, 1) run bit for bit; one timed run (a reading, "
                f"not a ranking) {wall:.3f} s, "
                f"{n / wall:.1f} frames/s, decode {dec_ms:.2f} ms/frame a "
                f"worker; shares of the wall: "
                + ", ".join(f"{k} {v:.3f}" for k, v in shares.items())
                + f"; {card}")
    return out


def ingest_cli(card, work, clip, held):
    """python -m dips_tpu_torch with --decode-workers 4 --pipeline-depth 2
    --profile, in this process: its video decodes to the default run's
    frame for frame."""
    outs, walls = {}, {}
    for name, extra in (("default", []),
                        ("w4d2", ["--decode-workers", "4",
                                  "--pipeline-depth", "2", "--profile"])):
        path = os.path.join(work, f"cli_{name}.avi")
        t0 = time.perf_counter()
        with held:
            rc, out, err = _cli(["--input", clip, "--output", path,
                                 "--device", "cuda", "--batch", str(B)]
                                + extra)
        walls[name] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"[ingest] CLI {extra}: exit {rc}: "
                                 f"{err[-2000:]}")
        outs[name] = read_rgb(path)
        if name == "w4d2" and "decode3" not in out:
            raise AssertionError("[ingest] --profile names no fourth decode "
                                 "worker")
    if len(outs["w4d2"]) != INGEST_N or any(
            not np.array_equal(a, b) for a, b in zip(outs["w4d2"],
                                                     outs["default"])):
        raise AssertionError("[ingest] --decode-workers 4 --pipeline-depth "
                             "2 output differs from the default run's")
    log(f"[ingest] python -m dips_tpu_torch --decode-workers 4 "
        f"--pipeline-depth 2 --profile: exit 0 in {walls['w4d2']:.1f} s "
        f"(default flags {walls['default']:.1f} s); its {INGEST_N} frames "
        f"decode equal to the default run's; {card}")


def ingest_gstreamer(card, work, held):
    """With the GStreamer C stack: a clip written by GstVideoWriter, run
    through stream_dips(video_backend="gstreamer") against a DiPsEngine
    fed the same reader's frames, and perform_dips with a GStreamer
    writer whose timestamps come back from the file.  Without it, a line
    says why."""
    from dips_tpu_torch import DiPsEngine, DiPsProperties
    from dips_tpu_torch.app import DiPsJob, perform_dips, stream_dips
    from dips_tpu_torch.io import gstreamer as gst
    if gst._load() is None:
        log(f"[ingest] gstreamer: not run ({gst._gst_err})")
        return None
    n, h, w = 32, H1080, W1080
    frames = run_clip_frames(139)[RUN_STILL - 8:RUN_STILL - 8 + n]
    src = os.path.join(work, "gst_in.ogv")
    wr = gst.GstVideoWriter(src, FPS, w, h)
    for k, f in enumerate(frames):
        wr.write(f, pts=k / FPS)
    wr.close()
    rd = gst.GstVideoReader(src)
    t0 = time.perf_counter()
    decoded = [f for f in rd]
    dec_ms = (time.perf_counter() - t0) * 1e3 / max(1, len(decoded))
    rd.close()
    props = DiPsProperties(window_size=3, temporal_size=4)
    eng = DiPsEngine(props, h, w, batch=B, device="cuda")
    exp_maps, exp_stats = eng.process_frames(decoded)
    job = DiPsJob(properties=props, video_path=src, batch=B, device="cuda",
                  video_backend="gstreamer", pipeline_depth=2)
    with held:
        items = list(stream_dips(job))
    maps = np.stack([it[2] for it in items])
    stats = np.stack([it[3] for it in items])
    if not (np.array_equal(maps, exp_maps)
            and np.array_equal(stats, exp_stats)):
        raise AssertionError("[ingest] gstreamer: stream_dips differs from "
                             "an engine fed the reader's frames")
    out = os.path.join(work, "gst_out.ogv")
    with held:
        perform_dips(DiPsJob(properties=props, video_path=src,
                             output_path=out, batch=B, device="cuda",
                             video_backend="gstreamer", retime_vfr=True))
    rd = gst.GstVideoReader(out)
    pts = [p for _, p in iter(rd.read_timed, None)]
    rd.close()
    if not np.allclose(pts, [k / FPS for k in range(n)], atol=1e-6):
        raise AssertionError(f"[ingest] gstreamer: timestamps {pts[:4]}... "
                             f"did not come back from the written file")
    log(f"[ingest] gstreamer ({gst._gst.version}): {n} frames written by "
        f"GstVideoWriter, stream_dips(video_backend='gstreamer') equals an "
        f"engine fed the reader's frames, perform_dips's GStreamer writer "
        f"kept every timestamp; decode {dec_ms:.2f} ms/frame; {card}")
    return dec_ms


def ingest_doctor(card):
    """python -m dips_tpu_torch.doctor --json in a process of its own."""
    import torch
    res = subprocess.run([sys.executable, "-m", "dips_tpu_torch.doctor",
                          "--json"], capture_output=True, text=True,
                         timeout=300)
    info = json.loads(res.stdout)
    t = info["torch"]
    if res.returncode != 0 or not t["ok"] \
            or t["device_name"] != torch.cuda.get_device_name(0) \
            or not t["power"] or t["power"] != card \
            or not info["native"]["ok"] or not info["kernels"]["built"]:
        raise AssertionError(f"[ingest] doctor: exit {res.returncode}, "
                             f"{json.dumps(info)[:2000]} {res.stderr[-500:]}")
    log(f"[ingest] python -m dips_tpu_torch.doctor --json: exit 0; torch "
        f"{t['version']} cuda {t['cuda']}, {t['devices']} card(s), "
        f"{t['power']}; native {info['native']['simd']}; kernels built in "
        f"{info['kernels']['dir']}; gstreamer available "
        f"{info['gstreamer']['available']}")


def phase_ingest(card):
    try:
        import cv2  # noqa: F401
    except ImportError:
        raise AssertionError("[ingest] needs cv2 for its clip")
    work = os.path.abspath(os.path.join("build", "chip_smoke", "ingest"))
    os.makedirs(work, exist_ok=True)
    steps, t0 = {}, time.perf_counter()

    def step(name, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        steps[name] = time.perf_counter() - t
        return res

    nat = step("native", ingest_native, card)
    clip = os.path.join(work, "clip.avi")
    step("clip", lambda: write_avi(clip, ingest_clip_frames()))
    held = HeldRing("[ingest]")
    runs = step("streams", ingest_streams, card, clip, held)
    step("cli", ingest_cli, card, work, clip, held)
    gst_ms = step("gstreamer", ingest_gstreamer, card, work, held)
    step("doctor", ingest_doctor, card)
    for name in RUN_KERNELS:
        if held.counts[name] <= 0 or held.held[name] != held.counts[name]:
            raise AssertionError(f"[ingest] {name}: {held.counts[name]} "
                                 f"launches, {held.held[name]} held")
    log(f"[ingest] every launch held against its plain twin: {held.held} "
        f"(maps: {held.flips} of {held.px} values differ by 1 LSB; "
        f"heatmap max error {held.err})")
    log("[ingest] " + json.dumps({"native": nat, "runs": runs,
                                  "gstreamer_decode_ms": gst_ms,
                                  "wall_s": time.perf_counter() - t0,
                                  "steps_s": steps,
                                  "card": card}))
    return held.counts


# ---------------------------------------------------------------------------
# the serving slice: dips_tpu_torch.serve over the engines
# ---------------------------------------------------------------------------

#: the ring kernels (and their slab forms) the serving path launches
SERVE_KERNELS = ("absdiff_step_ring", "batch_step_ring",
                 "absdiff_step_ring_stacked", "batch_step_ring_stacked",
                 "absdiff_step_ring_stacked:dyn_rows",
                 "batch_step_ring_stacked:slab_bands")
FPS_SERVE, HZ_SERVE = 30.0, 5.0  # a flicker session's camera and target


class Served:
    """Launch counts of the server's own work: each ``with`` block is
    driven with the counts set to 0 just before and read just after, so
    the engines and analyzers the replies are held against count
    nothing."""

    def __init__(self):
        self.counts = dict.fromkeys(SERVE_KERNELS, 0)

    def __enter__(self):
        from dips_tpu_torch.ops import cuda_fused
        cuda_fused.reset_launch_counts()
        return self

    def __exit__(self, *exc):
        import torch
        from dips_tpu_torch.ops import cuda_fused
        torch.cuda.synchronize()
        counts = cuda_fused.launch_counts()
        for name in SERVE_KERNELS:
            self.counts[name] += counts[name]


def start_server(props, **kw):
    """A ``DiPsServer`` at 1080p on cuda:0, serving from a thread."""
    import threading
    from dips_tpu_torch.serve import DiPsServer
    kw = dict(dict(port=0, batch=B, device="cuda:0", input_layout="hwc"),
              **kw)
    srv = DiPsServer(props, H1080, W1080, **kw)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv, th


def stop_server(srv, th):
    srv.shutdown()
    th.join(timeout=60)
    if th.is_alive():
        raise AssertionError("[serve] the server did not stop")


def connect(port, **kw):
    """A DiPsClient whose socket times out instead of hanging the run."""
    from dips_tpu_torch.serve import DiPsClient
    cli = DiPsClient(port, **kw)
    cli._sock.settimeout(120)
    return cli


def in_threads(fn, n, timeout=300):
    """fn(0..n-1) in n client threads; their results, errors re-raised."""
    import threading
    res, errs = [None] * n, []

    def run(i):
        try:
            res[i] = fn(i)
        except BaseException as e:  # re-raised on the calling thread
            errs.append(e)

    ts = [threading.Thread(target=run, args=(i,), daemon=True)
          for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    if errs:
        raise errs[0]
    if any(t.is_alive() for t in ts):
        raise AssertionError("[serve] a client thread did not finish")
    return res


def same(tag, got, exp):
    if not np.array_equal(got, exp):
        d = np.abs(np.asarray(got, np.float64) - np.asarray(exp, np.float64))
        raise AssertionError(f"{tag}: differs (max {d.max()}, "
                             f"{int((d > 0).sum())} values)")


def engine_batches(props, batches, snapshot_before=None, **kw):
    """A DiPsEngine on the card over ``batches`` (lists of frames), with a
    snapshot before batch ``snapshot_before``: (maps, stats, heatmap)."""
    from dips_tpu_torch import DiPsEngine
    eng = DiPsEngine(props, H1080, W1080, batch=B, device="cuda", **kw)
    outs, stats = [], []
    for bi, frames in enumerate(batches):
        if bi == snapshot_before:
            eng.snapshot()
        o, s = eng.process_batch(list(frames))
        outs.append(o)
        stats.append(s)
    return np.concatenate(outs), np.concatenate(stats), eng.heatmap()


def serve_dedicated(props, frames, served, label):
    """One session of 3 requests of B frames, a snapshot before the third,
    then the heatmap: equal to a DiPsEngine bit for bit."""
    with served:
        srv, th = start_server(props)
        try:
            with connect(srv.port) as cli:
                cfg = cli.hello()["config"]
                if cfg["backend"] != "kernel" or cfg["height"] != H1080:
                    raise AssertionError(f"[serve] hello {cfg}")
                o, s = [], []
                for bi in range(3):
                    if bi == 2:
                        cli.snapshot()
                    ob, sb = cli.process_many(frames[bi * B:(bi + 1) * B])
                    o.append(ob)
                    s.append(sb)
                heat = cli.heatmap()
        finally:
            stop_server(srv, th)
    maps, stats = np.concatenate(o), np.concatenate(s)
    exp = engine_batches(props, [frames[i:i + B] for i in range(0, 3 * B, B)],
                         snapshot_before=2)
    for tag, got, want in zip(("maps", "stats", "heatmap"),
                              (maps, stats, heat), exp):
        same(f"[serve] dedicated {label} {tag}", got, want)
    log(f"[serve] dedicated {label} 1080p, {3 * B} frames in 3 "
        f"process_batch requests, a snapshot before the third: maps, "
        f"stats and heatmap equal a DiPsEngine bit for bit")
    return maps, stats


def serve_coalesced(props, feeds, served, n_req, label, **kw):
    """len(feeds) concurrent clients on a coalescing server, each sending
    ``n_req`` requests of B frames; returns each client's maps and stats
    and the server's metrics."""
    with served:
        srv, th = start_server(props, coalesce=len(feeds), **kw)
        try:
            def client(i):
                with connect(srv.port, session=f"cam-{i}") as cli:
                    if cli.hello()["config"]["backend"] != "kernel":
                        raise AssertionError("[serve] coalesced backend")
                    got = [cli.process_many(feeds[i][r * B:(r + 1) * B])
                           for r in range(n_req)]
                return (np.concatenate([g[0] for g in got]),
                        np.concatenate([g[1] for g in got]))
            res = in_threads(client, len(feeds))
            metrics = srv.metrics()
        finally:
            stop_server(srv, th)
    if metrics["coalesce_dispatches"] < 1 or \
            not 1.0 <= metrics["coalesce_mean_fill"] <= len(feeds) * B:
        raise AssertionError(f"[serve] {label} metrics {metrics}")
    return res, metrics


def serve_autosave(props, frames, ref_maps, served, work):
    """A named session autosaves every B frames; the daemon "crashes"
    (shut down without close), a new daemon restores the session from
    the file the serving thread wrote, and the continued stream equals
    the uninterrupted engine bit for bit.  Returns that autosave's ms,
    timed on the serving thread."""
    import shutil
    import threading
    auto = os.path.join(work, "autosave")
    shutil.rmtree(auto, ignore_errors=True)
    kw = dict(autosave_dir=auto, autosave_every=B)
    saves = []  # (ms, on a thread other than this one) of each save
    with served:
        srv, th = start_server(props, **kw)
        run_autosave = srv._maybe_autosave

        def timed_autosave(*a, **k):
            n0 = srv.metrics()["autosaves"]
            t0 = time.perf_counter()
            run_autosave(*a, **k)
            if srv.metrics()["autosaves"] > n0:
                saves.append((1e3 * (time.perf_counter() - t0),
                              threading.current_thread()
                              is not threading.main_thread()))
        srv._maybe_autosave = timed_autosave
        try:
            cli = connect(srv.port, session="cam")
            cli.process_many(frames[:B])
            deadline = time.monotonic() + 60
            while srv.metrics()["autosaves"] < 1:
                if time.monotonic() > deadline:
                    raise AssertionError("[serve] no autosave")
                time.sleep(0.01)
        finally:
            stop_server(srv, th)  # the crash: no close
        cli._sock.close()
        if len(saves) != 1 or not saves[0][1] or \
                srv.metrics()["autosaves"] != 1:
            raise AssertionError(f"[serve] autosaves {saves}")
        save_ms = saves[0][0]
        size = os.path.getsize(os.path.join(auto, "cam.npz"))
        srv2, th2 = start_server(props, **kw)
        try:
            with connect(srv2.port, session="cam") as cli2:
                if cli2.hello()["frame_index"] != B:
                    raise AssertionError("[serve] not restored")
                maps, _ = cli2.process_many(frames[B:2 * B])
            if srv2.metrics()["autorestores"] != 1:
                raise AssertionError("[serve] autorestores")
        finally:
            stop_server(srv2, th2)
    same("[serve] autosave restore", maps, ref_maps[B:2 * B])
    log(f"[serve] named session 'cam', autosave every {B} frames: shut "
        f"down without close after {B} frames, a new daemon restored the "
        f"serving thread's autosave (frame_index {B}), frames {B}..{2 * B - 1}"
        f" equal the uninterrupted engine bit for bit; that 1080p autosave "
        f"took {save_ms:.1f} ms on the serving thread ({size / 1e6:.1f} MB "
        f"file)")
    return save_ms


def serve_packed(served):
    """THRESHOLD with packed_wire: the reply carries the device-packed
    planes verbatim; cropped to the true width they equal
    ``pack_mask_host`` of an unpacked engine's maps."""
    from dips_tpu_torch import DiPsProperties, OutputMode
    from dips_tpu_torch.ops.reference import pad_geometry
    from dips_tpu_torch.ops.wire import pack_mask_host
    props = DiPsProperties(output=OutputMode.THRESHOLD)
    frames = moving_square_frames(B, H1080, W1080, 83)
    hp, wp = pad_geometry(H1080, W1080)
    with served:
        srv, th = start_server(props, packed_wire=True)
        try:
            with connect(srv.port) as cli:
                hdr, body = cli._rpc({"cmd": "process_batch",
                                      "shape": list(frames.shape),
                                      "packed": True}, frames.tobytes())
                if not hdr.get("ok") or hdr.get("padded") != [hp, wp]:
                    raise AssertionError(f"[serve] packed reply {hdr}")
                maps = cli._decode_maps(hdr, body)
        finally:
            stop_server(srv, th)
    ref, _, _ = engine_batches(props, [frames])
    planes = np.frombuffer(body, np.uint8).reshape(B, 1, hp // 8, wp)
    same("[serve] packed reply bytes", planes[:, 0, :, :W1080],
         pack_mask_host(ref[..., 0]))
    same("[serve] packed reply decoded", maps, ref)
    log(f"[serve] THRESHOLD packed_wire: {len(body)} reply bytes (1/8 of "
        f"the padded maps), equal to pack_mask_host of an unpacked "
        f"engine's maps on the true width; decoded maps equal")


def serve_flicker(props, frames, served):
    """A flicker-armed coalesced session: its amplitude map equals a
    FlickerAnalyzer on the card fed the same frames, bit for bit."""
    from dips_tpu_torch.ops.analysis import FlickerAnalyzer
    with served:
        srv, th = start_server(props, coalesce=2)
        try:
            with connect(srv.port, session="fl", flicker_hz=HZ_SERVE,
                            flicker_fps=FPS_SERVE) as cli:
                for r in range(2):
                    cli.process_many(frames[r * B:(r + 1) * B])
                amp, meta = cli.flicker()
        finally:
            stop_server(srv, th)
    fl = FlickerAnalyzer(HZ_SERVE, FPS_SERVE, batch=B, device="cuda")
    fl.update(frames[:2 * B])
    same("[serve] flicker map", amp, fl.amplitude())
    if meta["frames"] != 2 * B or not np.isfinite(amp).all():
        raise AssertionError(f"[serve] flicker {meta}")
    log(f"[serve] flicker-armed coalesced session ({HZ_SERVE:g} Hz at "
        f"{FPS_SERVE:g} fps, {2 * B} frames): amplitude map equals a "
        f"FlickerAnalyzer on the card bit for bit (peak {amp.max():.2f})")


#: measured requests of each loadgen run: 40 from the one dedicated
#: client, 5 from each of the 8 coalesced clients
LOAD_REQUESTS = 40


def serve_load(props, card, served):
    """``python -m dips_tpu_torch.loadgen`` in a process of its own (its
    clients share no interpreter lock with the server) against a
    dedicated and a coalescing server: frames/s and client latency
    percentiles over LOAD_REQUESTS requests, with the server's request
    latency and the coalescer's mean fill."""
    import sys
    out = {}
    for label, kw, clients in (("dedicated", dict(), 1),
                               (f"coalesced x {FLEET}",
                                dict(coalesce=FLEET), FLEET)):
        frames = LOAD_REQUESTS // clients * B
        with served:
            srv, th = start_server(props, **kw)
            try:
                run = subprocess.run(
                    [sys.executable, "-m", "dips_tpu_torch.loadgen",
                     "--port", str(srv.port), "--clients", str(clients),
                     "--frames", str(frames), "--batch", str(B),
                     "--geometry", f"{H1080}x{W1080}"],
                    capture_output=True, text=True, timeout=300)
                m = srv.metrics()
            finally:
                stop_server(srv, th)
        lines = run.stdout.strip().splitlines()
        res = json.loads(lines[-1]) if lines else {"ok": False}
        if run.returncode != 0 or not res["ok"] or \
                res["requests"] != LOAD_REQUESTS:
            raise AssertionError(f"[serve] loadgen {label}: rc "
                                 f"{run.returncode} {res} {run.stderr}")
        lat = res["latency_ms"]
        res["server_latency_ms"] = m["latency_ms"]
        if "coalesce_mean_fill" in m:
            res["coalesce_mean_fill"] = m["coalesce_mean_fill"]
            res["coalesce_dispatches"] = m["coalesce_dispatches"]
        log(f"[serve] loadgen {label}: {clients} client(s) in their own "
            f"process, batch {B}, 1080p COLORIZE w3/T4: {res['fps']} "
            f"frames/s ({card})")
        log(f"[serve] loadgen {label}: client latency p50 {lat['p50']} ms, "
            f"p99 {lat['p99']} ms, max {lat['max']} ms over "
            f"{res['requests']} requests (p99 by nearest rank is the max "
            f"at 100 requests or fewer) ({card})")
        if "coalesce_mean_fill" in res:
            log(f"[serve] loadgen {label}: coalescer mean fill "
                f"{res['coalesce_mean_fill']} frames a dispatch over "
                f"{res['coalesce_dispatches']} dispatches ({card})")
        out[label] = res
    return out


def phase_serve(card):
    """The serving slice at 1080p on cuda:0, over TCP on localhost: the
    servers and the checking clients in this process, loadgen in its
    own."""
    from dips_tpu_torch import DiPsProperties, OutputMode
    work = os.path.join("build", "chip_smoke", "serve")
    os.makedirs(work, exist_ok=True)
    served = Served()
    clock = [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        log(f"[serve] {part}: {now - clock[0]:.1f} s")
        clock[0] = now

    colorize = DiPsProperties()
    absdiff = DiPsProperties(output=OutputMode.ABSDIFF)
    frames = moving_square_frames(3 * B, H1080, W1080, 97)
    cmaps, _ = serve_dedicated(colorize, frames, served, "COLORIZE w3/T4")
    serve_dedicated(absdiff, frames, served, "ABSDIFF")
    lap("dedicated sessions")

    # 8 coalesced clients, each its own stream, 2 requests of B frames
    frame = FleetFrames(103, H1080, W1080)
    feeds = [np.stack([frame(si, k) for k in range(2 * B)])
             for si in range(FLEET)]
    res, m = serve_coalesced(colorize, feeds, served, 2, "COLORIZE x 8")
    for si in range(FLEET):  # as [options] holds a fleet against engines
        o, s, _ = engine_batches(colorize, [feeds[si][:B], feeds[si][B:]])
        same(f"[serve] coalesced client {si} maps", res[si][0], o)
        _check_stats(f"[serve] coalesced client {si}", res[si][1], s, 1e-6)
    if served.counts["batch_step_ring_stacked"] <= 0:
        raise AssertionError("[serve] the stacked ring kernel never launched")
    log(f"[serve] coalesced x {FLEET} (COLORIZE w3/T4, 1080p, 8 concurrent "
        f"clients x 2 requests of {B}): each client equals a single-stream "
        f"DiPsEngine on its frames (maps byte for byte, stats within 1e-6); "
        f"{m['coalesce_dispatches']} dispatches, mean fill "
        f"{m['coalesce_mean_fill']} frames")
    lap("coalesced x 8")

    # --coalesce-mesh 2x3 on the one card: the band form (COLORIZE) equals
    # the same server without a mesh, the dyn_rows form (ABSDIFF with an
    # roi that the third row slab misses) single-stream engines; maps bit
    # for bit, stats as [grid] holds them (the slabs' partial sums add up
    # in another order)
    mres, _ = serve_coalesced(colorize, [f[:B] for f in feeds], served, 1,
                              "COLORIZE x 8 mesh", coalesce_mesh=GRID)
    for si in range(FLEET):
        same(f"[serve] mesh client {si} maps", mres[si][0], res[si][0][:B])
        _check_stats(f"[serve] mesh client {si}", mres[si][1],
                     res[si][1][:B], 1e-5)
    second = moving_square_frames(B, H1080, W1080, 101)
    absdiff_roi = DiPsProperties(output=OutputMode.ABSDIFF,
                                 roi=(100, 200, 500, 1700))
    rres, _ = serve_coalesced(absdiff_roi, [frames[:B], second], served, 1,
                              "ABSDIFF x 2 mesh", coalesce_mesh=GRID)
    for si, (maps, stats, _) in enumerate((
            engine_batches(absdiff_roi, [frames[:B]]),
            engine_batches(absdiff_roi, [second]))):
        same(f"[serve] mesh ABSDIFF client {si} maps", rres[si][0], maps)
        _check_stats(f"[serve] mesh ABSDIFF client {si}", rres[si][1],
                     stats, 1e-5)
    for name in ("batch_step_ring_stacked:slab_bands",
                 "absdiff_step_ring_stacked:dyn_rows"):
        if served.counts[name] <= 0:
            raise AssertionError(f"[serve] {name} never launched")
    log(f"[serve] --coalesce-mesh {GRID[0]}x{GRID[1]} on cuda:0: COLORIZE "
        f"x {FLEET} equals the server without a mesh bit for bit (slab "
        f"bands), ABSDIFF x 2 with an roi single-stream engines "
        f"(dyn_rows)")
    lap("coalesce mesh")
    serve_packed(served)
    lap("packed THRESHOLD")
    save_ms = serve_autosave(colorize, frames, cmaps, served, work)
    lap("autosave and restart")
    serve_flicker(colorize, frames, served)
    lap("flicker session")
    load = serve_load(colorize, card, served)
    lap("loadgen")
    for name, k in served.counts.items():
        if k <= 0:
            raise AssertionError(f"[serve] {name} never launched")
    log(f"[serve] launches by the servers: {served.counts}")
    log("[serve] " + json.dumps({"autosave_ms": save_ms, "loadgen": load,
                                 "card": card}))
    return served.counts


# ---------------------------------------------------------------------------
# the acceptance and scale-out slice: validate and the multi-host engine
# ---------------------------------------------------------------------------

#: gates that follow validate's case matrix in a full run, and its soak
VALIDATE_GATES, VALIDATE_SOAK = 7, 512


def phase_validate(card):
    """``python -m dips_tpu_torch.validate --with-soak 512 --json`` in a
    process of its own: every case against the numpy oracle on both
    protocols, the seven gates and the soak, on the kernels."""
    from dips_tpu_torch import validate
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out", "validate_torch.json")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "dips_tpu_torch.validate",
                          "--with-soak", str(VALIDATE_SOAK), "--json", path],
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"[validate] exit {res.returncode}:\n"
                             f"{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
    with open(path) as f:
        doc = json.load(f)
    want = 2 * len(validate.CASES) + VALIDATE_GATES + 1
    if not doc["ok"] or doc["failed"] or doc["passed"] != want or \
            len(doc["cases"]) != want:
        raise AssertionError(f"[validate] {doc['passed']} passed, "
                             f"{doc['failed']} failed, {want} expected")
    import torch
    if doc["device"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"[validate] ran on {doc['device']}")
    launches = {k: doc["launches"].get(k, 0) for k in KERNELS}
    unused = [k for k in KERNELS if ":" not in k and not launches[k]]
    if unused:  # every wrapper's kernel ran: nothing fell to the twins
        raise AssertionError(f"[validate] never launched: {unused}")
    soak = doc["cases"][-1]
    log(f"[validate] {doc['passed']} of {want} passed ({len(validate.CASES)}"
        f" cases x 2 protocols, {VALIDATE_GATES} gates, the "
        f"{VALIDATE_SOAK}-frame soak: frames/s {soak['fps']}) on {card}; "
        f"wall {wall:.1f} s, {doc['elapsed_s']} s inside")
    log("[validate] seconds a case: " + json.dumps(
        {c["case"]: c["seconds"] for c in doc["cases"]}) + f" ({card})")
    log(f"[validate] launches: {launches}")
    return launches


#: the [multihost] cluster: 2 ranks of MH_CELLS cells each, every cell
#: naming cuda:0; frames fed per (round, rank), round 1 the lockstep round
#: (rank 0's cameras all stalled); a per-process save and load, then one
#: more round of B frames each
MH_RANKS, MH_CELLS = 2, 4
MH_ROUNDS = ({0: B, 1: B}, {0: 0, 1: B}, {0: B, 1: B}, {0: B, 1: B})
MH_RESUME = 3  # the round before which each rank saves and reloads
MH_SEED = 151


def mh_fleets():
    from dips_tpu_torch import DiPsProperties, OutputMode
    return (("COLORIZE w3/T4", DiPsProperties()),
            ("STATS_ONLY", DiPsProperties(output=OutputMode.STATS_ONLY)))


def mh_rank_of(si):
    return si // (FLEET // MH_RANKS)


def mh_digest(maps):
    import hashlib
    return hashlib.sha1(np.ascontiguousarray(maps).data).hexdigest()


def multihost_worker(rank, port, work):
    """One rank of the [multihost] cluster: both fleets over MH_ROUNDS,
    every launch held against its plain twin; writes each round's map
    digests, stats, global mean and wall to ``work``/rank<r>.json."""
    import torch
    from dips_tpu_torch.ops import cuda_fused
    from dips_tpu_torch.parallel import (MultiHostStreamEngine,
                                         init_multihost, stream_mesh)
    info = init_multihost(f"127.0.0.1:{port}", MH_RANKS, rank)
    frame = FleetFrames(MH_SEED)
    doc = {"rank": rank, "info": [info.process_index, info.process_count],
           "fleets": {}}
    held = HeldRing(f"[multihost] rank {rank}", FLEET_KERNELS)
    with held:
        for label, props in mh_fleets():
            def engine():
                return MultiHostStreamEngine(
                    props, H1080, W1080, FLEET, batch=B,
                    mesh=stream_mesh(devices=["cuda:0"] * MH_CELLS),
                    device="cuda:0", ring_carry=True)
            eng = engine()
            ids = eng.local_stream_ids
            if ids != [si for si in range(FLEET) if mh_rank_of(si) == rank]:
                raise AssertionError(f"rank {rank} owns {ids}")
            cursor, rounds = 0, []
            for rnd, plan in enumerate(MH_ROUNDS):
                if rnd == MH_RESUME:
                    ck = os.path.join(work, f"ckpt_{rank}.npz")
                    eng.save(ck)
                    eng = engine()
                    eng.load(ck)
                n = plan[rank]
                feed = eng.local_frames_template()
                for si in ids:
                    feed[si] = [frame(si, cursor + k) for k in range(n)]
                torch.cuda.synchronize()
                t0, twins = time.perf_counter(), held.seconds
                maps, stats, gmean = eng.process_batch(feed)
                # the round's wall without its held twins
                wall = time.perf_counter() - t0 - (held.seconds - twins)
                if maps.shape[:2] != (len(ids), n):
                    raise AssertionError(f"rank {rank} maps {maps.shape}")
                rounds.append({"n": n, "wall_s": wall, "gmean": gmean,
                               "stats": stats.tolist(),
                               "digests": [mh_digest(m) for m in maps]})
                cursor += n
            doc["fleets"][label] = rounds
    for name in FLEET_KERNELS:
        if held.held[name] != held.counts[name]:
            raise AssertionError(f"rank {rank} {name}: {held.counts[name]} "
                                 f"launches, {held.held[name]} held")
    doc.update(launches=held.counts, flips=held.flips, px=held.px,
               heat_err=held.err)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(doc, f)
    import torch.distributed as dist
    dist.destroy_process_group()


def mh_reference(label, props, frame):
    """The single-process fleet on cuda:0 (no mesh) fed what the ranks fed
    (rank 0's streams nothing in round 1), uninterrupted: per round the map
    digests, stats, global mean and wall."""
    import torch
    from dips_tpu_torch import MultiStreamEngine
    eng = MultiStreamEngine(props, H1080, W1080, FLEET, batch=B,
                            device="cuda:0", input_layout="planar")
    cursors, rounds = [0] * FLEET, []
    for plan in MH_ROUNDS:
        feed = []
        for si in range(FLEET):
            n = plan[mh_rank_of(si)]
            feed.append([frame(si, cursors[si] + k) for k in range(n)])
            cursors[si] += n
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        maps, stats, gmean = eng.process_batch(feed)
        wall = time.perf_counter() - t0
        rounds.append({"wall_s": wall, "gmean": gmean, "stats": stats,
                       "digests": [mh_digest(m[:len(f)])
                                   for m, f in zip(maps, feed)]})
    return rounds


def phase_multihost(card):
    """Two ranks of ``MultiHostStreamEngine`` (processes of their own,
    4 cells each, all on cuda:0, joined by ``init_multihost`` over gloo)
    against one single-process fleet on the same card."""
    import socket
    work = os.path.abspath(os.path.join("build", "chip_smoke", "multihost"))
    os.makedirs(work, exist_ok=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--multihost-worker",
         str(r), str(port), work], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(MH_RANKS)]
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=420)  # a hang fails the phase
            if p.returncode != 0:
                raise AssertionError(f"[multihost] rank {r} exit "
                                     f"{p.returncode}:\n{out[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    cluster_s = time.perf_counter() - t0
    docs = []
    for r in range(MH_RANKS):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            docs.append(json.load(f))
    frame = FleetFrames(MH_SEED)
    walls = {}
    for label, props in mh_fleets():
        ref = mh_reference(label, props, frame)
        for r, doc in enumerate(docs):
            ids = [si for si in range(FLEET) if mh_rank_of(si) == r]
            for rnd, (got, exp) in enumerate(zip(doc["fleets"][label], ref)):
                n = got["n"]
                if got["digests"] != [exp["digests"][si] for si in ids]:
                    raise AssertionError(f"[multihost] {label} rank {r} "
                                         f"round {rnd}: maps differ")
                if not np.array_equal(
                        np.asarray(got["stats"], np.float32).reshape(
                            len(ids), n, 4), exp["stats"][ids, :n]):
                    raise AssertionError(f"[multihost] {label} rank {r} "
                                         f"round {rnd}: stats differ")
                if abs(got["gmean"] - exp["gmean"]) > 1e-6:
                    raise AssertionError(
                        f"[multihost] {label} rank {r} round {rnd}: global "
                        f"mean {got['gmean']} != {exp['gmean']}")
        walls[label] = {
            "ranks_s": [[rd["wall_s"] for rd in d["fleets"][label]]
                        for d in docs],
            "single_process_s": [rd["wall_s"] for rd in ref]}
    launches = {k: sum(d["launches"][k] for d in docs)
                for k in FLEET_KERNELS}
    if not all(launches.values()):
        raise AssertionError(f"[multihost] launches {launches}")
    log(f"[multihost] 2 ranks x {MH_CELLS} cells, all on cuda:0 (two "
        f"processes on ONE card: this shows the all-reduce and the "
        f"lockstep round, not scaling across cards): 1080p x {FLEET} "
        f"streams, B={B}, ring protocol, COLORIZE w3/T4 and STATS_ONLY, "
        f"{len(MH_ROUNDS)} rounds (rank 0 idle in round 1, a per-process "
        f"save and load before round {MH_RESUME}): each rank's maps and "
        f"stats equal the single-process fleet bit for bit, global means "
        f"within 1e-6; every launch held against its plain twin "
        f"({sum(d['flips'] for d in docs)} of {sum(d['px'] for d in docs)} "
        f"map values differ by 1 LSB)")
    log("[multihost] " + json.dumps({"round_walls": walls,
                                     "cluster_s": cluster_s,
                                     "launches": launches, "card": card}))
    return launches


# ---------------------------------------------------------------------------
# the examples: dips_tpu_torch.examples on the card against their --cpu runs
# ---------------------------------------------------------------------------

#: the examples run in this process (the ninth, multi_host, runs its own
#: two ranks)
EXAMPLES = ("single_video", "multi_stream", "fleet_telemetry",
            "scene_analysis", "pod_fleet_grid", "serving", "motion_alerts",
            "camera_fleet")
#: the wrappers the examples must launch: PERF.md §6 rows 1, 2, 6 and 7
#: (pod_fleet_grid's raw slabs have no roi, so no row window: row 2's
#: kernel at slab shapes, not row 5's form)
EXAMPLE_KERNELS = ("absdiff_step_ring", "absdiff_step_ring_stacked",
                   "batch_step_ring", "batch_step_ring_stacked")


def run_example(name, work):
    """``python -m dips_tpu_torch.examples.<name>`` (no flag: the card) in
    this process, in its own working directory: (exit code, stdout)."""
    import contextlib
    import io
    import runpy
    os.makedirs(work, exist_ok=True)
    here, saved_argv = os.getcwd(), sys.argv
    out, rc = io.StringIO(), 0
    os.chdir(work)
    sys.argv = [name]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_module(f"dips_tpu_torch.examples.{name}",
                             run_name="__main__")
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else (e.code is not None)
    finally:
        os.chdir(here)
        sys.argv = saved_argv
    return rc, out.getvalue()


def phase_examples(card):
    """The nine examples on the card: eight in this process under one
    :class:`HeldRing` (every ring launch held against its plain twin, the
    servers' threads included), ``multi_host`` as its own two ranks on
    cuda:0; each card run's stdout held against the same example's
    ``--cpu`` run, made here in processes of their own, through
    ``examples._compare``.  Untimed: the seconds printed are the phase's
    own, no speed."""
    from dips_tpu_torch.examples import _compare
    work = os.path.abspath(os.path.join("build", "chip_smoke", "examples"))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.abspath("."), os.environ.get("PYTHONPATH", "")]))

    def start(name, argv, where):
        os.makedirs(where, exist_ok=True)
        return subprocess.Popen(
            [sys.executable, "-m", f"dips_tpu_torch.examples.{name}"]
            + argv, cwd=where, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    # the --cpu runs and the card's multi_host, beside the in-process runs
    names = EXAMPLES + ("multi_host",)
    cpu = {n: start(n, ["--cpu"], os.path.join(work, "cpu", n))
           for n in names}
    mh = start("multi_host", [], os.path.join(work, "card", "multi_host"))
    card_out, secs = {}, {}
    try:
        with HeldRing("[examples]", SERVE_KERNELS) as held:
            for name in EXAMPLES:
                t0 = time.perf_counter()
                rc, card_out[name] = run_example(
                    name, os.path.join(work, "card", name))
                secs[name] = round(time.perf_counter() - t0, 1)
                if rc != 0:
                    raise AssertionError(f"[examples] {name} exit {rc}:\n"
                                         f"{card_out[name][-3000:]}")
        outs = {}
        for name, p in list(cpu.items()) + [("multi_host card", mh)]:
            out, err = p.communicate(timeout=300)
            if p.returncode != 0:
                raise AssertionError(f"[examples] {name} --cpu exit "
                                     f"{p.returncode}:\n{err[-3000:]}")
            outs[name] = out
    finally:
        for p in list(cpu.values()) + [mh]:
            if p.poll() is None:
                p.kill()
                p.wait()
    card_out["multi_host"] = outs.pop("multi_host card")
    log("[examples] " + json.dumps({"seconds": secs,
                                    "launches": held.counts}))
    for name in names:
        _compare.check(name, card_out[name], outs[name])
    for name in EXAMPLE_KERNELS:
        if held.counts[name] <= 0:
            raise AssertionError(f"[examples] {name} never launched")
    for name in held.names:
        if ":" not in name and held.held[name] != held.counts[name]:
            raise AssertionError(f"[examples] {name}: {held.counts[name]} "
                                 f"launches, {held.held[name]} held")
    log(f"[examples] the nine examples on {card}: each card run's stdout "
        f"equals its --cpu run's under examples._compare; every launch of "
        f"the eight in this process held against its plain twin "
        f"({held.flips} of {held.px} map values differ by 1 LSB); "
        f"multi_host's two ranks on cuda:0")
    return held.counts


# ---------------------------------------------------------------------------
# phase: the block geometry (a build parameter) and the tuner
# ---------------------------------------------------------------------------

#: the non-default geometries [autotune] builds and holds (1080p: a tile's
#: rows divide 1080)
AUTOTUNE_TILES = ((24, 2, 2), (8, 1, 4))
AUTOTUNE_BLOCKS = ((512, 32), (128, 16))


def _geometry_batches(kind, props, geometry, plain=False):
    """Two consecutive 1080p batches (``_two_batches``) through the exact
    ring (``kind`` "median") or the raw ring kernel at ``geometry`` (None:
    the default), or through its plain twin; each batch's results
    cloned."""
    import torch
    from dips_tpu_torch.ops import cuda_fused
    from dips_tpu_torch.ops.reference import pad_geometry
    dev = torch.device("cuda")
    hp, wp = pad_geometry(H1080, W1080)
    t = props.temporal_size
    if kind == "median":
        st = [torch.zeros((t, hp, wp), device=dev)] + [
            torch.zeros((hp, wp), device=dev) for _ in range(3)]
    else:
        st = [torch.zeros((3, hp, wp), dtype=torch.uint8, device=dev)
              for _ in range(2)] + [torch.zeros((hp, wp), device=dev)]
    runs = []
    for x, flags, valid, off, seed in _two_batches(hp, wp, H1080, W1080,
                                                    21, dev):
        if kind == "median" and plain:
            res = cuda_fused.batch_step_ring_plain(
                props, H1080, W1080, x, *st[:3], flags, st[3], valid,
                off % t, seed)
        elif kind == "median":
            res, used = cuda_fused._launch_median(
                "batch_step_ring", props, H1080, W1080, 1, x, *st[:3],
                flags.reshape(1, B), st[3], valid.reshape(1, B),
                [off % t], [seed], tile=geometry)
        elif plain:
            res = cuda_fused.absdiff_step_ring_plain(
                props, H1080, W1080, x, *st[:2], flags, st[2], valid, seed)
        else:
            res, used = cuda_fused._launch_raw(
                "absdiff_step_ring", props, H1080, W1080, 1, x, *st[:2],
                flags.reshape(1, B), st[2], valid.reshape(1, B), [seed],
                block=geometry)
        if not plain and geometry is not None and used != geometry:
            raise AssertionError(f"[autotune] launched {used}, asked for "
                                 f"{geometry}")
        runs.append([r.clone() for r in res])
    torch.cuda.synchronize()
    return runs


def _hold_geometry(tag, kind, got, dflt, plain):
    """A geometry's two batches against the default geometry's (maps and
    state bit for bit, stats within 1e-5 for the median kernel, bit for
    bit for the raw one) and the plain twin's (the [check] tolerances)."""
    import torch
    from dips_tpu_torch.autotune import _stats_agree
    for b, (g, d, p) in enumerate(zip(got, dflt, plain)):
        for i, (x, y) in enumerate(zip(g, d)):
            same = (_stats_agree(x.reshape(-1, 4), y.reshape(-1, 4))
                    if i == 1 and kind == "median" else torch.equal(x, y))
            if not same:
                raise AssertionError(f"{tag}: output {i} of batch {b} "
                                     f"differs from the default geometry's")
        if kind == "median":
            dd = (g[0][..., :H1080, :W1080].to(torch.int16)
                  - p[0][..., :H1080, :W1080].to(torch.int16)).abs()
            flips = int((dd > 0).sum())
            if int(dd.max()) > MEDIAN_TOL["lsb"] or \
                    flips > MEDIAN_TOL["flip_frac"] * dd.numel():
                raise AssertionError(f"{tag}: maps differ from the plain "
                                     f"twin")
            state, tol = zip(g[2:5], p[2:5]), MEDIAN_TOL
        else:
            if not torch.equal(g[0], p[0]):
                raise AssertionError(f"{tag}: maps differ from the plain "
                                     f"twin")
            state, tol = zip(g[2:4], p[2:4]), RAW_TOL
        for x, y in state:
            if not torch.equal(x[..., :H1080, :W1080],
                               y[..., :H1080, :W1080]):
                raise AssertionError(f"{tag}: carried state differs from "
                                     f"the plain twin")
        if _max_err(g[-1], p[-1]) > tol["heat_atol"]:
            raise AssertionError(f"{tag}: heatmap differs from the plain "
                                 f"twin")
        _check_stats(tag, g[1].reshape(-1, 4), p[1].reshape(-1, 4),
                     tol["stats_rtol"])


@contextlib.contextmanager
def _tuning_store(path):
    """The tuning store at ``path`` for the launches inside."""
    from dips_tpu_torch.ops import tuning
    old = os.environ.get("DIPS_TPU_TORCH_AUTOTUNE_CACHE")
    os.environ["DIPS_TPU_TORCH_AUTOTUNE_CACHE"] = path
    tuning.invalidate()
    try:
        yield
    finally:
        if old is None:
            del os.environ["DIPS_TPU_TORCH_AUTOTUNE_CACHE"]
        else:
            os.environ["DIPS_TPU_TORCH_AUTOTUNE_CACHE"] = old
        tuning.invalidate()


def _write_store(path, **entries):
    """A fresh store at ``path`` holding ``entries`` for this card."""
    import torch
    from dips_tpu_torch.ops import tuning
    if os.path.exists(path):
        os.remove(path)
    with _tuning_store(path):
        tuning.save(torch.cuda.get_device_name(0), **entries)
    return path


def _engine_with_store(props, frames, store):
    """One 1080p batch through a ``DiPsEngine`` with the tuning store at
    ``store`` -> (maps, stats, launches per wrapper and geometry)."""
    from dips_tpu_torch import DiPsEngine
    from dips_tpu_torch.ops import cuda_fused
    with _tuning_store(store):
        eng = DiPsEngine(props, H1080, W1080, batch=B, device="cuda")
        cuda_fused.reset_launch_counts()
        out, stats = eng.process_batch(frames)
        return out, stats, cuda_fused.geometry_counts()


def _grid_with_store(props, frame, store):
    """One batch of the 1080p x 8 ring fleet on the one-card GRID (bands)
    with the tuning store at ``store`` -> (batches, state, launches per
    wrapper and geometry)."""
    import torch
    from dips_tpu_torch.ops import cuda_fused
    with _tuning_store(store):
        cuda_fused.reset_launch_counts()
        batches, state = run_grid_batches(props, frame, 1, True,
                                          one_card_mesh(*GRID), "bands")
        torch.cuda.synchronize()
        return batches, state, cuda_fused.geometry_counts()


#: the tuner's probes at ``--windows 3 --mesh 2x3 --stacked 4``
TUNER_ARGS = ("--windows", "3", "--mesh", "2x3", "--stacked", "4",
              "--dry-run")
TUNER_PROBES = ("ring w3", "tail w3", "stacked[4] ring w3",
                "slab[2x3] ring w3", "stacked[4]-slab[2x3] ring w3", "raw",
                "stacked[4] raw")


def _tuner_call(work, i):
    """``python -m dips_tpu_torch.autotune TUNER_ARGS`` in a process of its
    own, the store pointed at a scratch file that the dry run must leave
    unwritten -> ({probe: chosen geometry}, its chosen lines, seconds)."""
    store = os.path.join(work, f"autotune{i}.json")
    if os.path.exists(store):
        os.remove(store)
    env = dict(os.environ, DIPS_TPU_TORCH_AUTOTUNE_CACHE=store,
               PYTHONPATH=os.pathsep.join(
                   [os.path.abspath("."), os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "dips_tpu_torch.autotune",
                          *TUNER_ARGS], env=env, capture_output=True,
                         text=True, timeout=400)
    secs = time.perf_counter() - t0
    with open(os.path.join(work, f"tuner{i}.log"), "w") as f:
        f.write(res.stdout + res.stderr)
    if res.returncode != 0:
        raise AssertionError(f"[autotune] tuner call {i} exit "
                             f"{res.returncode}:\n{res.stderr[-3000:]}")
    lines = [ln for ln in res.stdout.splitlines()
             if ln.startswith("[autotune]")]
    if not any("dry run" in ln for ln in lines) or os.path.exists(store):
        raise AssertionError("[autotune] the dry run wrote the store or "
                             "did not say it was one")
    chosen = [ln for ln in lines if ln.startswith("[autotune] chosen ")]
    picks = {}
    for ln in chosen:
        label, rest = ln[len("[autotune] chosen "):].split(": ", 1)
        picks[label] = rest.split(" ", 1)[0]
    if sorted(picks) != sorted(TUNER_PROBES):
        raise AssertionError(f"[autotune] tuner call {i} probed "
                             f"{sorted(picks)}, not {sorted(TUNER_PROBES)}")
    return picks, lines, secs


def phase_autotune(card):
    """The kernels' block geometry as a build parameter, and the tuner:
    two non-default tiles of the exact w3 ring kernel and two non-default
    blocks of the raw ABSDIFF ring kernel, built for their units alone (in
    parallel), each held at 1080p, B = 16 over two batches against the
    default geometry's launch and the plain twin; the two tiles in the
    stacked band form too (s = 4 owned 360-row slabs with bands, the grid
    fleet's launch) against the default's; one engine batch with a store
    that names a non-default tile and block, which its launches must use,
    and whose outputs must equal the default engine's; one batch of the
    1080p x 8 grid fleet with a store naming a stacked-slab tile (its band
    launches must take it) and with one naming only the s = 1 slab tile
    (they must keep the default); two calls of ``python -m
    dips_tpu_torch.autotune --windows 3 --mesh 2x3 --stacked 4 --dry-run``,
    each in a process of its own with the store pointed at a scratch file,
    which must choose the same geometry for every probe (their probe
    times printed here, with this card's line).  Equality, not timing:
    the tuner's times are its own."""
    from dips_tpu_torch import autotune
    from dips_tpu_torch.ops import _build
    from dips_tpu_torch.ops._build import Geometry, MedianTile, RawBlock
    from dips_tpu_torch.properties import DiPsProperties, OutputMode
    work = os.path.abspath(os.path.join("build", "chip_smoke", "autotune"))
    os.makedirs(work, exist_ok=True)
    tiles = [MedianTile(*t) for t in AUTOTUNE_TILES]
    blocks = [RawBlock(*b) for b in AUTOTUNE_BLOCKS]
    t0 = time.perf_counter()
    autotune._build_all(
        [(Geometry(tile=t), (_build.median_unit(False, 3),)) for t in tiles]
        + [(Geometry(block=b), (_build.RAW_UNIT,)) for b in blocks])
    log(f"[autotune] built {len(tiles) + len(blocks)} geometries, one unit "
        f"each, in {time.perf_counter() - t0:.1f} s")
    cases = (("median", DiPsProperties(), tiles),
             ("raw", DiPsProperties(output=OutputMode.ABSDIFF), blocks))
    for kind, props, geoms in cases:
        dflt = _geometry_batches(kind, props, None)
        plain = _geometry_batches(kind, props, None, plain=True)
        for g in geoms:
            got = _geometry_batches(kind, props, g)
            _hold_geometry(f"[autotune] {kind} {g.name()}", kind, got, dflt,
                           plain)
            log(f"[autotune] {kind} {g.name()} 1080p B={B}: equal to the "
                f"default geometry's launch and within the plain twin's "
                f"tolerance over two batches")
    s_l, r_ax = FLEET // GRID[0], GRID[1]
    hold, _, hs, _ = autotune._median_measure_factory(
        3, H1080, W1080, 4, B, s=s_l, rows_ax=r_ax, seed=41)
    for g in tiles:
        hold(g)
        log(f"[autotune] median {g.name()} stacked band form, s = {s_l} "
            f"owned {hs}-row slabs with bands, B={B}: maps, ring / prev / "
            f"baseline / heatmap equal to the default tile's bit for bit, "
            f"stats within 1e-5, over two batches")

    no_store = os.path.join(work, "no-store.json")
    if os.path.exists(no_store):
        os.remove(no_store)
    frames = moving_square_frames(B, H1080, W1080, 31)
    for props, name, geom in (
            (DiPsProperties(), "batch_step_ring", tiles[0]),
            (DiPsProperties(output=OutputMode.ABSDIFF), "absdiff_step_ring",
             blocks[0])):
        out0, stats0, geo0 = _engine_with_store(props, frames, no_store)
        key = "ring_tiles" if name == "batch_step_ring" else "raw_block"
        path = _write_store(os.path.join(work, f"store-{name}.json"),
                            **{key: {3: geom} if key == "ring_tiles"
                               else geom})
        out1, stats1, geo1 = _engine_with_store(props, frames, path)
        dname = (_build.DEFAULT.tile if name == "batch_step_ring"
                 else _build.DEFAULT.block).name()
        if geo0 != {name: {dname: 1}} or geo1 != {name: {geom.name(): 1}}:
            raise AssertionError(f"[autotune] engine launches {geo0} "
                                 f"without the store, {geo1} with it")
        if not np.array_equal(out0, out1):
            raise AssertionError(f"[autotune] {name}: engine maps differ "
                                 f"with the stored geometry")
        _check_stats(f"[autotune] {name} engine", stats1, stats0,
                     MEDIAN_TOL["stats_rtol"])
        log(f"[autotune] engine {name} with a store naming {geom.name()}: "
            f"launched it ({geo1[name]}), outputs equal to the default "
            f"engine's")

    # the grid fleet's band launches: a stored stacked-slab tile reaches
    # them; the s = 1 slab tile alone does not
    frame, props = FleetFrames(77), DiPsProperties()
    name, cells = "batch_step_ring_stacked", GRID[0] * GRID[1]
    dname = _build.DEFAULT.tile.name()
    exp, estate, geo0 = _grid_with_store(props, frame, no_store)
    for label, entries, want in (
            ("stacked_slab_ring_tiles", dict(stacked_slab_ring_tiles={
                3: {hs: tiles[0]}}), tiles[0].name()),
            ("slab_ring_tiles alone", dict(slab_ring_tiles={
                3: {hs: tiles[0]}}), dname)):
        path = _write_store(os.path.join(work, "store-grid.json"),
                            **entries)
        got, gstate, geo1 = _grid_with_store(props, frame, path)
        if geo0 != {name: {dname: cells}} or geo1 != {name: {want: cells}}:
            raise AssertionError(f"[autotune] grid fleet launches {geo0} "
                                 f"without a store, {geo1} with "
                                 f"{label}")
        _same_fleet_runs(f"[autotune] grid fleet, {label}", got, exp)
        _same_fleet_state(f"[autotune] grid fleet, {label}", gstate, estate)
        log(f"[autotune] grid fleet 1080p x {FLEET} on a {GRID} grid, "
            f"bands, a store with {label}[3][{hs}] = {tiles[0].name()}: "
            f"{cells} band launches of {want}, maps and carried state equal "
            f"to the fleet's without a store")
        del got, gstate
    del exp, estate

    calls = [_tuner_call(work, i) for i in (1, 2)]
    log(f"[autotune] {card}")
    for ln in calls[0][1]:
        log(ln)
    for i, (picks, lines, secs) in enumerate(calls, 1):
        log(f"[autotune] tuner call {i}, {' '.join(TUNER_ARGS)}: "
            f"{secs:.1f} s")
        for ln in lines:
            if ln.startswith("[autotune] chosen "):
                log(f"[autotune] call {i}: {ln[len('[autotune] '):]}")
    if calls[0][0] != calls[1][0]:
        raise AssertionError(f"[autotune] two tuner calls chose "
                             f"differently: {calls[0][0]} against "
                             f"{calls[1][0]}")
    log(f"[autotune] two tuner calls chose the same geometry for all "
        f"{len(TUNER_PROBES)} probes: {calls[0][0]}")


# ---------------------------------------------------------------------------
# phase 7: times on this card
# ---------------------------------------------------------------------------

def _time(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def engine_fps(eng, batches, label, card, n_b=12, packed=False):
    """Frames/s of ``eng`` end to end over ``n_b`` batches (host frames
    in, host maps out, or the packed masks with ``packed``; ``batches``
    alternate) after one warm-up batch."""
    import torch
    eng.process_batch(list(batches[0]))  # warm-up
    torch.cuda.synchronize()
    t_disp = t_coll = 0.0
    t0 = time.perf_counter()
    for i in range(n_b):
        buf = eng.new_batch_buffer()
        a = time.perf_counter()
        for j, f in enumerate(batches[i % 2]):
            buf[j] = f
        h = eng.dispatch_async(buf, B)
        c = time.perf_counter()
        eng.collect(h, packed=packed)
        d = time.perf_counter()
        t_disp += c - a
        t_coll += d - c
    fps = n_b * B / (time.perf_counter() - t0)
    log(f"[time] {label}: {fps:.1f} frames/s end to end over {n_b * B} "
        f"frames (host fill+upload+launch {1e3 * t_disp / (n_b * B):.3f} "
        f"ms/frame, sync+download {1e3 * t_coll / (n_b * B):.3f} "
        f"ms/frame); {card}")
    return fps


def kernel_alone(fn, reps=20):
    """ms per call of the step kernels (raw or median) that ``fn``
    launches, from their device intervals in a ``torch.profiler`` trace;
    None when the trace shows no such kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == DeviceType.CUDA and "_kernel" in e.name
          and ("raw_step" in e.name or "median_" in e.name)]
    return sum(us) / 1e3 / reps if us else None


def time_wrapper(key, kernel, plain, frames, props, name, hp, wp, card,
                 plain_reps=3, slabs=0, shape=None, b=B):
    """Wrapper (plain / kernel / kernel / plain, CUDA events), the kernel
    alone (:func:`kernel_alone`) and the bound, in ms per stream-frame.
    One call covers ``frames`` stream-frames in batches of ``b``; ``hp`` are
    the rows of one stream and ``slabs`` its band-fed row slabs
    (:func:`bound`); ``shape`` words the log line."""
    got = {"plain": [], "kernel": []}
    for which, fn in (("plain", plain), ("kernel", kernel),
                      ("kernel", kernel), ("plain", plain)):
        got[which].append(_time(fn, 20 if which == "kernel" else plain_reps)
                          / frames)
    bound_ms, bound_by = bound(name, props, frames // b, b, hp, wp, slabs)
    res = {w: float(np.mean(v)) for w, v in got.items()}
    res.update(bound_ms=bound_ms, bound_by=bound_by)
    alone = kernel_alone(kernel)
    res["alone"] = None if alone is None else alone / frames
    if shape is None:
        shape = f"1080p B={B}" + (f" s={frames // B}" if frames > B else "")
    log(f"[time] {key} {shape}: kernel {res['kernel']:.4f} ms/frame "
        f"({got['kernel']}), alone "
        + ("not measured (no kernel in the profiler trace)"
           if alone is None else f"{res['alone']:.4f}")
        + f", plain {res['plain']:.4f} ms/frame ({got['plain']}), bound "
        f"{bound_ms:.5f} ms/frame by {bound_by}; frame = one stream's "
        f"frame; {card}")
    return res


def times_of_variants(card):
    """The four median wrappers in each spatial variant (and the exact w7
    for comparison) at 1080p: s = 1 for every variant, s = 8 for the
    [options] variants."""
    import torch
    from dips_tpu_torch.ops import cuda_fused as cf
    from dips_tpu_torch.ops.reference import pad_geometry
    from dips_tpu_torch.properties import DiPsProperties
    dev = torch.device("cuda")
    hp, wp = pad_geometry(H1080, W1080)
    t = 4
    raw = planar(moving_square_frames(t + B, H1080, W1080, 33), hp,
                 wp).to(dev)
    sraw = stacked_frames(t + B, H1080, W1080, FLEET, 34, dev)
    configs = [(mode, w, 1) for mode, w in VARIANTS] + [("exact", 7, 1)] + [
        (mode, w, FLEET) for mode, w in MAIN_VARIANTS.items()]
    times = {}
    for mode, w, s in configs:
        props = (DiPsProperties(window_size=w) if mode == "exact"
                 else variant_props(mode, w))
        rows = (s * hp, wp)
        flags = torch.zeros((s, B), dtype=torch.bool, device=dev)
        flags[:, 0] = True
        valid = torch.ones((s, B), dtype=torch.bool, device=dev)
        zs = [0] * s
        for ring in (True, False):
            name = ("batch_step_ring" if ring else "batch_step") + (
                "_stacked" if s > 1 else "")
            st = [torch.zeros((t,) + rows, device=dev)] + [
                torch.zeros(rows, device=dev) for _ in range(3)]
            x = (sraw if s > 1 else raw)
            fl, va = (flags, valid) if s > 1 else (flags[0], valid[0])
            one = (() if s == 1 else (s,))
            if ring:
                ta = (zs, zs) if s > 1 else (0, 0)
                args = (props, H1080, W1080, *one, x[t:], *st[:3], fl, st[3],
                        va, *ta)
            else:
                args = (props, H1080, W1080, *one, x, st[2], fl, st[3], va)
            fn = getattr(cf, name)
            plain_fn = getattr(cf, name + "_plain")
            key = name + ("" if mode == "exact" else f":{mode}")
            label = f"{key} {ptag(props)}"
            times[label] = time_wrapper(
                label, lambda: fn(*args), lambda: plain_fn(*args),
                s * B, props, key, hp, wp, card, plain_reps=1)
            if MAIN_VARIANTS.get(mode) == w:
                times[key] = times[label]
    return times


def times_of_slabs(card):
    """The six slab forms at the [grid] path's cell shape: the 1080p x 8
    fleet on the (2, 3) grid, so one call is the grid's six launches of 4
    streams x 360 rows (128 stream-frames at B = 16; the dyn_rows forms of
    the median kernels on sections extended to 376 rows, as the extended
    construction gives them).  And the ring bands form for one stream: 1080p
    in 3 slabs, and 8K (4320 x 7680) in 4 slabs at B = 4."""
    import torch
    from dips_tpu_torch.ops.reference import pad_geometry
    from dips_tpu_torch.parallel import grid2d
    from dips_tpu_torch.parallel.mesh import Layout
    from dips_tpu_torch.properties import DiPsProperties, OutputMode
    dev = torch.device("cuda")
    mp = DiPsProperties()
    rp = DiPsProperties(output=OutputMode.ABSDIFF, roi=(400, 100, 1000, 1700))
    t = mp.temporal_size
    times = {}

    def cell_calls(name, props, h, w, s_ax, r_ax, s, b, raw):
        """(kernel call, plain call, rows of one stream's sections) of slab
        form ``name`` over every cell of an (s_ax, r_ax) grid."""
        base, form = name.split(":")
        ring = "ring" in base
        hp, wp = pad_geometry(h, w)
        lay = Layout(one_card_mesh(s_ax, r_ax), s, hp, wp)
        cells = lay.scatter(raw if not ring else raw[-b:])
        ext = 0 if form == "slab_bands" or _raw_mode(props) else grid2d._EXT
        _, kernel, plain = _step_fns(props, ring)
        flags = torch.zeros((lay.s_l, b), dtype=torch.bool, device=dev)
        flags[:, 0] = True
        valid = torch.ones((lay.s_l, b), dtype=torch.bool, device=dev)
        zs = [0] * lay.s_l
        args = []
        for i in range(s_ax):
            exch = grid2d._band_exchange_u8(cells[i], lay.s_l)
            for j in range(r_ax):
                x, kw = cells[i][j], {}
                if _raw_mode(props):
                    kw["row_bounds"] = grid2d._raw_grid_bounds(
                        props, h, w, lay.hs, j)
                else:
                    kw["row_bounds"] = grid2d._slab_row_bounds(
                        props, h, w, lay.hs, j, ext=ext)
                    if ext:
                        x = grid2d._extend(x, lay.s_l, *exch[j])
                    else:
                        kw["bands"] = exch[j]
                st = _slab_state(props, (x.shape[-2], wp), ring, dev)
                args.append((x, st, kw))
        run = lambda fn: [_slab_call(fn, props, h, w, lay.s_l, x, st, flags,
                                     valid, zs, zs, ring, **kw)
                          for x, st, kw in args]
        return (lambda: run(kernel)), (lambda: run(plain)), \
            r_ax * (lay.hs + 2 * ext)

    sraw = stacked_frames(t + B, H1080, W1080, FLEET, 35, dev)
    hp, wp = pad_geometry(H1080, W1080)
    for name in SLAB_NAMES:
        props = rp if name.startswith("absdiff") else mp
        k, p, rows = cell_calls(name, props, H1080, W1080, *GRID, FLEET, B,
                                sraw)
        times[name] = time_wrapper(
            name, k, p, FLEET * B, props, name, rows, wp, card, plain_reps=1,
            slabs=GRID[1] if name.endswith("slab_bands") else 0,
            shape=f"1080p x {FLEET} on a {GRID} grid, B={B}")
    name = "batch_step_ring_stacked:slab_bands"
    k, p, rows = cell_calls(name, mp, H1080, W1080, 1, 3, 1, B,
                            sraw[:, :, :hp])
    times[name + " 1080p R=3 s=1"] = time_wrapper(
        name, k, p, B, mp, name, rows, wp, card, plain_reps=1, slabs=3,
        shape=f"1080p, one stream in 3 slabs, B={B}")
    del sraw, k, p
    b8 = 4
    hp8, wp8 = pad_geometry(H8K, W8K)
    k, p, rows = cell_calls(name, mp, H8K, W8K, 1, 4, 1, b8,
                            noise_frames(b8, H8K, W8K, 1, 36, dev))
    times[name + " 8K R=4 s=1"] = time_wrapper(
        name, k, p, b8, mp, name, rows, wp8, card, plain_reps=1, slabs=4,
        shape=f"8K {H8K}x{W8K}, one stream in 4 slabs, B={b8}", b=b8)
    return times


def times_of_options(card):
    """THRESHOLD engine frames/s without packed_wire, with it (maps
    unpacked on the host) and with it collecting the packed bytes, in
    turns; and the 4K -> 1080p (downscale=2) COLORIZE engine's."""
    from dips_tpu_torch import DiPsEngine, DiPsProperties, OutputMode
    times = {}
    frames = moving_square_frames(2 * B, H1080, W1080, 43)
    props = DiPsProperties(output=OutputMode.THRESHOLD)
    runs = (("", False, False), (" packed_wire", True, False),
            (" packed_wire collect(packed=True)", True, True))
    for label, packed_wire, packed in runs + runs[::-1]:
        key = "engine THRESHOLD" + label
        times.setdefault(key, []).append(engine_fps(
            DiPsEngine(props, H1080, W1080, batch=B, device="cuda",
                       packed_wire=packed_wire), [frames[:B], frames[B:]],
            f"{key} 1080p B={B}", card, packed=packed))
    f4 = [moving_square_frames(B, H4K, W4K, 45, start=i * B)
          for i in range(2)]
    times["engine COLORIZE 4K->1080p downscale=2"] = engine_fps(
        DiPsEngine(DiPsProperties(), H4K, W4K, batch=B, device="cuda",
                   downscale=2), f4, f"engine COLORIZE 4K->1080p "
        f"downscale=2 B={B}", card)
    return times


def phase_times(card):
    import torch
    from dips_tpu_torch import DiPsEngine, DiPsProperties, OutputMode
    from dips_tpu_torch.ops import cuda_fused
    from dips_tpu_torch.ops.reference import pad_geometry
    dev = torch.device("cuda")
    hp, wp = pad_geometry(H1080, W1080)
    rp, mp = DiPsProperties(output=OutputMode.ABSDIFF), DiPsProperties()
    t = mp.temporal_size
    s = FLEET
    rows = (s * hp, wp)
    # T+B frames: the ring steps take the last B, the tail steps all
    raw = planar(moving_square_frames(t + B, H1080, W1080, 31), hp,
                 wp).to(dev)
    sraw = stacked_frames(t + B, H1080, W1080, s, 32, dev)
    flags = torch.zeros(B, dtype=torch.bool, device=dev)
    flags[0] = True
    valid = torch.ones(B, dtype=torch.bool, device=dev)
    sflags = torch.zeros((s, B), dtype=torch.bool, device=dev)
    sflags[:, 0] = True
    svalid = torch.ones((s, B), dtype=torch.bool, device=dev)
    zs = [0] * s
    u8 = dict(dtype=torch.uint8, device=dev)
    rs = [torch.zeros((3, hp, wp), **u8) for _ in range(2)] + [
        torch.zeros((hp, wp), device=dev)]
    ms = [torch.zeros((t, hp, wp), device=dev)] + [
        torch.zeros((hp, wp), device=dev) for _ in range(3)]
    srs = [torch.zeros((3,) + rows, **u8) for _ in range(2)] + [
        torch.zeros(rows, device=dev)]
    sms = [torch.zeros((t,) + rows, device=dev)] + [
        torch.zeros(rows, device=dev) for _ in range(3)]
    cf = cuda_fused
    # name -> (kernel call, plain call, stream-frames per call)
    calls = {
        "absdiff_step_ring": (
            lambda: cf.absdiff_step_ring(rp, H1080, W1080, raw[t:], *rs[:2],
                                         flags, rs[2], valid, 0),
            lambda: cf.absdiff_step_ring_plain(rp, H1080, W1080, raw[t:],
                                               *rs[:2], flags, rs[2], valid,
                                               0), B),
        "batch_step_ring": (
            lambda: cf.batch_step_ring(mp, H1080, W1080, raw[t:], *ms[:3],
                                       flags, ms[3], valid, 0, 0),
            lambda: cf.batch_step_ring_plain(mp, H1080, W1080, raw[t:],
                                             *ms[:3], flags, ms[3], valid, 0,
                                             0), B),
        "absdiff_step_ring_stacked": (
            lambda: cf.absdiff_step_ring_stacked(
                rp, H1080, W1080, s, sraw[t:], *srs[:2], sflags, srs[2],
                svalid, zs),
            lambda: cf.absdiff_step_ring_stacked_plain(
                rp, H1080, W1080, s, sraw[t:], *srs[:2], sflags, srs[2],
                svalid, zs), s * B),
        "batch_step_ring_stacked": (
            lambda: cf.batch_step_ring_stacked(
                mp, H1080, W1080, s, sraw[t:], *sms[:3], sflags, sms[3],
                svalid, zs, zs),
            lambda: cf.batch_step_ring_stacked_plain(
                mp, H1080, W1080, s, sraw[t:], *sms[:3], sflags, sms[3],
                svalid, zs, zs), s * B),
        "absdiff_step": (
            lambda: cf.absdiff_step(rp, H1080, W1080, raw, rs[1], flags,
                                    rs[2], valid),
            lambda: cf.absdiff_step_plain(rp, H1080, W1080, raw, rs[1],
                                          flags, rs[2], valid), B),
        "batch_step": (
            lambda: cf.batch_step(mp, H1080, W1080, raw, ms[2], flags,
                                  ms[3], valid),
            lambda: cf.batch_step_plain(mp, H1080, W1080, raw, ms[2], flags,
                                        ms[3], valid), B),
        "absdiff_step_stacked": (
            lambda: cf.absdiff_step_stacked(rp, H1080, W1080, s, sraw,
                                            srs[1], sflags, srs[2], svalid),
            lambda: cf.absdiff_step_stacked_plain(
                rp, H1080, W1080, s, sraw, srs[1], sflags, srs[2], svalid),
            s * B),
        "batch_step_stacked": (
            lambda: cf.batch_step_stacked(mp, H1080, W1080, s, sraw, sms[2],
                                          sflags, sms[3], svalid),
            lambda: cf.batch_step_stacked_plain(
                mp, H1080, W1080, s, sraw, sms[2], sflags, sms[3], svalid),
            s * B),
    }
    # the raw steps' other maps: THRESHOLD and STATS_ONLY, ring and tail,
    # s = 1 and s = 8 (their own keys; the record's rows are ABSDIFF's)
    for mode in (OutputMode.THRESHOLD, OutputMode.STATS_ONLY):
        op = DiPsProperties(output=mode)
        calls.update({
            f"absdiff_step_ring {mode.name}": (
                lambda p=op: cf.absdiff_step_ring(p, H1080, W1080, raw[t:],
                                                  *rs[:2], flags, rs[2],
                                                  valid, 0),
                lambda p=op: cf.absdiff_step_ring_plain(
                    p, H1080, W1080, raw[t:], *rs[:2], flags, rs[2], valid,
                    0), B, op),
            f"absdiff_step_ring_stacked {mode.name}": (
                lambda p=op: cf.absdiff_step_ring_stacked(
                    p, H1080, W1080, s, sraw[t:], *srs[:2], sflags, srs[2],
                    svalid, zs),
                lambda p=op: cf.absdiff_step_ring_stacked_plain(
                    p, H1080, W1080, s, sraw[t:], *srs[:2], sflags, srs[2],
                    svalid, zs), s * B, op),
            f"absdiff_step {mode.name}": (
                lambda p=op: cf.absdiff_step(p, H1080, W1080, raw, rs[1],
                                             flags, rs[2], valid),
                lambda p=op: cf.absdiff_step_plain(p, H1080, W1080, raw,
                                                   rs[1], flags, rs[2],
                                                   valid), B, op),
            f"absdiff_step_stacked {mode.name}": (
                lambda p=op: cf.absdiff_step_stacked(p, H1080, W1080, s,
                                                     sraw, srs[1], sflags,
                                                     srs[2], svalid),
                lambda p=op: cf.absdiff_step_stacked_plain(
                    p, H1080, W1080, s, sraw, srs[1], sflags, srs[2],
                    svalid), s * B, op)})
    times = {}
    for key, (k, p, frames, *op) in calls.items():
        name = key.split()[0]
        props = op[0] if op else rp if name.startswith("absdiff") else mp
        times[key] = time_wrapper(key, k, p, frames, props, name, hp, wp,
                                  card)
    del raw, sraw, rs, ms, srs, sms, calls

    # the engines end to end, ring and tail protocol in turns: host frames
    # in, host maps out
    frames = moving_square_frames(2 * B, H1080, W1080, 41)
    for label, props in (("COLORIZE w3/T4", mp), ("ABSDIFF", rp)):
        for ring in (True, False):
            key = ("engine " if ring else "tail engine ") + label
            times[key] = engine_fps(
                DiPsEngine(props, H1080, W1080, batch=B, device="cuda",
                           ring_carry=ring),
                [frames[:B], frames[B:]], f"{key} 1080p B={B}", card)

    # the fleets end to end: 8 streams of host frames in, host maps out
    from dips_tpu_torch import MultiStreamEngine
    frame = FleetFrames(91)
    feeds = [[[frame(si, k) for k in range(j * B, (j + 1) * B)]
              for si in range(FLEET)] for j in range(2)]
    # ... and the ring fleets once more on the [grid] phase's (2, 3) grid
    runs = [(label, props, ring, None)
            for label, props in (("COLORIZE w3/T4", mp), ("ABSDIFF", rp))
            for ring in (True, False)]
    runs.append(("COLORIZE w3/T4", mp, True, one_card_mesh(*GRID)))
    for label, props, ring, mesh in runs:
        fleet = MultiStreamEngine(props, H1080, W1080, FLEET, batch=B,
                                  device="cuda", ring_carry=ring,
                                  mesh=mesh)
        fleet.process_batch(feeds[0])  # warm-up
        torch.cuda.synchronize()
        n_b = 4
        t0 = time.perf_counter()
        for i in range(n_b):
            fleet.process_batch(feeds[i % 2])
        wall = time.perf_counter() - t0
        fps = n_b * B * FLEET / wall
        key = ("fleet " if ring else "tail fleet ") + label + (
            f" on a {GRID} grid" if mesh is not None else "")
        times[key] = fps
        log(f"[time] {key} 1080p x {FLEET} streams B={B}: {fps:.1f} "
            f"frames/s aggregate end to end over {n_b * B * FLEET} "
            f"frames ({fps / FLEET:.1f} per stream); {card}")
        del fleet
    times.update(times_of_variants(card))
    times.update(times_of_slabs(card))
    times.update(times_of_options(card))
    return times


# ---------------------------------------------------------------------------
# the least time the card could take (for the record's bound_ms)
# ---------------------------------------------------------------------------

#: H100 SXM device memory rate (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
#: INT32 peak: 64 integer / compare / min / max results per clock per SM
#: (compute capability 9.0) x 132 SMs x 1.98 GHz boost clock
INT32_OPS_PER_S = 64 * 132 * 1.98e9


def units(ops):
    """min/max operations of a pruned network."""
    return sum(int(a) + int(b) for _, _, a, b in ops)


def spatial_ops(props):
    """min/max per pixel of the spatial filter: the exact median's column
    sort (one per pixel: ``networks.column_median_plan`` shares it among
    the w windows that hold the column) and merge plan; the separable
    median's two median networks of w; the quirk window's rank selection
    over (w-1)^2 taps (none at w <= 3, where the pick is the constant
    0)."""
    from dips_tpu_torch.ops import networks
    w = props.window_size
    if w == 1:
        return 0
    if props.quirk_compat:
        rank = w * w // 2 + 1 - 2 * w
        return (units(networks.selection_network((w - 1) ** 2, (rank,)))
                if rank >= 0 else 0)
    if props.approx_median:
        return 2 * units(networks.median_network(w))
    col, merge, _ = networks.column_median_plan(w)
    # each column sorted once per pixel, shared by the w windows holding it
    return 2 * len(col) + units(merge)


def bound(name, props, s, b, hp, wp, slabs=0):
    """(least ms per stream-frame, "bytes" or "operations") of one launch of
    kernel ``name`` over s streams of B frames (or of the launches that
    cover them: ``hp`` rows per stream in all, cut into ``slabs`` row slabs
    that each read two 8-row bands per filtered frame; 0: no bands): the
    larger of the bytes it
    must move (each input read once, each output written once) over the
    memory rate, and the integer operations it must do over the INT32 peak.
    Operations counted: raw -- 3 subtractions, 3 abs, 2 max and 1 compare
    per pixel and frame; median -- the intensity (5 min/max/add, or 1 for
    one channel) and the spatial filter's min/max (:func:`spatial_ops`) for
    every frame it filters, the temporal median network's for every frame
    it emits.  Emphasis, the quirk store-back and statistics are not
    counted, so this is a lower bound."""
    from dips_tpu_torch.ops import networks
    from dips_tpu_torch.properties import ChromaFilter, DiPsMethod
    px = s * hp * wp                  # pixels of one stacked plane
    t, c = props.temporal_size, props.out_channels
    overall = props.method == DiPsMethod.OVERALL
    tail = "ring" not in name
    if name.startswith("absdiff"):
        # frames read: the B new ones, plus tail frame T-1 in PER_FRAME;
        # the u8 reference state moves in and out unless the tail form
        # reads it from the tail (PER_FRAME)
        frames_in = b + (1 if tail and not overall else 0)
        ref_state = 0 if tail and not overall else 2 * 3 * px
        nbytes = 3 * px * frames_in + ref_state + 8 * px + c * b * px
        ops = 9 * px * b
    else:
        wmed = spatial_ops(props)
        tmed = units(networks.median_network(t))
        inten = 5 if props.chroma == ChromaFilter.ALL else 1
        filtered = b + (t if tail else 0)
        emitted = b + (1 if tail and not overall else 0)
        ops = px * (filtered * (inten + wmed) + emitted * tmed)
        # f32 state in and out: heatmap, baseline or prev (and the ring in
        # the ring form); the tail form writes no prev and no ring
        state = 4 * px * (2 + 2 + (2 * t if not tail else 0))
        if tail and not overall:
            state -= 4 * px  # the baseline passes through unread
        nbytes = 3 * px * filtered + state + c * b * px
        nbytes += 3 * filtered * s * slabs * 2 * 8 * wp  # the slab bands
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    least = max(by_bytes, by_ops)
    return least * 1e3 / (s * b), ("bytes" if by_bytes >= by_ops
                                   else "operations")


#: kernel -> (CUDA source, the Pallas kernel body it replaces)
KERNELS = {
    "absdiff_step_ring": ("dips_tpu_torch/csrc/raw_ring.cu",
                          "dips_tpu/ops/pallas_fused.py:1071"),
    "batch_step_ring": ("dips_tpu_torch/csrc/median_ring.cu",
                        "dips_tpu/ops/pallas_fused.py:799"),
    "absdiff_step_ring_stacked": ("dips_tpu_torch/csrc/raw_ring.cu",
                                  "dips_tpu/ops/pallas_fused.py:1071"),
    "batch_step_ring_stacked": ("dips_tpu_torch/csrc/median_ring.cu",
                                "dips_tpu/ops/pallas_fused.py:799"),
    "absdiff_step": ("dips_tpu_torch/csrc/raw_ring.cu",
                     "dips_tpu/ops/pallas_fused.py:1071"),
    "batch_step": ("dips_tpu_torch/csrc/median_tail.cu",
                   "dips_tpu/ops/pallas_fused.py:362"),
    "absdiff_step_stacked": ("dips_tpu_torch/csrc/raw_ring.cu",
                             "dips_tpu/ops/pallas_fused.py:1071"),
    "batch_step_stacked": ("dips_tpu_torch/csrc/median_tail.cu",
                           "dips_tpu/ops/pallas_fused.py:362"),
    # the k > 1 branch of the layout prep (plain jnp in the JAX package)
    "pool_prep": ("dips_tpu_torch/csrc/pool_prep.cu",
                  "dips_tpu/ops/reference.py:113"),
}
# the spatial-filter variants: instances of the same two kernels, replacing
# the approx / quirk branch of _filtered_plane
# the row-slab forms: the same kernels given a row window and, the median
# ones, band pointers; they replace the dyn_rows / slab_bands forms
for _name in SLAB_NAMES:
    _base = _name.split(":")[0]
    KERNELS[_name] = (KERNELS[_base][0], "dips_tpu/ops/pallas_fused.py:" + (
        "1073" if _base.startswith("absdiff") else
        "801" if "ring" in _base else "364"))
for _name in ("batch_step_ring", "batch_step_ring_stacked", "batch_step",
              "batch_step_stacked"):
    for _mode in ("approx_median", "quirk_compat"):
        KERNELS[f"{_name}:{_mode}"] = (KERNELS[_name][0],
                                       "dips_tpu/ops/pallas_fused.py:171")


def timed(fn, *args):
    """Run one phase and log its wall time."""
    t0 = time.perf_counter()
    res = fn(*args)
    log(f"[phase] {fn.__name__}: {time.perf_counter() - t0:.1f} s")
    return res


def main():
    if sys.argv[1:2] == ["--multihost-worker"]:  # a rank of [multihost]
        multihost_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return
    card = phase_card()
    regs = timed(phase_build)
    errs = timed(phase_kernels)
    launches = timed(phase_main_path, card)
    errs.update(timed(phase_kernels_stacked))
    launches.update(timed(phase_fleet, card))
    timed(phase_fleet_file, card)
    errs.update(timed(phase_kernels_tail))
    launches.update(timed(phase_tail, card))
    launches.update(timed(phase_fleet_tail, card))
    errs.update(timed(phase_kernels_variants))
    launches.update(timed(phase_options, card))
    pool = timed(phase_pool, card)
    errs.update(pool["errs"])
    launches.update(pool["launches"])
    errs.update(timed(phase_kernels_slabs))
    launches.update(timed(phase_grid, card))
    timed(phase_analysis, card)
    run = timed(phase_run, card)
    ingest = timed(phase_ingest, card)
    serve = timed(phase_serve, card)
    times = timed(phase_times, card)
    times.update(pool["times"])
    validate = timed(phase_validate, card)
    multihost = timed(phase_multihost, card)
    examples = timed(phase_examples, card)
    timed(phase_autotune, card)
    import torch
    # no single PyTorch call computes any of these steps: library_ms null
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name]["kernel"], "plain_ms": times[name]["plain"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"], "library_ms": None,
         "regs": regs.get(record_instance(name), (None,))[0],
         "run_launches": run.get(name, 0),
         "ingest_launches": ingest.get(name, 0),
         "serve_launches": serve.get(name, 0),
         "validate_launches": validate.get(name, 0),
         "multihost_launches": multihost.get(name, 0),
         "examples_launches": examples.get(name, 0)}
        for name, (src, rep) in KERNELS.items()]}
    for k in record["kernels"]:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} has no main-path launch")
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
