#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one card and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA card (sm_90a,
nvcc under CUDA_HOME or /usr/local/cuda).  It builds the port's CUDA
kernels from ``dips_tpu_torch/csrc``, holds each kernel against its plain
PyTorch twin at the main path's shapes, runs ``dips_tpu_torch.DiPsEngine``
end to end at 1080p (COLORIZE and ABSDIFF, refresh marker, snapshot,
checkpoint resume), runs ``run_dips_on_file`` on a 1080p clip when cv2 is
present, and times kernels, plain twins and the engine with CUDA events.

Phases print on their own lines; any failed check raises, so the exit code
is non-zero and no result is printed.  The line before the last holds the
kernels' record as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a card, or without the
repository around it, it exits non-zero before printing any result.
"""

import json
import os
import subprocess
import time

import numpy as np

H1080, W1080 = 1080, 1920
B = 16
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


def phase_build():
    from dips_tpu_torch.ops import _build
    _build.build(force=True)
    info = dict(_build.build_info)
    _build.lib()
    log(f"[build] {info['seconds']:.2f} s into {info['dir']}")
    kernel = None
    for line in str(info["ptxas"]).splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif kernel and ("registers" in line or "spill" in line):
            log(f"[build] {kernel}: {line.split(' : ')[-1].strip()}")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain twin at the main path's shapes
# ---------------------------------------------------------------------------

def _max_err(a, b):
    import torch
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def _check_stats(tag, got, exp, rtol):
    """Counts and maxima exact; the two sums within rtol of their own
    magnitude, or of the mean |diff| (which bounds the rounding error of a
    sum that cancels)."""
    g, e = got.cpu().numpy().astype(np.float64), \
        exp.cpu().numpy().astype(np.float64)
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
           f"w{props.window_size}/T{t} {props.filter.name}")
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
    launches = cuda_fused.launch_counts()
    log(f"[main] launches during the engine runs: {launches}")
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
# phase 5: times on this card
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


def phase_times(card):
    import torch
    from dips_tpu_torch import DiPsEngine, DiPsProperties, OutputMode
    from dips_tpu_torch.ops import cuda_fused
    from dips_tpu_torch.ops.reference import pad_geometry
    dev = torch.device("cuda")
    hp, wp = pad_geometry(H1080, W1080)
    raw = planar(moving_square_frames(B, H1080, W1080, 31), hp, wp).to(dev)
    flags = torch.zeros(B, dtype=torch.bool, device=dev)
    flags[0] = True
    valid = torch.ones(B, dtype=torch.bool, device=dev)
    times = {}

    rp = DiPsProperties(output=OutputMode.ABSDIFF)
    rs = [torch.zeros((3, hp, wp), dtype=torch.uint8, device=dev)
          for _ in range(2)] + [torch.zeros((hp, wp), device=dev)]

    def raw_k():
        cuda_fused.absdiff_step_ring(rp, H1080, W1080, raw, rs[0], rs[1],
                                     flags, rs[2], valid, 0)

    def raw_p():
        cuda_fused.absdiff_step_ring_plain(rp, H1080, W1080, raw, rs[0],
                                           rs[1], flags, rs[2], valid, 0)

    mp = DiPsProperties()
    ms = [torch.zeros((4, hp, wp), device=dev)] + [
        torch.zeros((hp, wp), device=dev) for _ in range(3)]

    def med_k():
        cuda_fused.batch_step_ring(mp, H1080, W1080, raw, *ms[:3], flags,
                                   ms[3], valid, 0, 0)

    def med_p():
        cuda_fused.batch_step_ring_plain(mp, H1080, W1080, raw, *ms[:3],
                                         flags, ms[3], valid, 0, 0)

    for name, k, p in (("absdiff_step_ring", raw_k, raw_p),
                       ("batch_step_ring", med_k, med_p)):
        seq = [("plain", p), ("kernel", k), ("kernel", k), ("plain", p)]
        got = {"plain": [], "kernel": []}
        for which, fn in seq:  # plain, kernel, kernel, plain
            got[which].append(_time(fn, 20 if which == "kernel" else 3) / B)
        times[name] = {w: float(np.mean(v)) for w, v in got.items()}
        log(f"[time] {name} 1080p B={B}: kernel "
            f"{times[name]['kernel']:.4f} ms/frame ({got['kernel']}), plain "
            f"{times[name]['plain']:.4f} ms/frame ({got['plain']}); {card}")

    # the engine end to end: host frames in, host maps out
    frames = moving_square_frames(2 * B, H1080, W1080, 41)
    for label, props in (("COLORIZE w3/T4", DiPsProperties()),
                         ("ABSDIFF", DiPsProperties(
                             output=OutputMode.ABSDIFF))):
        eng = DiPsEngine(props, H1080, W1080, batch=B, device="cuda")
        batches = [list(frames[:B]), list(frames[B:])]
        eng.process_batch(batches[0])  # warm-up
        torch.cuda.synchronize()
        n_b = 12
        t_disp = t_coll = 0.0
        t0 = time.perf_counter()
        for i in range(n_b):
            buf = eng.new_batch_buffer()
            a = time.perf_counter()
            for j, f in enumerate(batches[i % 2]):
                buf[j] = f
            h = eng.dispatch_async(buf, B)
            c = time.perf_counter()
            eng.collect(h)
            d = time.perf_counter()
            t_disp += c - a
            t_coll += d - c
        wall = time.perf_counter() - t0
        fps = n_b * B / wall
        times[f"engine {label}"] = fps
        log(f"[time] engine {label} 1080p B={B}: {fps:.1f} frames/s end to "
            f"end over {n_b * B} frames (host fill+upload+launch "
            f"{1e3 * t_disp / (n_b * B):.3f} ms/frame, sync+download "
            f"{1e3 * t_coll / (n_b * B):.3f} ms/frame); {card}")
    return times


def main():
    card = phase_card()
    phase_build()
    errs = phase_kernels()
    launches = phase_main_path(card)
    times = phase_times(card)
    import torch
    record = {"kernels": [
        {"name": "absdiff_step_ring", "route": "cuda",
         "source": "dips_tpu_torch/csrc/raw_ring.cu",
         "replaces": "dips_tpu/ops/pallas_fused.py:1071",
         "launches": launches["absdiff_step_ring"],
         "max_abs_err": errs["absdiff_step_ring"],
         "ms": times["absdiff_step_ring"]["kernel"],
         "plain_ms": times["absdiff_step_ring"]["plain"]},
        {"name": "batch_step_ring", "route": "cuda",
         "source": "dips_tpu_torch/csrc/median_ring.cu",
         "replaces": "dips_tpu/ops/pallas_fused.py:799",
         "launches": launches["batch_step_ring"],
         "max_abs_err": errs["batch_step_ring"],
         "ms": times["batch_step_ring"]["kernel"],
         "plain_ms": times["batch_step_ring"]["plain"]},
    ]}
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
