"""The on-card decimation (``downscale=k``: a 4K camera analysed at 1080p)
against its plain reference (``dips_tpu_torch/plainref.py``
``pool_frames``), on the CPU at a small size, and its kernel on the card.

* ``DiPsEngine`` and ``MultiStreamEngine`` with ``downscale`` 2 and 3, in
  the hwc and hwc_bgr layouts, on the ring-carry and the tail protocol:
  the maps, stats and heatmap against the oracle's pipeline
  (``ops/oracle.py``) run on ``plainref.pool_frames`` of the same frames,
  and the carried baseline (the pooled frame 0 through the filter, exact
  integers) equal to the reference's.
* ``plainref.pool_frames`` against ``reference.pool_frame_host`` and a
  2 x 2 block worked by hand, ties at .5 included.
* Faults planted in the engines' decimation fail the comparison: round
  half up, truncation, and the sum over the wrong axis.
* The pool step's counters count only while the stage timers are on; its
  stage is a ``dips.engine.pool`` span under ``torch.profiler``; the
  CLI's ``--profile`` prints them; ``plainref.py`` loads without the port.
* On the card (marked ``gpu``): ``cuda_fused.pool_prep``'s kernel bit-equal
  to the plain prep and to ``pool_frame_host`` at 4K and at odd
  geometries, k = 2, 3, 4, one stream and stacked, with the swap, into
  buffers with tail rows, the padding left as it was; the engine on the
  card through the kernel.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dips_tpu_torch import DiPsEngine, MultiStreamEngine, plainref
from dips_tpu_torch.io.synthetic import moving_square_clip, write_clip
from dips_tpu_torch.ops import cuda_fused, reference
from dips_tpu_torch.ops.oracle import DiPsOracle
from dips_tpu_torch.properties import DiPsProperties, OutputMode
from dips_tpu_torch.utils.profiling import POOL_STAGE, StageTimers

ROOT = Path(__file__).resolve().parents[1]
#: input geometry (k = 2: 36 x 48 analysed, k = 3: 24 x 32), batch, streams
H, W, B, S = 72, 96, 4, 2
#: the contract of the f32 emphasis path against the oracle: 1 LSB (an
#: expf rounding may flip a .5 tie); stats and heatmap to float32 sums in
#: another order
LSB, STATS_RTOL, HEAT_ATOL = 1, 1e-4, 1e-3


def _frames(n=10, seed=5):
    """Seeded input frames: a moving square over a noisy background, so
    every k x k block holds distinct values and some sums tie at .5."""
    rng = np.random.default_rng(seed)
    f = moving_square_clip(n, H, W, seed=seed, square=18).astype(np.int16)
    f += rng.integers(-9, 10, f.shape, dtype=np.int16)
    return np.clip(f, 0, 255).astype(np.uint8)


def _expected(frames, k, props, bgr=False):
    """(maps, stats, heatmap, baseline) of the reference: the pool, then
    the oracle's pipeline at the analysis size."""
    pooled = plainref.pool_frames(frames[..., ::-1] if bgr else frames, k)
    o = DiPsOracle(props)
    maps, stats = o.run(pooled)
    if maps.ndim == 3:
        maps = maps[..., None]
    base = o._baseline if o._raw_baseline is None else o._raw_baseline
    return maps, stats, o.heatmap, base


def _hwc(baseline, k):
    """A carried baseline as the oracle holds it: the raw modes' planar
    (3, Hp, Wp) frame as (H, W, 3), a median mode's plane cropped."""
    h, w = H // k, W // k
    if baseline.ndim == 3:
        return baseline[:, :h, :w].transpose(1, 2, 0)
    return baseline[:h, :w]


def _run_single(frames, k, props, layout, ring):
    eng = DiPsEngine(props, H, W, batch=B, device="cpu", input_layout=layout,
                     ring_carry=ring, downscale=k)
    maps, stats = eng.process_frames(list(frames))
    base = _hwc(eng.state_dict()["baseline"], k)
    return [(maps, stats, eng.heatmap(), base)]


def _run_fleet(streams, k, props, layout, ring):
    eng = MultiStreamEngine(props, H, W, S, batch=B, device="cpu",
                            input_layout=layout, ring_carry=ring,
                            downscale=k)
    n = len(streams[0])
    outs = [eng.process_batch([list(f[i:i + B]) for f in streams])
            for i in range(0, n, B)]
    maps = np.concatenate([o[0] for o in outs], axis=1)
    stats = np.concatenate([o[1] for o in outs], axis=1)
    heat = eng.heatmaps()
    base = eng.state_dict()["baseline"]
    return [(maps[si], stats[si], heat[si], _hwc(base[si], k))
            for si in range(S)]


def _misses(got, exp) -> list:
    """What of ``got`` (maps, stats, heatmap, baseline) is outside the
    contract with ``exp``; empty when it meets it."""
    maps, stats, heat, base = got
    emaps, estats, eheat, ebase = exp
    bad = []
    d = np.abs(maps.astype(np.int16) - emaps.astype(np.int16))
    if d.max() > LSB:
        bad.append(f"maps off by {d.max()}")
    if not np.allclose(stats[:, :3], estats[:, :3], rtol=STATS_RTOL,
                       atol=1e-5):
        bad.append("stats")
    if np.abs(stats[:, 3] - estats[:, 3]).max() > 0.01 * heat.size:
        bad.append("changed counts")
    if not np.allclose(heat, eheat, atol=HEAT_ATOL):
        bad.append("heatmap")
    if not np.array_equal(base, ebase):
        bad.append("baseline")
    return bad


def _run(engine, frames, k, props, layout, ring):
    """Every stream's result and reference (the fleet's second stream
    reads the frames reversed)."""
    bgr = layout == "hwc_bgr"
    if engine == "single":
        return zip(_run_single(frames, k, props, layout, ring),
                   [_expected(frames, k, props, bgr)])
    streams = [frames, frames[::-1].copy()]
    return zip(_run_fleet(streams, k, props, layout, ring),
               [_expected(f, k, props, bgr) for f in streams])


# -- both engines against the reference --------------------------------------

@pytest.mark.parametrize("ring", [True, False], ids=["ring", "tail"])
@pytest.mark.parametrize("layout", ["hwc", "hwc_bgr"])
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("engine", ["single", "fleet"])
def test_engine_meets_the_pooled_reference(engine, k, layout, ring):
    for got, exp in _run(engine, _frames(), k, DiPsProperties(), layout,
                         ring):
        assert got[0].shape == (10, H // k, W // k, 3)
        assert _misses(got, exp) == []


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("engine", ["single", "fleet"])
def test_absdiff_maps_are_the_pooled_frames_exactly(engine, k):
    """ABSDIFF is integer math on the pooled frames: its maps and changed
    counts equal the reference's bit for bit."""
    props = DiPsProperties(output=OutputMode.ABSDIFF)
    for got, exp in _run(engine, _frames(), k, props, "hwc", True):
        assert _misses(got, exp) == []
        np.testing.assert_array_equal(got[0], exp[0])
        np.testing.assert_array_equal(got[1][:, 3], exp[1][:, 3])


# -- the reference ------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 3, 4])
def test_plainref_pool_equals_the_host_twin(k):
    rng = np.random.default_rng(k)
    frames = rng.integers(0, 256, (3, 12 * k, 20 * k, 3), np.uint8)
    got = plainref.pool_frames(frames, k)
    exp = np.stack([reference.pool_frame_host(f, k) for f in frames])
    assert got.dtype == np.uint8 and got.shape == (3, 12, 20, 3)
    np.testing.assert_array_equal(got, exp)


def test_plainref_pool_by_hand():
    """One 2 x 2 block a channel: sums 100 (25), 1 (0.25 -> 0), 2 (0.5 ->
    0, half to even), 6 (1.5 -> 2), 10 (2.5 -> 2), 1018 (254.5 -> 254)."""
    f = np.zeros((1, 2, 12, 3), np.uint8)
    blocks = [([10, 20], [30, 40]), ([1, 0], [0, 0]), ([1, 1], [0, 0]),
              ([3, 3], [0, 0]), ([5, 5], [0, 0]), ([255, 255], [255, 253])]
    for j, (top, bottom) in enumerate(blocks):
        f[0, 0, 2 * j:2 * j + 2, j % 3] = top
        f[0, 1, 2 * j:2 * j + 2, j % 3] = bottom
    out = plainref.pool_frames(f, 2)[0, 0]
    got = [int(out[j, j % 3]) for j in range(6)]
    assert got == [25, 0, 0, 2, 2, 254]
    with pytest.raises(ValueError):
        plainref.pool_frames(f, 5)
    with pytest.raises(TypeError):
        plainref.pool_frames(f.astype(np.int16), 2)


def test_plainref_loads_without_the_port(tmp_path):
    """``plainref.py`` loaded by its path alone, in a fresh interpreter:
    no module of the port (or of JAX) is loaded, and the pool runs."""
    code = (
        "import importlib.util, sys\n"
        "import numpy as np\n"
        f"spec = importlib.util.spec_from_file_location('pr', "
        f"{str(ROOT / 'dips_tpu_torch' / 'plainref.py')!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "out = m.pool_frames(np.full((4, 6, 3), 7, np.uint8), 2)\n"
        "assert out.shape == (2, 3, 3) and (out == 7).all()\n"
        "bad = sorted({n.split('.')[0] for n in sys.modules}\n"
        "             & {'dips_tpu_torch', 'dips_tpu', 'jax'})\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=tmp_path,
                   timeout=120)


# -- planted faults fail the comparison ---------------------------------------

FAULTS = ("half_up", "truncate", "wrong_axis")


def _broken(fault):
    """The box mean with ``fault`` planted: rounding
    half up, truncating, or summing rows H apart in place of k adjacent
    rows (None: the sound recipe, written the same way)."""
    def prep(frames, out, k, swap_rb=False):
        x = frames.flip(-1) if swap_rb else frames
        lead = tuple(x.shape[:-3])
        h, w = x.shape[-3] // k, x.shape[-2] // k
        if fault == "wrong_axis":
            s = x.reshape(lead + (k, h, w, k, 3)).sum(dim=(-5, -2),
                                                      dtype=torch.int32)
        else:
            s = x.reshape(lead + (h, k, w, k, 3)).sum(dim=(-4, -2),
                                                      dtype=torch.int32)
        v = s.to(torch.float32) * float(np.float32(1.0 / (k * k)))
        v = {"half_up": lambda t: torch.floor(t + 0.5),
             "truncate": torch.floor}.get(fault, torch.round)(v)
        out[..., :h, :w] = v.to(torch.uint8).movedim(-1, -3)
        return out
    return prep


def _plant(monkeypatch, pool):
    """Engines made from here on take ``pool(frames, out, k, swap_rb)`` as
    their plain prep's box mean (the engines' decimation on the CPU)."""
    real = reference.make_layout_prep

    def make(layout, height, width, hp, wp, downscale=1):
        swap, prep = real(layout, height, width, hp, wp, downscale=downscale)
        if downscale == 1:
            return swap, prep
        return swap, lambda x, out: pool(x, out, downscale, swap)

    monkeypatch.setattr(reference, "make_layout_prep", make)


@pytest.mark.parametrize("engine", ["single", "fleet"])
@pytest.mark.parametrize("fault", (None,) + FAULTS)
def test_a_broken_pool_fails(monkeypatch, engine, fault):
    _plant(monkeypatch, _broken(fault))
    misses = [_misses(got, exp) for got, exp in
              _run(engine, _frames(), 2, DiPsProperties(), "hwc", True)]
    if fault is None:
        assert misses == [[]] * len(misses)
    else:
        assert all(misses), misses
        assert all("baseline" in m for m in misses), misses


# -- counters and span --------------------------------------------------------

def test_the_counters_count_while_the_timers_are_on():
    eng = DiPsEngine(DiPsProperties(), H, W, batch=B, device="cpu",
                     downscale=2)
    frames = _frames()
    eng.process_batch(list(frames[:B]))  # timers off: nothing counted
    assert eng.pool_counts.as_dict() == {
        "batches": 0, "frames": 0, "planes": 0, "device_ms": 0.0}
    eng.timers = StageTimers()
    eng.process_batch(list(frames[B:2 * B]))
    eng.process_batch(list(frames[2 * B:2 * B + 2]))
    c = eng.pool_counts
    assert (c.batches, c.frames, c.planes) == (2, B + 2, 3 * (B + 2))
    assert c.device_ms == 0.0  # no card: no device time
    assert eng.timers.counts[POOL_STAGE] == 2
    assert "pool: 2 batches, 6 frames, 18 planes" in str(c)
    eng.timers = None
    eng.process_batch(list(frames[:B]))
    assert eng.pool_counts.batches == 2


def test_the_fleet_counts_its_rows():
    eng = MultiStreamEngine(DiPsProperties(), H, W, S, batch=B,
                            device="cpu", downscale=2)
    eng.timers = StageTimers()
    eng.process_batch([list(_frames()[:B]), list(_frames()[:3])])
    c = eng.pool_counts
    assert (c.batches, c.frames, c.planes) == (1, S * B, 3 * S * B)
    assert eng.timers.counts[POOL_STAGE] == 1


@pytest.mark.parametrize("engine", ["single", "fleet"])
def test_an_engine_without_downscale_has_no_pool_stage(engine):
    if engine == "single":
        eng = DiPsEngine(DiPsProperties(), H, W, batch=B, device="cpu")
        feed = list(_frames()[:B])
    else:
        eng = MultiStreamEngine(DiPsProperties(), H, W, S, batch=B,
                                device="cpu")
        feed = [list(_frames()[:B])] * S
    eng.timers = StageTimers()
    eng.process_batch(feed)
    assert POOL_STAGE not in eng.timers.counts
    assert eng.pool_counts.batches == 0


@pytest.mark.parametrize("k", [1, 2])
def test_the_pool_stage_is_a_span_under_the_profiler(k):
    from torch.profiler import ProfilerActivity, profile
    eng = DiPsEngine(DiPsProperties(), H, W, batch=B, device="cpu",
                     downscale=k)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.process_batch(list(_frames()[:B]))
    names = [e.name for e in prof.events()]
    assert names.count("dips.engine.pool") == (k > 1)
    assert names.count("dips.engine.dispatch") == 1


def test_cli_profile_prints_the_pool_counters(tmp_path, capsys):
    from dips_tpu_torch import cli
    src = write_clip(_frames(8), str(tmp_path / "in.avi"))
    rc = cli.main(["--input", src, "--output", str(tmp_path / "o.avi"),
                   "--batch", str(B), "--downscale", "2", "--profile",
                   "--device", "cpu"])
    assert rc == 0
    assert "pool: 2 batches, 8 frames, 24 planes" in capsys.readouterr().out


def test_pool_prep_refuses_what_the_kernel_does_not_take():
    frames = torch.zeros((2, 8, 12, 3), dtype=torch.uint8)
    out = torch.zeros((2, 3, 8, 128), dtype=torch.uint8)
    with pytest.raises(ValueError, match="k = 1"):
        cuda_fused.pool_prep(frames, out, 1)
    with pytest.raises(ValueError, match="divide"):
        cuda_fused.pool_prep(frames, out, 3)
    with pytest.raises(ValueError, match="leading"):
        cuda_fused.pool_prep(frames, out[:1], 2)
    with pytest.raises(TypeError):
        cuda_fused.pool_prep(frames.to(torch.int16), out, 2)
    before = cuda_fused.pool_prep.launches
    cuda_fused.pool_prep(frames, out, 2)  # CPU tensors: the plain twin
    assert cuda_fused.pool_prep.launches == before


def test_launch_counts_hold_the_pool():
    cuda_fused.reset_launch_counts()
    assert cuda_fused.launch_counts()["pool_prep"] == 0
    cuda_fused.pool_prep.launches = 3
    assert cuda_fused.launch_counts()["pool_prep"] == 3
    cuda_fused.reset_launch_counts()
    assert cuda_fused.pool_prep.launches == 0
    assert not any(cuda_fused.launch_counts().values())


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


#: (input height, width, k): 4K at k = 2, and odd geometries (rows and
#: columns whose runs do not fall on 16-byte boundaries, a last column
#: tile that is partial)
GEOMETRIES = [(2160, 3840, 2), (2 * 37, 2 * 53, 2), (3 * 41, 3 * 77, 3),
              (4 * 29, 4 * 131, 4), (3 * 8, 3 * 700, 3)]


def _sentinel_rows(lead, h, w, tail=0, device="cuda"):
    """Planar rows (lead..., 3, Hp, Wp) filled with 0x5A, and, with
    ``tail``, the (tail + n)-row buffer they are the last n rows of."""
    hp, wp = reference.pad_geometry(h, w)
    if tail:
        buf = torch.full((tail + lead[0], 3, hp, wp), 0x5A,
                         dtype=torch.uint8, device=device)
        return buf[tail:], buf
    buf = torch.full(lead + (3, hp, wp), 0x5A, dtype=torch.uint8,
                     device=device)
    return buf, buf


@pytest.mark.gpu
@pytest.mark.parametrize("swap", [False, True], ids=["hwc", "hwc_bgr"])
@pytest.mark.parametrize("hk,wk,k", GEOMETRIES)
def test_kernel_equals_the_plain_prep(cuda, hk, wk, k, swap):
    n = 16 if hk == 2160 else 5
    rng = np.random.default_rng(hk + wk + k)
    frames = rng.integers(0, 256, (n, hk, wk, 3), np.uint8)
    h, w = hk // k, wk // k
    got, _ = _sentinel_rows((n,), h, w)
    exp, _ = _sentinel_rows((n,), h, w, device="cpu")
    before = cuda_fused.pool_prep.launches
    cuda_fused.pool_prep(torch.from_numpy(frames).to(cuda), got, k, swap)
    torch.cuda.synchronize()
    assert cuda_fused.pool_prep.launches == before + 1
    cuda_fused.pool_prep_plain(torch.from_numpy(frames), exp, k, swap)
    got = got.cpu()
    assert torch.equal(got, exp)  # the padding too: still 0x5A
    host = np.stack([reference.pool_frame_host(f, k) for f in frames])
    if swap:
        host = host[..., ::-1]
    np.testing.assert_array_equal(
        got[:, :, :h, :w].numpy(), host.transpose(0, 3, 1, 2))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 3, 4])
def test_kernel_stacked_and_into_tail_rows(cuda, k):
    """The fleet's (S, F) frames into its (F, 3, S*Hp, Wp) input seen as
    (S, F, 3, Hp, Wp), and one stream's frames into the last rows of a
    (T + n)-row buffer: the tail rows and the padding untouched."""
    s, f, t = 3, 4, 4
    h, w = 45, 67
    hp, wp = reference.pad_geometry(h, w)
    rng = np.random.default_rng(k)
    frames = rng.integers(0, 256, (s, f, h * k, w * k, 3), np.uint8)
    raw = torch.full((f, 3, s * hp, wp), 0x5A, dtype=torch.uint8,
                     device=cuda)
    view = raw.view(f, 3, s, hp, wp).permute(2, 0, 1, 3, 4)
    cuda_fused.pool_prep(torch.from_numpy(frames).to(cuda), view, k, True)
    exp = torch.full((f, 3, s * hp, wp), 0x5A, dtype=torch.uint8)
    cuda_fused.pool_prep_plain(
        torch.from_numpy(frames),
        exp.view(f, 3, s, hp, wp).permute(2, 0, 1, 3, 4), k, True)
    assert torch.equal(raw.cpu(), exp)
    rows, buf = _sentinel_rows((f,), h, w, tail=t)
    cuda_fused.pool_prep(torch.from_numpy(frames[1]).to(cuda), rows, k)
    exp_rows, exp_buf = _sentinel_rows((f,), h, w, tail=t, device="cpu")
    cuda_fused.pool_prep_plain(torch.from_numpy(frames[1]), exp_rows, k)
    assert torch.equal(buf.cpu(), exp_buf)


@pytest.mark.gpu
def test_the_engine_loads_the_kernel_when_it_is_made(cuda, monkeypatch):
    """The pool's library is built or loaded by a downscaled engine's
    constructor, so no batch (and no counted step) waits for it; an
    engine without downscale loads none."""
    from dips_tpu_torch.ops import _build
    key = (_build.DEFAULT, (_build.POOL_UNIT,))
    monkeypatch.setattr(_build, "_libs", {})
    DiPsEngine(DiPsProperties(), H, W, batch=B, device="cuda")
    assert key not in _build._libs
    DiPsEngine(DiPsProperties(), H, W, batch=B, device="cuda", downscale=2)
    assert key in _build._libs


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["single", "fleet"])
def test_engine_on_the_card_pools_through_the_kernel(cuda, engine):
    """The engines on the card launch the kernel, count its device time,
    and carry the same baseline as on the CPU; their maps are the CPU
    engine's within the emphasis path's 1 LSB."""
    frames = _frames()
    cuda_fused.reset_launch_counts()
    runs = {}
    for dev in ("cpu", "cuda"):
        if engine == "single":
            eng = DiPsEngine(DiPsProperties(), H, W, batch=B, device=dev,
                             downscale=2)
            feed = [list(frames[i:i + B]) for i in range(0, 10, B)]
        else:
            eng = MultiStreamEngine(DiPsProperties(), H, W, S, batch=B,
                                    device=dev, downscale=2)
            feed = [[list(frames[i:i + B])] * S for i in range(0, 10, B)]
        eng.timers = StageTimers()
        outs = [eng.process_batch(x)[0] for x in feed]
        runs[dev] = (outs, eng.state_dict()["baseline"], eng.pool_counts)
    assert cuda_fused.launch_counts()["pool_prep"] == 3
    np.testing.assert_array_equal(runs["cuda"][1], runs["cpu"][1])
    for a, b in zip(runs["cuda"][0], runs["cpu"][0]):
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= LSB
    c = runs["cuda"][2]
    assert c.batches == 3 and 0 < c.device_ms < 100
