"""The port's CUDA kernels against their plain PyTorch twins, on the card
(ring-carry and tail protocol, one stream and stacked, full height and
row slabs), and the fleet on a grid against the fleet without a mesh.

Marked ``gpu``: each test asks the ``cuda`` fixture for a card and skips
when there is none (decided inside the fixture, never at import, so every
pytest worker collects the same tests).  Run on a machine with a card:

    python -m pytest -m gpu tests/test_torch_cuda.py

Tolerances: integer maps and u8 state exact; emphasis maps within 1 LSB
with at most 1e-4 of the pixels differing (expf/logf may round a tie the
other way); carried ring / prev / baseline exact on the true region; the
heatmap within 1e-6; stats within rtol 1e-5 (the sums are taken over tiles
in another order), changed counts and maxima exact.
"""

import numpy as np
import pytest
import torch

from dips_tpu_torch.ops import cuda_fused
from dips_tpu_torch.ops.reference import pad_geometry
from dips_tpu_torch.properties import (ChromaFilter, DiPsFilter, DiPsMethod,
                                       DiPsProperties, OutputMode)

pytestmark = pytest.mark.gpu

H, W = 60, 200


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def make_raw(b, h, w, seed):
    """Seeded (B, 3, Hp, Wp) planar frames: a moving square over noise,
    zero padding."""
    hp, wp = pad_geometry(h, w)
    rng = np.random.default_rng(seed)
    bg = rng.integers(0, 256, (3, h, w), np.uint8)
    raw = np.zeros((b, 3, hp, wp), np.uint8)
    for i in range(b):
        f = bg.copy()
        y, x = (2 + 3 * i) % (h - 8), (5 + 7 * i) % (w - 8)
        f[:, y:y + 8, x:x + 8] = np.array([250, 30, 30], np.uint8)[:, None,
                                                                   None]
        raw[i, :, :h, :w] = f
    return raw


def _state(props, hp, wp, raw_mode, device):
    t = props.temporal_size
    if raw_mode:
        return [torch.zeros((3, hp, wp), dtype=torch.uint8, device=device)
                for _ in range(2)] + [torch.zeros((hp, wp), device=device)]
    return [torch.zeros((t, hp, wp), device=device)] + [
        torch.zeros((hp, wp), device=device) for _ in range(3)]


def _assert_stats(got, exp):
    got, exp = got.cpu().numpy(), exp.cpu().numpy()
    np.testing.assert_array_equal(got[:, 2:], exp[:, 2:])
    np.testing.assert_allclose(got[:, :2], exp[:, :2], rtol=1e-5, atol=1e-7)


def _assert_maps(got, exp, exact, h, w):
    g = got[..., :h, :w].cpu().numpy().astype(np.int16)
    e = exp[..., :h, :w].cpu().numpy().astype(np.int16)
    if exact:
        np.testing.assert_array_equal(g, e)
        return
    d = np.abs(g - e)
    assert d.max(initial=0) <= 1
    assert (d > 0).sum() <= 1e-4 * d.size


RAW_CASES = [
    DiPsProperties(output=OutputMode.ABSDIFF),
    DiPsProperties(method=DiPsMethod.PER_FRAME, output=OutputMode.ABSDIFF),
    DiPsProperties(method=DiPsMethod.PER_FRAME, output=OutputMode.THRESHOLD,
                   change_threshold=20, roi=(4, 10, 50, 150)),
    DiPsProperties(output=OutputMode.STATS_ONLY, refresh_markers=(3,)),
]


@pytest.mark.parametrize("props", RAW_CASES)
def test_raw_kernel_matches_plain(cuda, props):
    hp, wp = pad_geometry(H, W)
    raw = torch.from_numpy(make_raw(12, H, W, 1)).to(cuda)
    states = [_state(props, hp, wp, True, cuda) for _ in range(2)]
    batches = [(raw[:6], [1, 0, 0, 1, 0, 0], [1] * 6, 1),
               (raw[6:], [0, 0, 1, 0, 0, 0], [1] * 4 + [0] * 2, 0)]
    for x, flags, valid, seed in batches:
        res = []
        for fn, (prev, base, heat) in zip(
                (cuda_fused.absdiff_step_ring,
                 cuda_fused.absdiff_step_ring_plain), states):
            res.append(fn(props, H, W, x, prev, base,
                          torch.tensor(flags, dtype=torch.bool, device=cuda),
                          heat, torch.tensor(valid, dtype=torch.bool,
                                             device=cuda), seed))
        got, exp = res
        torch.cuda.synchronize()
        _assert_maps(got[0], exp[0], True, hp, wp)
        _assert_stats(got[1], exp[1])
        for g, e in zip(got[2:4], exp[2:4]):
            assert torch.equal(g, e)
        torch.testing.assert_close(got[4], exp[4], rtol=0, atol=1e-6)


MEDIAN_CASES = [
    DiPsProperties(),
    DiPsProperties(method=DiPsMethod.PER_FRAME, output=OutputMode.GRAYSCALE,
                   filter=DiPsFilter.INVERSE_SIGMOID, window_size=5,
                   temporal_size=3),
    DiPsProperties(window_size=7, temporal_size=16, chroma=ChromaFilter.GREEN,
                   refresh_markers=(4,)),
    DiPsProperties(window_size=1, temporal_size=1, filter=DiPsFilter.UNFILTERED,
                   chroma=ChromaFilter.BLUE),
    DiPsProperties(roi=(5, 7, 40, 120), temporal_size=2, emit_maps=False),
    DiPsProperties(method=DiPsMethod.PER_FRAME, chroma=ChromaFilter.RED,
                   roi=(0, 0, 30, 64)),
]


@pytest.mark.parametrize("props", MEDIAN_CASES)
def test_median_kernel_matches_plain(cuda, props):
    hp, wp = pad_geometry(H, W)
    raw = torch.from_numpy(make_raw(12, H, W, 2)).to(cuda)
    states = [_state(props, hp, wp, False, cuda) for _ in range(2)]
    batches = [(raw[:6], [1, 0, 0, 0, 1, 0], [1] * 6, 0, 1),
               (raw[6:], [0, 1, 0, 0, 0, 0], [1] * 4 + [0] * 2, 6, 0)]
    t = props.temporal_size
    for x, flags, valid, off, seed in batches:
        res = []
        for fn, (ring, prev, base, heat) in zip(
                (cuda_fused.batch_step_ring, cuda_fused.batch_step_ring_plain),
                states):
            res.append(fn(props, H, W, x, ring, prev, base,
                          torch.tensor(flags, dtype=torch.bool, device=cuda),
                          heat, torch.tensor(valid, dtype=torch.bool,
                                             device=cuda), off % t, seed))
        got, exp = res
        torch.cuda.synchronize()
        _assert_maps(got[0], exp[0], False, H, W)
        _assert_stats(got[1], exp[1])
        for g, e in zip(got[2:5], exp[2:5]):
            assert torch.equal(g[..., :H, :W], e[..., :H, :W])
        torch.testing.assert_close(got[5], exp[5], rtol=0, atol=1e-6)


def test_engine_cuda_matches_cpu(cuda):
    from dips_tpu_torch import DiPsEngine
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (11, H, W, 3), np.uint8)
    frames[:, 10:20, 30:40] = 255
    for props in (DiPsProperties(refresh_markers=(5,)),
                  DiPsProperties(method=DiPsMethod.PER_FRAME,
                                 output=OutputMode.ABSDIFF)):
        outs = []
        for dev in ("cuda", "cpu"):
            eng = DiPsEngine(props, H, W, batch=4, device=dev)
            outs.append(eng.process_frames(list(frames)) + (eng.heatmap(),))
        (go, gs, gh), (eo, es, eh) = outs
        d = np.abs(go.astype(np.int16) - eo.astype(np.int16))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-4
        np.testing.assert_allclose(gs, es, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(gh, eh, atol=1e-5)


def test_unsupported_modes_raise_on_cuda(cuda):
    """The spatial modes launch their kernel instance on the card (no
    plain fallback); a float frame still raises."""
    hp, wp = pad_geometry(H, W)
    raw = torch.zeros((2, 3, hp, wp), dtype=torch.uint8, device=cuda)
    props = DiPsProperties(approx_median=True)
    ring, prev, base, heat = _state(props, hp, wp, False, cuda)
    flags = torch.zeros(2, dtype=torch.bool, device=cuda)
    cuda_fused.reset_launch_counts()
    cuda_fused.batch_step_ring(props, H, W, raw, ring, prev, base, flags,
                               heat, flags, 0, 1)
    torch.cuda.synchronize()
    assert cuda_fused.launch_counts()["batch_step_ring:approx_median"] == 1
    with pytest.raises(TypeError):  # a float frame is not a u8 frame
        cuda_fused.batch_step_ring(DiPsProperties(), H, W, raw.float(), ring,
                                   prev, base, flags, heat, flags, 0, 1)


# ---------------------------------------------------------------------------
# stacked streams: S streams along the rows of one launch
# ---------------------------------------------------------------------------

SH, SW, S = 64, 200, 3  # SH % 8 == 0: no padding rows between streams

STACKED_CASES = [
    DiPsProperties(output=OutputMode.ABSDIFF),
    DiPsProperties(method=DiPsMethod.PER_FRAME, output=OutputMode.THRESHOLD,
                   change_threshold=20, roi=(4, 10, 50, 150)),
    DiPsProperties(),
    DiPsProperties(method=DiPsMethod.PER_FRAME, output=OutputMode.GRAYSCALE,
                   filter=DiPsFilter.INVERSE_SIGMOID, window_size=7,
                   temporal_size=3, roi=(2, 5, 60, 190)),
]


def make_stacked(b, seed):
    """(B, 3, S*Hp, Wp): a moving square over noise, then a black and a
    white stream, so a tap or mask that crosses a stream edge shows."""
    hp, wp = pad_geometry(SH, SW)
    raw = np.zeros((b, 3, S * hp, wp), np.uint8)
    raw[:, :, :hp] = make_raw(b, SH, SW, seed)
    raw[:, :, 2 * hp:2 * hp + SH, :SW] = 255
    for i in range(b):  # a gray bar moving through the black stream
        raw[i, :, hp + 30:hp + 34, 10 + 9 * i:18 + 9 * i] = 128
    return raw


def _stacked_state(props, hp, wp, device):
    t, rows = props.temporal_size, (S * hp, wp)
    if props.output in (OutputMode.ABSDIFF, OutputMode.THRESHOLD):
        return [torch.zeros((3,) + rows, dtype=torch.uint8, device=device)
                for _ in range(2)] + [torch.zeros(rows, device=device)]
    return [torch.zeros((t,) + rows, device=device)] + [
        torch.zeros(rows, device=device) for _ in range(3)]


def _run_stacked(fn, props, x, st, flags, valid, offs, seeds):
    if props.output in (OutputMode.ABSDIFF, OutputMode.THRESHOLD):
        return fn(props, SH, SW, S, x, st[0], st[1], flags, st[2], valid,
                  seeds)
    return fn(props, SH, SW, S, x, *st[:3], flags, st[3], valid, offs,
              seeds)


@pytest.mark.parametrize("props", STACKED_CASES)
def test_stacked_kernels_match_plain(cuda, props):
    hp, wp = pad_geometry(SH, SW)
    raw = torch.from_numpy(make_stacked(12, 4)).to(cuda)
    raw_mode = props.output in (OutputMode.ABSDIFF, OutputMode.THRESHOLD)
    kernel, plain = ((cuda_fused.absdiff_step_ring_stacked,
                      cuda_fused.absdiff_step_ring_stacked_plain) if raw_mode
                     else (cuda_fused.batch_step_ring_stacked,
                           cuda_fused.batch_step_ring_stacked_plain))
    states = [_stacked_state(props, hp, wp, cuda) for _ in range(2)]
    t = props.temporal_size
    dev = lambda a: torch.tensor(a, dtype=torch.bool, device=cuda)
    batches = [  # mixed seeds and offsets, stream 2 all-invalid first
        (raw[:6], [[1, 0, 0, 1, 0, 0], [0, 0, 1, 0, 0, 0], [1] * 6],
         [[1] * 6, [1] * 6, [0] * 6], [0, 1 % t, 2 % t], [1, 1, 0]),
        (raw[6:], [[0, 1, 0, 0, 0, 0], [0] * 6, [0, 0, 0, 1, 0, 0]],
         [[1] * 4 + [0] * 2, [1] * 6, [1] * 5 + [0]], [6 % t, 1, 2], [0, 0, 1]),
    ]
    launches = cuda_fused.launch_counts()
    for x, flags, valid, offs, seeds in batches:
        got = _run_stacked(kernel, props, x, states[0], dev(flags),
                           dev(valid), offs, seeds)
        exp = _run_stacked(plain, props, x, states[1], dev(flags),
                           dev(valid), offs, seeds)
        torch.cuda.synchronize()
        for si in range(S):
            r = slice(si * hp, si * hp + SH)
            _assert_maps(got[0][:, :, r], exp[0][:, :, r], raw_mode, SH, SW)
            _assert_stats(got[1][si], exp[1][si])
        for g, e in zip(got[2:-1], exp[2:-1]):
            g = g.view(g.shape[:-2] + (S, hp, wp))[..., :SH, :SW]
            e = e.view(e.shape[:-2] + (S, hp, wp))[..., :SH, :SW]
            assert torch.equal(g, e)
        torch.testing.assert_close(got[-1], exp[-1], rtol=0, atol=1e-6)
    name = kernel.__name__
    assert cuda_fused.launch_counts()[name] == launches[name] + 2


@pytest.mark.parametrize("props", [STACKED_CASES[1], STACKED_CASES[3]])
def test_stacked_kernel_equals_single_stream_kernel(cuda, props):
    """Each stream of one stacked launch equals the s = 1 kernel on that
    stream's rows alone: nothing crosses a stream edge."""
    hp, wp = pad_geometry(SH, SW)
    raw = torch.from_numpy(make_stacked(6, 5)).to(cuda)
    raw_mode = props.output in (OutputMode.ABSDIFF, OutputMode.THRESHOLD)
    flags = torch.zeros((S, 6), dtype=torch.bool, device=cuda)
    flags[:, 0] = True
    valid = torch.ones((S, 6), dtype=torch.bool, device=cuda)
    st = _stacked_state(props, hp, wp, cuda)
    stacked = (cuda_fused.absdiff_step_ring_stacked if raw_mode
               else cuda_fused.batch_step_ring_stacked)
    got = _run_stacked(stacked, props, raw, st, flags, valid, [0] * S,
                       [1] * S)
    for si in range(S):
        r = slice(si * hp, (si + 1) * hp)
        x = raw[:, :, r].contiguous()
        one = [torch.zeros_like(a[..., r, :]) for a in
               _stacked_state(props, hp, wp, cuda)]
        if raw_mode:
            exp = cuda_fused.absdiff_step_ring(props, SH, SW, x, one[0],
                                               one[1], flags[si], one[2],
                                               valid[si], 1)
        else:
            exp = cuda_fused.batch_step_ring(props, SH, SW, x, *one[:3],
                                             flags[si], one[3], valid[si],
                                             0, 1)
        torch.cuda.synchronize()
        assert torch.equal(got[0][:, :, r], exp[0])
        assert torch.equal(got[1][si], exp[1])
        for g, e in zip(got[2:], exp[2:]):
            assert torch.equal(g[..., r, :], e)


def test_fleet_engine_cuda_matches_cpu(cuda):
    from dips_tpu_torch import MultiStreamEngine
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (S, 9, H, W, 3), np.uint8)
    frames[:, :, 10:20, 30:40] = 255
    for props in (DiPsProperties(refresh_markers=(5,)),
                  DiPsProperties(method=DiPsMethod.PER_FRAME,
                                 output=OutputMode.ABSDIFF)):
        outs = []
        for dev in ("cuda", "cpu"):
            eng = MultiStreamEngine(props, H, W, S, batch=4, device=dev)
            res = [eng.process_batch([list(f[i:i + 4]) for f in frames])
                   for i in (0, 4, 8)]
            outs.append((np.concatenate([r[0] for r in res], axis=1),
                         np.concatenate([r[1] for r in res], axis=1),
                         eng.heatmaps()))
        (go, gs, gh), (eo, es, eh) = outs
        d = np.abs(go.astype(np.int16) - eo.astype(np.int16))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-4
        np.testing.assert_allclose(gs, es, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(gh, eh, atol=1e-5)


# ---------------------------------------------------------------------------
# the tail protocol: T tail frames ahead of the B new ones
# ---------------------------------------------------------------------------

TAIL_CASES = [
    DiPsProperties(output=OutputMode.ABSDIFF),
    DiPsProperties(method=DiPsMethod.PER_FRAME, output=OutputMode.ABSDIFF,
                   temporal_size=3),
    DiPsProperties(method=DiPsMethod.PER_FRAME, output=OutputMode.THRESHOLD,
                   change_threshold=20, roi=(4, 10, 50, 150)),
    DiPsProperties(),
    DiPsProperties(method=DiPsMethod.PER_FRAME, output=OutputMode.GRAYSCALE,
                   filter=DiPsFilter.INVERSE_SIGMOID, window_size=7,
                   temporal_size=16, roi=(2, 5, 60, 190)),
    DiPsProperties(window_size=5, temporal_size=9, emit_maps=False),
]


def _tail_pair(props):
    raw_mode = props.output in (OutputMode.ABSDIFF, OutputMode.THRESHOLD,
                                OutputMode.STATS_ONLY)
    if raw_mode:
        return (raw_mode, cuda_fused.absdiff_step,
                cuda_fused.absdiff_step_plain)
    return raw_mode, cuda_fused.batch_step, cuda_fused.batch_step_plain


@pytest.mark.parametrize("props", TAIL_CASES)
def test_tail_kernel_matches_plain(cuda, props):
    """Two batches of one stream; the second is partial, and its slot 4 is
    flagged but invalid (the tail kernels capture on it all the same)."""
    hp, wp = pad_geometry(H, W)
    t = props.temporal_size
    raw = torch.from_numpy(make_raw(t + 12, H, W, 7)).to(cuda)
    raw_mode, kernel, plain = _tail_pair(props)
    mk = lambda: ([torch.zeros((3, hp, wp), dtype=torch.uint8, device=cuda)]
                  if raw_mode else [torch.zeros((hp, wp), device=cuda)]) + [
        torch.zeros((hp, wp), device=cuda)]
    states = [mk(), mk()]
    dev = lambda a: torch.tensor(a, dtype=torch.bool, device=cuda)
    batches = [(raw[:t + 6], [1, 0, 0, 1, 0, 0], [1] * 6),
               (raw[6:t + 12], [0, 1, 0, 0, 1, 0], [1] * 4 + [0] * 2)]
    before = cuda_fused.launch_counts()[kernel.__name__]
    for x, flags, valid in batches:
        got, exp = (fn(props, H, W, x, st[0], dev(flags), st[1], dev(valid))
                    for fn, st in zip((kernel, plain), states))
        torch.cuda.synchronize()
        _assert_maps(got[0], exp[0], raw_mode, H, W)
        _assert_stats(got[1], exp[1])
        assert torch.equal(got[2][..., :H, :W], exp[2][..., :H, :W])
        torch.testing.assert_close(got[3], exp[3], rtol=0, atol=1e-6)
    assert cuda_fused.launch_counts()[kernel.__name__] == before + 2


@pytest.mark.parametrize("props", [TAIL_CASES[0], TAIL_CASES[2],
                                   TAIL_CASES[3], TAIL_CASES[4]])
def test_stacked_tail_kernels_match_plain(cuda, props):
    """S streams in one tail launch: stream 2 all-invalid in the first
    batch, a flagged invalid slot and a partial stream in the second."""
    hp, wp = pad_geometry(SH, SW)
    t = props.temporal_size
    raw = torch.from_numpy(make_stacked(t + 12, 8)).to(cuda)
    raw_mode = props.output in (OutputMode.ABSDIFF, OutputMode.THRESHOLD)
    kernel, plain = ((cuda_fused.absdiff_step_stacked,
                      cuda_fused.absdiff_step_stacked_plain) if raw_mode
                     else (cuda_fused.batch_step_stacked,
                           cuda_fused.batch_step_stacked_plain))
    rows = (S * hp, wp)
    mk = lambda: ([torch.zeros((3,) + rows, dtype=torch.uint8, device=cuda)]
                  if raw_mode else [torch.zeros(rows, device=cuda)]) + [
        torch.zeros(rows, device=cuda)]
    states = [mk(), mk()]
    dev = lambda a: torch.tensor(a, dtype=torch.bool, device=cuda)
    batches = [
        (raw[:t + 6], [[1, 0, 0, 1, 0, 0], [0, 0, 1, 0, 0, 0], [1] * 6],
         [[1] * 6, [1] * 6, [0] * 6]),
        (raw[6:t + 12], [[0, 1, 0, 0, 0, 1], [0] * 6, [0, 0, 0, 1, 0, 0]],
         [[1] * 4 + [0] * 2, [1] * 6, [1] * 5 + [0]]),
    ]
    for x, flags, valid in batches:
        got, exp = (fn(props, SH, SW, S, x, st[0], dev(flags), st[1],
                       dev(valid)) for fn, st in zip((kernel, plain), states))
        torch.cuda.synchronize()
        for si in range(S):
            r = slice(si * hp, si * hp + SH)
            _assert_maps(got[0][:, :, r], exp[0][:, :, r], raw_mode, SH, SW)
            _assert_stats(got[1][si], exp[1][si])
        g = got[2].view(got[2].shape[:-2] + (S, hp, wp))[..., :SH, :SW]
        e = exp[2].view(exp[2].shape[:-2] + (S, hp, wp))[..., :SH, :SW]
        assert torch.equal(g, e)
        torch.testing.assert_close(got[3], exp[3], rtol=0, atol=1e-6)


def test_tail_engines_equal_ring_engines_on_the_card(cuda):
    """The tail protocol and the ring protocol give the same maps and
    stats, single stream and fleet, with partial batches."""
    from dips_tpu_torch import DiPsEngine, MultiStreamEngine
    rng = np.random.default_rng(9)
    frames = rng.integers(0, 256, (S, 11, H, W, 3), np.uint8)
    frames[:, :, 10:20, 30:40] = 255
    for props in (DiPsProperties(refresh_markers=(5,)),
                  DiPsProperties(method=DiPsMethod.PER_FRAME,
                                 output=OutputMode.ABSDIFF)):
        res = []
        for ring in (True, False):
            eng = DiPsEngine(props, H, W, batch=4, device="cuda",
                             ring_carry=ring)
            fleet = MultiStreamEngine(props, H, W, S, batch=4,
                                      device="cuda", ring_carry=ring)
            one = [eng.process_batch(list(frames[0, i:i + n]))
                   for i, n in ((0, 4), (4, 3), (7, 4))]
            many = [fleet.process_batch([list(f[i:i + 4]) for f in frames])
                    for i in (0, 4, 8)]
            res.append((np.concatenate([o for o, _ in one]),
                        np.concatenate([s for _, s in one]),
                        np.concatenate([m[0] for m in many], axis=1),
                        np.concatenate([m[1] for m in many], axis=1)))
        for a, b in zip(*res):
            if a.dtype == np.uint8:
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the spatial-filter variants of both median kernels
# ---------------------------------------------------------------------------

VARIANT_CASES = [
    DiPsProperties(approx_median=True, window_size=3),
    DiPsProperties(approx_median=True, window_size=7, temporal_size=3,
                   method=DiPsMethod.PER_FRAME, output=OutputMode.GRAYSCALE),
    DiPsProperties(quirk_compat=True, window_size=1),
    DiPsProperties(quirk_compat=True, window_size=3,
                   filter=DiPsFilter.INVERSE_SIGMOID),
    DiPsProperties(quirk_compat=True, window_size=5, refresh_markers=(4,)),
    DiPsProperties(quirk_compat=True, window_size=7, temporal_size=5,
                   method=DiPsMethod.PER_FRAME, roi=(2, 5, 60, 190)),
]


@pytest.mark.parametrize("props", VARIANT_CASES)
def test_variant_kernels_match_plain(cuda, props):
    """Each variant through the four median wrappers (ring and tail, one
    stream and stacked) against the plain twins, with the checks and
    tolerances of the exact-median tests above; every launch counts under
    its spatial mode."""
    mode = cuda_fused.spatial_mode(props)
    cuda_fused.reset_launch_counts()
    test_median_kernel_matches_plain(cuda, props)
    test_stacked_kernels_match_plain(cuda, props)
    test_tail_kernel_matches_plain(cuda, props)
    test_stacked_tail_kernels_match_plain(cuda, props)
    counts = cuda_fused.launch_counts()
    for name in ("batch_step_ring", "batch_step_ring_stacked", "batch_step",
                 "batch_step_stacked"):
        assert counts[f"{name}:{mode}"] == counts[name] >= 2, name


# ---------------------------------------------------------------------------
# the row-slab forms (row_bounds / bands) and the grid on the card
# ---------------------------------------------------------------------------

SLAB_CASES = [
    (DiPsProperties(window_size=3, temporal_size=2, roi=(10, 20, 60, 180)),
     True, True),
    (DiPsProperties(window_size=5, temporal_size=3,
                    method=DiPsMethod.PER_FRAME), True, True),
    (DiPsProperties(window_size=7, temporal_size=2, approx_median=True),
     False, True),
    (DiPsProperties(window_size=5, temporal_size=2, quirk_compat=True),
     False, True),
    (DiPsProperties(window_size=7, temporal_size=2), True, False),
    (DiPsProperties(output=OutputMode.ABSDIFF, roi=(30, 20, 60, 180)), True,
     False),
    (DiPsProperties(output=OutputMode.THRESHOLD, method=DiPsMethod.PER_FRAME,
                    roi=(30, 20, 60, 180)), False, False),
]


@pytest.mark.parametrize("props,ring,bands", SLAB_CASES)
def test_slab_kernels_match_plain(cuda, props, ring, bands):
    """Two stacked streams of 64 x 200 cut into 4 slabs of 16 rows: every
    slab through the kernel with its row window (and its neighbours' bands)
    equals the plain twin, two carried batches; the raw cases' roi misses
    slab 0."""
    from dips_tpu_torch.parallel import grid2d, grid_mesh
    from dips_tpu_torch.parallel.mesh import Layout
    h, w, s, r_ax, b = 64, 200, 2, 4, 6
    hp, wp = pad_geometry(h, w)
    hs = hp // r_ax
    t = props.temporal_size
    raw_mode = props.output in (OutputMode.ABSDIFF, OutputMode.THRESHOLD)
    name = ("absdiff_step" if raw_mode else "batch_step") + (
        "_ring" if ring else "") + "_stacked"
    kernel, plain = getattr(cuda_fused, name), getattr(cuda_fused,
                                                       name + "_plain")
    lay = Layout(grid_mesh(1, r_ax, devices=[cuda] * r_ax), s, hp, wp)

    def state():
        plane = (s * hs, wp)
        if raw_mode:
            st = [torch.zeros((3,) + plane, dtype=torch.uint8, device=cuda)
                  for _ in range(2 if ring else 1)]
        else:
            st = ([torch.zeros((t,) + plane, device=cuda),
                   torch.zeros(plane, device=cuda)] if ring else []) + [
                torch.zeros(plane, device=cuda)]
        return st + [torch.zeros(plane, device=cuda)]

    states = [[state() for _ in range(r_ax)] for _ in range(2)]
    n_in = b + (0 if ring else t)
    frames = np.concatenate([make_raw(n_in + b, h, w, 3 + si)
                             for si in range(s)], axis=2)
    before = cuda_fused.launch_counts()
    for bi in range(2):
        x = torch.from_numpy(frames[bi * b:bi * b + n_in]).to(cuda)
        cells = lay.scatter(x)[0]
        exch = grid2d._band_exchange_u8(cells, s)
        flags = np.zeros((s, b), bool)
        flags[:, bi] = True
        valid = np.ones((s, b), bool)
        valid[1, b - 1] = bi == 0
        offs, seeds = [(bi * b + si) % t for si in range(s)], [1 - bi] * s
        for j in range(r_ax):
            if raw_mode:
                kw = dict(row_bounds=grid2d._raw_grid_bounds(props, h, w, hs,
                                                             j))
            else:
                kw = dict(row_bounds=grid2d._slab_row_bounds(props, h, w, hs,
                                                             j, ext=0))
                if bands:
                    kw["bands"] = exch[j]
            res = []
            for fn, st in zip((kernel, plain), states):
                st = st[j]
                if ring and raw_mode:
                    args = (st[0], st[1], flags, st[2], valid, seeds)
                elif ring:
                    args = (*st[:3], flags, st[3], valid, offs, seeds)
                else:
                    args = (st[0], flags, st[1], valid)
                res.append(fn(props, h, w, s, cells[j], *args, **kw))
            torch.cuda.synchronize()
            got, exp = res
            _assert_maps(got[0], exp[0], raw_mode, s * hs, w)
            for si in range(s):
                _assert_stats(got[1][si], exp[1][si])
            for g, e in zip(states[0][j][:-1], states[1][j][:-1]):
                assert torch.equal(g[..., :w], e[..., :w])
            assert float((states[0][j][-1] - states[1][j][-1]).abs().max()) \
                <= 1e-6
            lo, hi = kw["row_bounds"]
            if lo >= hi:  # the slab misses the roi
                assert float(got[1].abs().max()) == 0.0
    after = cuda_fused.launch_counts()
    form = "slab_bands" if bands and not raw_mode else "dyn_rows"
    assert after[f"{name}:{form}"] - before[f"{name}:{form}"] == 2 * r_ax


@pytest.mark.parametrize("ring", [True, False])
def test_grid_fleet_cuda_equals_no_mesh_fleet(cuda, ring):
    """A (2, 2) grid whose cells all name this card: outputs and carried
    state equal the fleet's without a mesh, bit for bit."""
    from dips_tpu_torch import MultiStreamEngine
    from dips_tpu_torch.parallel import grid_mesh
    h, w, s, b = 64, 200, 4, 6
    rng = np.random.default_rng(9)
    feeds = [[list(rng.integers(0, 256, (b, h, w, 3), np.uint8))
              for _ in range(s)] for _ in range(2)]
    for props in (DiPsProperties(window_size=5),
                  DiPsProperties(output=OutputMode.ABSDIFF,
                                 roi=(40, 20, 60, 180))):
        runs = []
        for mesh in (None, grid_mesh(2, 2, devices=[cuda] * 4)):
            fleet = MultiStreamEngine(props, h, w, s, batch=b, device=cuda,
                                      mesh=mesh, ring_carry=ring)
            outs = [fleet.process_batch(f) for f in feeds]
            runs.append((outs, fleet.state_dict()["baseline"],
                         fleet.heatmaps()))
        for (o, st, _), (eo, es, _) in zip(runs[1][0], runs[0][0]):
            np.testing.assert_array_equal(o, eo)
            np.testing.assert_allclose(st, es, rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(runs[1][1], runs[0][1])
        np.testing.assert_array_equal(runs[1][2], runs[0][2])


def test_unaligned_slabs_raise_on_the_card(cuda):
    """Slabs that are not 8-row aligned have no kernel: on the card the
    fleet, the default grid step and ``backend="plain"`` all raise instead
    of running the plain twins there."""
    from dips_tpu_torch import MultiStreamEngine
    from dips_tpu_torch.parallel import grid2d, grid_mesh
    props = DiPsProperties(window_size=3, temporal_size=2)
    h, w, s, b = 24, 200, 2, 4  # Hp = 24 on 4 row shards: 6-row slabs
    hp, wp = pad_geometry(h, w)
    mesh = grid_mesh(1, 4, devices=[cuda] * 4)
    with pytest.raises(ValueError, match="8-row-aligned"):
        MultiStreamEngine(props, h, w, s, batch=b, device=cuda, mesh=mesh)
    before = cuda_fused.launch_counts()
    for backend, hh in ((None, h), ("plain", h), ("plain", 64)):
        hp = pad_geometry(hh, w)[0]
        step = grid2d.make_grid_step(props, hh, w, mesh, backend=backend)
        raw = torch.zeros((s, 2 + b, 3, hp, wp), dtype=torch.uint8,
                          device=cuda)
        with pytest.raises(ValueError, match="CPU tensors only"):
            step(raw, torch.zeros((s, hp, wp), device=cuda),
                 np.zeros((s, b), bool), torch.zeros((s, hp, wp), device=cuda),
                 np.ones((s, b), bool))
    assert cuda_fused.launch_counts() == before


# ---------------------------------------------------------------------------
# the post-analysis on the card (cuFFT and plain torch ops) against the CPU
# ---------------------------------------------------------------------------

def _flicker_frames(n, h, w, seed):
    rng = np.random.default_rng(seed)
    frames = np.repeat(rng.integers(0, 256, (1, h, w, 3), np.uint8), n, 0)
    for k in range(n):
        frames[k, 8:16, 10:20] = int(128 + 90 * np.cos(2 * np.pi * k / 6))
    return frames


@pytest.mark.parametrize("chroma", [ChromaFilter.ALL, ChromaFilter.RED])
def test_flicker_on_the_card_equals_the_cpu(cuda, chroma):
    """The analyzers' maps on the card equal the CPU's bit for bit (IEEE
    mul / add / div in both), and the fleet equals its single analyzers
    over ragged rounds with a gated stream."""
    from dips_tpu_torch.ops import analysis
    frames = _flicker_frames(40, H, W, 3)
    maps = {}
    for dev in ("cpu", "cuda"):
        fa = analysis.FlickerAnalyzer(5.0, 30.0, chroma=chroma, batch=16,
                                      device=dev)
        fa.update(frames[:23])
        for f in frames[23:]:
            fa.update(f)
        maps[dev] = fa.amplitude()
    np.testing.assert_array_equal(maps["cuda"], maps["cpu"])
    fleet = analysis.FleetFlickerAnalyzer(3, chroma=chroma, device="cuda")
    fleet.configure_all(5.0, 30.0)
    singles = [analysis.FlickerAnalyzer(5.0, 30.0, chroma=chroma,
                                        device="cuda") for _ in range(3)]
    cursor = [0, 0, 0]
    for counts in ((16, 0, 5), (3, 16, 16), (16, 7, 0)):
        feeds = []
        for si, c in enumerate(counts):
            feeds.append(list(frames[cursor[si]:cursor[si] + c]))
            if c:
                singles[si].update(frames[cursor[si]:cursor[si] + c])
            cursor[si] += c
        fleet.update(feeds)
    for si in range(3):
        np.testing.assert_array_equal(fleet.amplitude(si),
                                      singles[si].amplitude())


def test_fft_ops_on_the_card_match_the_cpu(cuda):
    """temporal_dft, fft_denoise and denoise_frames on the card against
    the CPU: rtol 1e-5 / 1e-4, and denoised uint8 maps within 1 LSB with
    at most 1e-3 flipped."""
    from dips_tpu_torch.ops import analysis
    rng = np.random.default_rng(5)
    traces = rng.standard_normal((33, 20, 30)).astype(np.float32)
    for got, exp in zip(analysis.temporal_dft(traces, device="cuda"),
                        analysis.temporal_dft(traces, device="cpu")):
        assert got.device.type == "cuda"
        np.testing.assert_allclose(got.cpu().numpy(), exp.numpy(),
                                   rtol=1e-5, atol=1e-4)
    img = rng.integers(0, 256, (3, H, W)).astype(np.float32)
    np.testing.assert_allclose(
        analysis.fft_denoise(img, 9, device="cuda").cpu().numpy(),
        analysis.fft_denoise(img, 9, device="cpu").numpy(), rtol=1e-4,
        atol=1e-3)
    frames = rng.integers(0, 256, (4, H, W, 3), np.uint8)
    got = analysis.denoise_frames(torch.from_numpy(frames).to(cuda), 9)
    exp = analysis.denoise_frames(frames, 9, device="cpu")
    d = (got.cpu().to(torch.int16) - exp.to(torch.int16)).abs()
    assert d.max() <= 1 and (d > 0).float().mean() <= 1e-3
    with pytest.raises(ValueError, match="was asked for"):
        analysis.fft_denoise(torch.from_numpy(img), 9, device="cuda")


# -- the block geometry, a build parameter ------------------------------------

#: a height every tile height divides (8, 16, 24, 32 rows)
GH = 96
GEOMETRY_TILES = [(24, 2, 2), (16, 1, 4)]
GEOMETRY_BLOCKS = [(512, 32), (128, 16), (992, 32)]
#: a tile whose shared memory at w7 and T = 16 exceeds an H100's
TOO_BIG = (32, 4, 4)


@pytest.fixture(scope="module")
def geometry_libs():
    """Build every library the geometry tests launch at once, one nvcc a
    unit (one at a time, they would take minutes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dips_tpu_torch import autotune
    from dips_tpu_torch.ops import _build
    from dips_tpu_torch.ops._build import Geometry, MedianTile, RawBlock
    units = [_build.median_unit(tail, w) for tail in (False, True)
             for w in (1, 3, 7)]
    specs = [(Geometry(tile=MedianTile(*t)), (u,))
             for t in GEOMETRY_TILES for u in units]
    specs += [(Geometry(tile=MedianTile(*TOO_BIG)),
               (_build.median_unit(False, 7),))]
    specs += [(Geometry(block=RawBlock(*b)), (_build.RAW_UNIT,))
              for b in GEOMETRY_BLOCKS]
    autotune._build_all([(Geometry(), None)] + specs)


def _geometry_runs(props, cuda, tail, tile, s=2, bands=False):
    """Two batches of the median ring (tail) kernel at s stacked sections
    of GH x W, launched with ``tile`` (None: the default); ``bands``: the
    sections are row slabs with seeded neighbour bands (the grid cell's
    launch)."""
    from dips_tpu_torch.ops import _build  # noqa: F401
    t = props.temporal_size
    hp, wp = pad_geometry(GH, W)
    b = 6
    frames = (t if tail else 0) + b
    raw = torch.from_numpy(np.concatenate(
        [make_raw(frames, GH, W, 40 + si) for si in range(s)],
        axis=2)).to(cuda)
    flags = np.zeros((s, b), bool)
    flags[:, [0, 4]] = True
    valid = np.ones((s, b), bool)
    valid[-1, 3] = False
    kw = {}
    if bands:
        rng = np.random.default_rng(50)
        top, bottom = (torch.from_numpy(rng.integers(
            0, 256, (frames, 3, s * 8, wp), np.uint8)).to(cuda)
            for _ in range(2))
        kw = dict(row_bounds=(0, GH), bands=(top, bottom))
    st = [None if tail else torch.zeros((t, s * hp, wp), device=cuda),
          None if tail else torch.zeros((s * hp, wp), device=cuda),
          torch.zeros((s * hp, wp), device=cuda),
          torch.zeros((s * hp, wp), device=cuda)]
    runs = []
    for seeded in (1, 0):
        res, used = cuda_fused._launch_median(
            "test", props, GH, W, s, raw, st[0], st[1], st[2], flags, st[3],
            valid, None if tail else np.arange(s) % t,
            None if tail else np.full(s, seeded), tile=tile, **kw)
        runs.append([x.clone() for x in res])
    torch.cuda.synchronize()
    return runs, used


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("geom", GEOMETRY_TILES)
@pytest.mark.parametrize("window", [3, 7])
def test_a_tile_launch_equals_the_default(cuda, geometry_libs, geom, tail,
                                         window):
    """A non-default tile's launch equals the default tile's: maps and
    carried state bit for bit, stats within 1e-5 (the per-warp partials
    are summed in float32 over a tile's pixels, and the tile changed)."""
    _assert_tile_equals_the_default(cuda, geom, tail, window)


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("geom", GEOMETRY_TILES)
@pytest.mark.parametrize("window", [3, 7])
def test_a_stacked_band_tile_launch_equals_the_default(
        cuda, geometry_libs, geom, tail, window):
    """The same in the band form at s = 4 (four streams' owned slabs with
    their neighbour bands in one launch: a grid cell's, the shape the
    stacked-slab tile is measured on and picked for)."""
    _assert_tile_equals_the_default(cuda, geom, tail, window, s=4,
                                    bands=True)


def _assert_tile_equals_the_default(cuda, geom, tail, window, **kw):
    from dips_tpu_torch.ops._build import MedianTile
    props = DiPsProperties(window_size=window, temporal_size=3)
    exp, used = _geometry_runs(props, cuda, tail, None, **kw)
    assert used == MedianTile()
    got, used = _geometry_runs(props, cuda, tail, MedianTile(*geom), **kw)
    assert used == MedianTile(*geom)
    for g, e in zip(got, exp):
        for i, (x, y) in enumerate(zip(g, e)):
            if i == 1:
                _assert_stats(x.reshape(-1, 4), y.reshape(-1, 4))
            else:
                assert torch.equal(x, y), i


@pytest.mark.parametrize("block", GEOMETRY_BLOCKS)
@pytest.mark.parametrize("props", RAW_CASES[:3])
def test_a_raw_block_launch_equals_the_default(cuda, geometry_libs, props,
                                               block):
    """A non-default raw block's launch equals the default's bit for bit,
    stats too (integer partials summed in int64)."""
    from dips_tpu_torch.ops._build import RawBlock
    hp, wp = pad_geometry(H, W)
    raw = torch.from_numpy(make_raw(8, H, W, 7)).to(cuda)
    out = []
    for blk in (None, RawBlock(*block)):
        st = _state(props, hp, wp, True, cuda)
        runs = []
        for seeded in (1, 0):
            res, used = cuda_fused._launch_raw(
                "test", props, H, W, 1, raw, st[0], st[1],
                [[1, 0, 0, 1, 0, 0, 0, 0]], st[2], [[1] * 8], [seeded],
                block=blk)
            runs.append([x.clone() for x in res])
        assert used == (blk or RawBlock())
        out.append(runs)
    for g, e in zip(*out):
        for x, y in zip(g, e):
            assert torch.equal(x, y)


def test_shared_memory_mirror_matches_the_library(cuda, geometry_libs):
    """``MedianTile.smem_bytes`` (which drops the candidates that cannot
    launch before they are built) equals what the kernels ask for."""
    from dips_tpu_torch.ops import _build
    from dips_tpu_torch.ops._build import Geometry, MedianTile
    for tile in (MedianTile(), *(MedianTile(*t) for t in GEOMETRY_TILES)):
        for w in (1, 3, 7):
            for tail in (False, True):
                lib = _build.kernel_lib(Geometry(tile=tile),
                                        _build.median_unit(tail, w))
                fn = getattr(lib, _build.median_symbol(tail, w, "smem"))
                for mode in range(3):
                    for t in (1, 4, 16):
                        assert fn(mode, t) == tile.smem_bytes(w, mode, t)


def test_a_tile_that_cannot_launch_raises(cuda, geometry_libs):
    """A tile whose shared memory exceeds the card's raises at its launch;
    nothing falls back to the default."""
    from dips_tpu_torch.ops._build import MedianTile
    props = DiPsProperties(window_size=7, temporal_size=16)
    with pytest.raises(RuntimeError, match="32x128/s4 tile"):
        _geometry_runs(props, cuda, False, MedianTile(*TOO_BIG), s=1)


def test_a_stored_geometry_reaches_the_engine(cuda, geometry_libs, tmp_path,
                                             monkeypatch):
    """With a store naming a non-default tile and block for this card, the
    engines launch them, and their outputs equal the default's; a (2, 2)
    grid fleet's stacked band launches take a stored stacked-slab tile,
    and the default when only the s = 1 slab tile is stored."""
    from dips_tpu_torch import DiPsEngine, MultiStreamEngine
    from dips_tpu_torch.ops import tuning
    from dips_tpu_torch.ops._build import MedianTile, RawBlock
    from dips_tpu_torch.parallel import grid_mesh
    frames = [np.ascontiguousarray(f.transpose(1, 2, 0))
              for f in make_raw(8, GH, W, 3)[:, :, :GH, :W]]

    def run(props):
        eng = DiPsEngine(props, GH, W, batch=8, device="cuda")
        cuda_fused.reset_launch_counts()
        out, stats = eng.process_batch(frames)
        return out, stats, cuda_fused.geometry_counts()

    monkeypatch.setenv("DIPS_TPU_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "a.json"))
    tuning.invalidate()
    for props, name in ((DiPsProperties(), "batch_step_ring"),
                        (DiPsProperties(output=OutputMode.ABSDIFF),
                         "absdiff_step_ring")):
        out0, stats0, geo0 = run(props)
        assert geo0 == {name: {("8x128/s3" if "batch" in name
                                else "256x16"): 1}}
        tuning.save(torch.cuda.get_device_name(0),
                    ring_tiles={3: MedianTile(24, 2, 2)},
                    raw_block=RawBlock(512, 32))
        out1, stats1, geo1 = run(props)
        assert geo1 == {name: {("24x64/s2" if "batch" in name
                                else "512x32"): 1}}
        np.testing.assert_array_equal(out1, out0)
        np.testing.assert_allclose(stats1, stats0, rtol=1e-5, atol=1e-7)
        tuning.save(torch.cuda.get_device_name(0),
                    ring_tiles={3: MedianTile()}, raw_block=RawBlock())

    # the grid fleet: 4 streams of 64 rows on (2, 2) cells of this card,
    # two streams' 32-row owned slabs a launch
    h, s, b = 64, 4, 6
    rng = np.random.default_rng(9)
    feed = [list(rng.integers(0, 256, (b, h, W, 3), np.uint8))
            for _ in range(s)]
    tile = MedianTile(*GEOMETRY_TILES[1])
    name = "batch_step_ring_stacked"

    def fleet_run(**store):
        monkeypatch.setenv("DIPS_TPU_TORCH_AUTOTUNE_CACHE",
                           str(tmp_path / f"grid{len(store)}.json"))
        tuning.invalidate()
        if store:
            tuning.save(torch.cuda.get_device_name(0), **store)
        fleet = MultiStreamEngine(DiPsProperties(), h, W, s, batch=b,
                                  device=cuda,
                                  mesh=grid_mesh(2, 2, devices=[cuda] * 4))
        cuda_fused.reset_launch_counts()
        out, stats, _ = fleet.process_batch(feed)
        return out, stats, cuda_fused.geometry_counts()

    out0, stats0, geo0 = fleet_run()
    out1, stats1, geo1 = fleet_run(
        stacked_slab_ring_tiles={3: {32: tile}},
        slab_ring_tiles={3: {32: MedianTile(24, 2, 2)}})
    assert geo0 == {name: {MedianTile().name(): 4}}
    assert geo1 == {name: {tile.name(): 4}}
    np.testing.assert_array_equal(out1, out0)
    np.testing.assert_allclose(stats1, stats0, rtol=1e-5, atol=1e-7)
    *_, geo2 = fleet_run(slab_ring_tiles={3: {32: tile}})
    assert geo2 == {name: {MedianTile().name(): 4}}
    tuning.invalidate()


# ---------------------------------------------------------------------------
# The raw kernel's grid: a card's worth of blocks, each walking an even
# share of a stream in tiles, frames staged by TMA, the stats reduced in
# the launch.  Its edges against the plain twins, bit for bit: maps,
# carried state, heatmap and stats (the step sums integer partials in
# int64 and scales them as reduce_raw_stats does).
# ---------------------------------------------------------------------------

def _noise_stack(frames, h, w, s, seed, rows=None):
    """(frames, 3, s*rows, Wp) u8: seeded noise with a bright square
    moving through it in every stream's true h x w region, zero padding
    (``rows``: a section's height, default the padded Hp)."""
    hp, wp = pad_geometry(h, w)
    rows = rows or hp
    rng = np.random.default_rng(seed)
    raw = np.zeros((frames, 3, s, rows, wp), np.uint8)
    hh = min(h, rows)
    raw[..., :hh, :w] = rng.integers(0, 256, (frames, 3, s, hh, w),
                                     np.uint8)
    for i in range(frames):
        y, x = (3 * i) % max(1, hh - 8), (11 * i) % max(1, w - 8)
        raw[i, :, :, y:y + 8, x:x + 8] = 250
    return raw.reshape(frames, 3, s * rows, wp)


def _raw_twins(props, h, w, s, raw, batches, tail, cuda, rows=None,
               row_bounds=None):
    """``batches`` = [(frame slice, flags (s, b), valid (s, b), seeds)]
    through the stacked raw wrapper (ring, or ``tail``) and its plain
    twin, state carried from batch to batch; every output and the state
    held bit for bit after each batch."""
    hp, wp = pad_geometry(h, w)
    rows = rows or hp
    shape = (3, s * rows, wp)
    mk = lambda: [torch.zeros(shape, dtype=torch.uint8, device=cuda)  # noqa
                  for _ in range(2)] + [
        torch.zeros(shape[1:], device=cuda)]
    states = [mk(), mk()]
    kw = {} if row_bounds is None else dict(row_bounds=row_bounds)
    fns = ((cuda_fused.absdiff_step_stacked,
            cuda_fused.absdiff_step_stacked_plain) if tail else
           (cuda_fused.absdiff_step_ring_stacked,
            cuda_fused.absdiff_step_ring_stacked_plain))
    for sl, flags, valid, seeds in batches:
        x = raw[sl]
        res = []
        for fn, (prev, base, heat) in zip(fns, states):
            f = torch.tensor(flags, dtype=torch.bool, device=cuda)
            v = torch.tensor(valid, dtype=torch.bool, device=cuda)
            if tail:
                res.append(fn(props, h, w, s, x, base, f, heat, v, **kw))
            else:
                res.append(fn(props, h, w, s, x, prev, base, f, heat, v,
                              seeds, **kw))
        torch.cuda.synchronize()
        got, exp = res
        for i, (g, e) in enumerate(zip(got, exp)):
            assert torch.equal(g, e), i
        assert torch.equal(states[0][0], states[1][0])


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("h,w,s,b", [(24, 140, 1, 5), (1080, 1920, 1, 5),
                                     (1080, 1920, 8, 3), (4320, 7680, 1, 2)])
def test_raw_kernel_uneven_splits_match_plain(cuda, h, w, s, b, tail):
    """Chunk counts that do not divide among the blocks or tiles: the
    acceptance clips' 24 x 140 (one block, two tiles), 1080p at s = 1
    (264 blocks of 523-524 chunks on an H100) and s = 8 (33 a stream),
    8K; PER_FRAME ABSDIFF (ring) and OVERALL THRESHOLD with an roi whose
    columns cut 16-byte chunks (tail)."""
    t = 3
    props = (DiPsProperties(output=OutputMode.THRESHOLD, temporal_size=t,
                            change_threshold=17,
                            roi=(h // 7, 13, h - h // 5, w - 11))
             if tail else
             DiPsProperties(method=DiPsMethod.PER_FRAME,
                            output=OutputMode.ABSDIFF))
    lead = t if tail else 0
    raw = torch.from_numpy(_noise_stack(lead + 2 * b, h, w, s, 71)).to(cuda)
    rng = np.random.default_rng(72)
    batches = []
    for k in range(2):
        flags = rng.integers(0, 2, (s, b)).astype(bool)
        valid = rng.integers(0, 4, (s, b)) > 0
        sl = slice(k * b, k * b + lead + b)
        batches.append((sl, flags, valid, [1 - k] * s))
    _raw_twins(props, h, w, s, raw, batches, tail, cuda)


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("row_bounds", [(0, 0), (5, 17), (0, 120)])
def test_raw_kernel_roi_edges_and_slab_windows_match_plain(cuda, row_bounds,
                                                           tail):
    """The dyn_rows form on three 120-row slabs: a window that misses the
    slab (0, 0), one inside it, the whole slab; the roi's columns (5, 203)
    cut a 16-byte chunk at both ends."""
    h, w, s, b, rows = 360, 640, 3, 4, 120
    props = DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2,
                           roi=(0, 5, 360, 203))
    lead = 2 if tail else 0
    raw = torch.from_numpy(_noise_stack(lead + 2 * b, h, w, s, 73,
                                        rows=rows)).to(cuda)
    flags = np.zeros((s, b), bool)
    flags[:, 0] = True
    valid = np.ones((s, b), bool)
    valid[1, 2] = False
    batches = [(slice(k * b, k * b + lead + b), flags, valid, [1 - k] * s)
               for k in range(2)]
    _raw_twins(props, h, w, s, raw, batches, tail, cuda, rows=rows,
               row_bounds=row_bounds)


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("method", [DiPsMethod.OVERALL, DiPsMethod.PER_FRAME])
def test_raw_kernel_one_frame_batches_match_plain(cuda, method, tail):
    """B = 1, batch after batch, invalid and flagged frames mixed (the
    ring form gates capture and advance on valid, the tail form does not),
    two streams with different flags."""
    h, w, s, t = 60, 200, 2, 2
    props = DiPsProperties(method=method, output=OutputMode.ABSDIFF,
                           temporal_size=t)
    lead = t if tail else 0
    n = 8
    raw = torch.from_numpy(_noise_stack(lead + n, h, w, s, 74)).to(cuda)
    pattern = [(1, 1), (1, 0), (0, 0), (0, 1), (1, 1), (0, 1), (1, 0),
               (0, 1)]
    batches = []
    for k in range(n):
        f0, v0 = pattern[k]
        f1, v1 = pattern[(k + 3) % n]
        batches.append((slice(k, k + lead + 1), [[f0], [f1]], [[v0], [v1]],
                        [1 if k == 0 else 0] * s))
    _raw_twins(props, h, w, s, raw, batches, tail, cuda)


def test_raw_launches_from_two_threads_on_two_streams(cuda):
    """Two threads launch the raw step at once, each on its own CUDA
    stream, state and frames (a server's sessions do): each equals the
    plain twin run alone, so no launch shares anything with the other."""
    import threading
    h, w, b, n = 1080, 1920, 8, 4
    props = DiPsProperties(output=OutputMode.ABSDIFF)
    hp, wp = pad_geometry(h, w)
    feeds = [torch.from_numpy(_noise_stack(n * b, h, w, 1, 75 + i)).to(cuda)
             for i in range(2)]
    flags = np.zeros(b, bool)
    flags[0] = True
    valid = np.ones(b, bool)

    def run(fn, raw, results):
        st = [torch.zeros((3, hp, wp), dtype=torch.uint8, device=cuda)
              for _ in range(2)] + [torch.zeros((hp, wp), device=cuda)]
        for k in range(n):
            out, stats, *_ = fn(props, h, w, raw[k * b:(k + 1) * b], st[0],
                                st[1], flags, st[2], valid, int(k == 0))
            results.append((out.clone(), stats.clone()))
        results.append([x.clone() for x in st])

    got = [[], []]
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    start = threading.Barrier(2)

    def thread(i):
        with torch.cuda.stream(streams[i]):
            start.wait()
            run(cuda_fused.absdiff_step_ring, feeds[i], got[i])
            streams[i].synchronize()

    threads = [threading.Thread(target=thread, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    for i in range(2):
        exp = []
        run(cuda_fused.absdiff_step_ring_plain, feeds[i], exp)
        torch.cuda.synchronize()
        assert len(got[i]) == len(exp)
        for g, e in zip(got[i], exp):
            for x, y in zip(g, e):
                assert torch.equal(x, y)


def test_the_raw_library_reports_its_grid(cuda, geometry_libs):
    """Each raw library's partial count and shared memory equal the host's
    mirror (``RawBlock.parts`` / ``smem_bytes``), and it holds one to four
    blocks an SM."""
    from dips_tpu_torch.ops import _build
    from dips_tpu_torch.ops._build import Geometry, RawBlock
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for blk in [RawBlock()] + [RawBlock(*g) for g in GEOMETRY_BLOCKS]:
        lib = _build.kernel_lib(Geometry(block=blk), _build.RAW_UNIT)
        assert lib.dips_raw_smem() == blk.smem_bytes()
        resident = lib.dips_raw_resident(1)
        for mode in range(3):
            assert sms <= lib.dips_raw_resident(mode) <= 4 * sms
        assert lib.dips_raw_resident(3) < 0
        for h, w, s in ((24, 140, 1), (1080, 1920, 1), (1080, 1920, 8),
                        (4320, 7680, 1)):
            hp, wp = pad_geometry(h, w)
            if wp % blk.bytes:
                continue
            nb = blk.blocks(s, hp, wp, resident)
            assert lib.dips_raw_parts(hp, wp, nb) == blk.parts(hp, wp, nb)
        assert lib.dips_raw_parts(8, 16, 0) == 0
