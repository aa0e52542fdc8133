"""The port's CUDA kernels against their plain PyTorch twins, on the card.

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
    hp, wp = pad_geometry(H, W)
    raw = torch.zeros((2, 3, hp, wp), dtype=torch.uint8, device=cuda)
    props = DiPsProperties(approx_median=True)
    ring, prev, base, heat = _state(props, hp, wp, False, cuda)
    flags = torch.zeros(2, dtype=torch.bool, device=cuda)
    with pytest.raises(NotImplementedError):
        cuda_fused.batch_step_ring(props, H, W, raw, ring, prev, base, flags,
                                   heat, flags, 0, 1)
    with pytest.raises(TypeError):  # a float frame is not a u8 frame
        cuda_fused.batch_step_ring(DiPsProperties(), H, W, raw.float(), ring,
                                   prev, base, flags, heat, flags, 0, 1)
