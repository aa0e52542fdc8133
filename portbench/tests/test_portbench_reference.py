"""The frozen reference against ``cv2.absdiff``, against hand-made small
cases, and against the repository's own oracle of the pipeline."""

import numpy as np
import pytest

from portbench.reference import dips as ref

P_ABS = ref.Params(output="ABSDIFF")
P_COL = ref.Params(output="COLORIZE")


def _frames(seed, n, h=24, w=40):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def test_absdiff_equals_cv2():
    cv2 = pytest.importorskip("cv2")
    a, b = _frames(1, 2)
    m, _, _ = ref.absdiff_frame(a, b, 10)
    assert np.array_equal(m, cv2.absdiff(a, b))


def test_absdiff_stats_and_heat_by_hand():
    base = np.zeros((2, 2, 3), np.uint8)
    f = base.copy()
    f[0, 0] = (255, 0, 0)
    f[1, 1] = (0, 9, 12)
    m, s, heat = ref.absdiff_frame(f, base, 10)
    assert m[0, 0].tolist() == [255, 0, 0]
    inv = np.float32(1) / np.float32(3 * 4 * 255)
    assert s[0] == np.float32(-(255 + 21)) * inv
    assert s[1] == np.float32(255 + 21) * inv
    assert s[2] == np.float32(1.0)
    assert s[3] == 2  # 255 >= 10 and 12 >= 10
    assert heat[0, 0] == np.float32(255) * np.float32(1 / 765)
    assert heat[0, 1] == 0


def test_median_of_a_plane_by_hand():
    f = np.zeros((3, 3, 3), np.uint8)
    vals = np.arange(9, dtype=np.uint8).reshape(3, 3) * 10
    f[..., 0] = vals  # intensity max + min = vals + 0
    plane = ref.filtered_plane(f, 3)
    assert plane[1, 1] == 40  # the median of 0..80
    assert plane[0, 0] == 0   # 5 of its 9 taps are outside: zero


def test_temporal_median_is_the_upper_one():
    planes = np.array([[[1.0]], [[4.0]], [[2.0]], [[3.0]]], np.float32)
    assert ref.temporal_median(planes)[0, 0] == 3.0


def test_colorize_signs_and_zero():
    base = np.full((1, 3), 255.0, np.float32)
    cur = np.array([[255.0, 0.0, 510.0]], np.float32)
    m, s, a = ref.colorize_frame(cur, base, P_COL)
    assert m[0, 0].tolist() == [128, 128, 128]  # no change: mid grey
    assert m[0, 1, 1] > 200 and m[0, 1, 0] < 60   # brighter now: green
    assert m[0, 2, 0] > 200 and m[0, 2, 1] < 60   # darker now: red
    assert s[3] == 2 and a[0, 0] == 0


def test_bf16_rounding():
    # 7 stored mantissa bits: steps of 2^-7 above 1; ties go to even
    x = np.array([1.0, 1.0 + 2 ** -9, 1.0 + 3 * 2 ** -9, 1.0 + 2 ** -8,
                  257.0], np.float32)
    assert ref._bf16(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -7, 1.0, 256.0]


def test_heatmap_adds_in_order_in_float32():
    frames = _frames(3, 5, 70, 8)
    rep = ref.StreamReplay(frames, 1, P_ABS)
    want = np.zeros(frames.shape[1:3], np.float32)
    for i in range(13):
        want = want + rep.output(i)[2]
    assert np.array_equal(rep.heatmap(13), want)


@pytest.mark.parametrize("output", ["ABSDIFF", "COLORIZE"])
def test_replay_equals_the_repository_oracle(output):
    """The frozen copy against the oracle it was copied from, stream by
    stream: maps, stats and heatmap."""
    from dips_tpu_torch.ops.oracle import DiPsOracle
    from dips_tpu_torch.properties import DiPsProperties, OutputMode
    pool = _frames(5, 6)
    prm = ref.Params(output=output)
    rep = ref.StreamReplay(pool, 2, prm)
    ora = DiPsOracle(DiPsProperties(output=OutputMode[output]))
    n = 15
    for i in range(n):
        m, s = ora.process(rep.frame(i))
        em, es = rep.outputs([i])
        assert np.array_equal(m, em[0]), i
        np.testing.assert_allclose(s, es[0], rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(ora.heatmap, rep.heatmap(n))


def test_controls_differ_from_the_stated_precision():
    pool = _frames(7, 4)
    for prm, low in ((P_ABS, "int4"), (P_COL, "bf16")):
        full = ref.StreamReplay(pool, 0, prm)
        ctl = ref.StreamReplay(pool, 0, ref.Params(output=prm.output,
                                                   precision=low))
        assert not np.array_equal(full.outputs([3])[0],
                                  ctl.outputs([3])[0])


@pytest.mark.parametrize("seed", range(6))
def test_median3x3_equals_a_full_sort(seed):
    """The column-sorted 3 x 3 median against sorting all nine taps, ties
    included (few distinct values)."""
    rng = np.random.default_rng(seed)
    h, w = rng.integers(1, 40, 2)
    plane = rng.integers(0, [3, 20, 511][seed % 3], (h, w)).astype(np.float32)
    p = np.zeros((h + 2, w + 2), np.float32)
    p[1:-1, 1:-1] = plane
    taps = np.stack([p[dy:dy + h, dx:dx + w] for dy in range(3)
                     for dx in range(3)])
    assert np.array_equal(ref._median3x3(p), np.sort(taps, axis=0)[4])


def test_temporal_median_of_four_equals_a_sort():
    rng = np.random.default_rng(9)
    planes = rng.integers(0, 6, (4, 50, 50)).astype(np.float32)
    assert np.array_equal(ref.temporal_median(list(planes)),
                          np.sort(planes, axis=0)[2])
