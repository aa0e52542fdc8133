"""The roofline's byte and operation counts against hand counts at 1080p,
and the interval arithmetic of the device trace on made-up intervals."""

import pytest

from portbench import roofline, trace

H, W, B = 1080, 1920, 16
PX = H * W  # 2,073,600


def test_raw_ring_one_stream_by_hand():
    r = roofline.raw_ring_launch(H, W, 1, B)
    # 16 frames x 3 + ref in/out 2 x 3 + heatmap in/out 2 x 4 + 16 maps x 3
    assert r["bytes"] == PX * (48 + 6 + 8 + 48) == 228_096_000
    assert r["ops"] == 9 * 16 * PX
    assert r["bound"] == "bytes"
    assert r["least_s"] == pytest.approx(228_096_000 / 3.35e12)
    # 0.0680 ms a launch, 0.00426 ms a frame: chip_smoke's padded 0.00454
    # x 1920 / 2048
    assert r["least_s"] / B * 1e3 == pytest.approx(0.00454 * 1920 / 2048,
                                                    rel=2e-3)


def test_raw_ring_scales_with_streams():
    one = roofline.raw_ring_launch(H, W, 1, B)
    eight = roofline.raw_ring_launch(H, W, 8, B)
    assert eight["bytes"] == 8 * one["bytes"]
    assert eight["least_s"] == pytest.approx(8 * one["least_s"])


def test_median_ring_by_hand():
    r = roofline.median_ring_launch(H, W, 1, B, 3, 4)
    # 16 frames x 3 + f32 heatmap and baseline in/out 2 x 2 x 4 + ring of
    # 4 planes in/out 2 x 4 x 4 + 16 maps x 3
    assert r["bytes"] == PX * (48 + 16 + 32 + 48)
    # intensity 5 + 3x3 median 22 + median of 4 7, a pixel and frame
    assert r["ops"] == PX * 16 * 34
    assert r["bound"] == "bytes"
    assert r["least_s"] / B * 1e3 == pytest.approx(0.00594 * 1920 / 2048,
                                                    rel=2e-3)


def test_median_ring_counts_only_what_is_stated():
    with pytest.raises(ValueError):
        roofline.median_ring_launch(H, W, 1, B, 5, 4)


def test_peaks():
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.INT32_OPS_PER_S == pytest.approx(16.727e12, rel=1e-4)


IV = [("k1", 0.0, 10.0), ("k2", 5.0, 15.0), ("copy", 20.0, 30.0),
      ("k1", 29.0, 31.0), ("k3", 50.0, 55.0)]


def test_union_overlaps_and_gaps():
    assert trace.union_us(IV) == pytest.approx(15 + 11 + 5)
    assert trace.merged(IV) == [(0.0, 15.0), (20.0, 31.0), (50.0, 55.0)]
    assert trace.union_us([]) == 0.0


def test_union_of_nested_and_unsorted():
    iv = [("a", 10.0, 20.0), ("b", 0.0, 100.0), ("c", 30.0, 40.0)]
    assert trace.union_us(iv) == 100.0


def test_clip_to_the_stretch():
    got = trace.clip(IV, 8.0, 52.0)
    assert trace.union_us(got) == pytest.approx(7 + 11 + 2)


def test_top_ops_sums_by_name():
    top = trace.top_ops(IV, k=2)
    assert top[0] == ["k1", pytest.approx(12.0 / 1e6)]
    assert len(top) == 2 and top[1][1] == pytest.approx(10.0 / 1e6)
    assert dict(trace.top_ops(IV))["k3"] == pytest.approx(5.0 / 1e6)


def test_idle_gaps_are_named_by_the_innermost_span():
    spans = [("portbench.traced_stretch", 0.0, 60.0),
             ("portbench.process_batch", 0.0, 35.0),
             ("portbench.process_batch", 35.0, 60.0)]
    gaps = trace.idle_gaps(IV, spans, 0.0, 60.0)
    assert gaps[0] == ["portbench.process_batch", 19.0 / 1e6]
    assert [round(s * 1e6) for _, s in gaps] == [19, 5, 5]
    assert trace.idle_gaps(IV, [], 0.0, 60.0)[0][0].startswith("outside")
