"""The batch I/O layer under both engines (``models/batchio.py``) and the
one-stream checkpoint (``models/pipeline.py``), on the CPU.

* A one-stream ``MultiStreamEngine`` is byte-equal to a ``DiPsEngine`` fed
  the same frames: maps, stats, heatmap and slot state, over both
  protocols, the hwc / hwc_bgr / planar layouts, ABSDIFF, COLORIZE and
  THRESHOLD with ``packed_wire``, full and partial batches, a snapshot and
  a refresh marker.
* ``interleave`` / ``unpack`` and the layer's device-side maps at s = 1
  and s = 3 equal plain view / slice / permute expressions.
* ``capture_flags``: cursor 0, refresh markers, a pending snapshot.
* The upload buffers: handed out in rotation, each again only after the
  event of its last upload (fake events here; on the CPU there are none
  and the buffer is the upload itself).
* Checkpoints: an empty tail list is "no tail" to ``DiPsEngine`` and an
  error to a fleet slot; a short tail is padded with its oldest frame in
  both, which then run on alike.

No JAX here.  Sizes: H = 24, W = 37 (odd), B = 4.
"""

import numpy as np
import pytest
import torch

from dips_tpu_torch import (DiPsEngine, DiPsProperties, MultiStreamEngine,
                            OutputMode)
from dips_tpu_torch.models.batchio import (BatchIO, capture_flags,
                                           interleave, unpack)
from dips_tpu_torch.ops import wire
from dips_tpu_torch.ops.reference import pad_geometry

H, W, B = 24, 37, 4
HP, WP = pad_geometry(H, W)
MODES = {
    "absdiff": (DiPsProperties(output=OutputMode.ABSDIFF), False),
    "colorize": (DiPsProperties(), False),
    "threshold_packed": (DiPsProperties(output=OutputMode.THRESHOLD), True),
}


def clip(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (H, W, 3), np.uint8) for _ in range(n)]


def pair(mode: str, **kw):
    props, packed = MODES[mode]
    props = props.with_refresh_markers((7,))
    single = DiPsEngine(props, H, W, batch=B, device="cpu",
                        packed_wire=packed, **kw)
    fleet = MultiStreamEngine(props, H, W, 1, batch=B, device="cpu",
                              packed_wire=packed, **kw)
    return single, fleet


def assert_state_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, k
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- one-stream fleet == single-stream engine ---------------------------------
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("layout", ["hwc", "hwc_bgr", "planar"])
@pytest.mark.parametrize("ring", [True, False])
def test_one_stream_fleet_equals_single_engine(ring, layout, mode):
    """Batches of B, 2, B (a snapshot before it; frame 7 a refresh marker)
    and 1 frames give the same bytes from both engines."""
    single, fleet = pair(mode, ring_carry=ring, input_layout=layout)
    for k, n in enumerate((B, 2, B, 1)):
        if k == 2:
            single.snapshot()
            fleet.snapshot(0)
        frames = clip(10 + k, n)
        want_maps, want_stats = single.process_batch(frames)
        maps, stats, gmean = fleet.process_batch([frames])
        assert maps.shape == (1,) + want_maps.shape
        np.testing.assert_array_equal(maps[0], want_maps)
        np.testing.assert_array_equal(stats[0], want_stats)
        assert gmean == pytest.approx(float(want_stats[:, 1].mean()),
                                      rel=1e-6)
    np.testing.assert_array_equal(fleet.heatmaps()[0], single.heatmap())
    assert_state_equal(fleet.stream_state_dict(0), single.state_dict())


# -- the layout functions ------------------------------------------------------
def planar_maps(s: int, c: int, seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (B, c, s * HP, WP), generator=g,
                         dtype=torch.uint8)


@pytest.mark.parametrize("s", [1, 3])
def test_interleave_pack_unpack_equal_plain_expressions(s):
    n, c = B - 1, 3
    out = planar_maps(s, c)
    # (s, n, H, W, C) by view, slice and permute
    want = out[:n].view(n, c, s, HP, WP)[..., :H, :W].permute(
        2, 0, 3, 4, 1).contiguous()
    got = interleave(out, n, s, H, W)
    assert got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    mask = planar_maps(s, 1, seed=1)
    packed = wire.pack_mask(mask[:n])
    want_unpacked = np.ascontiguousarray(wire.unpack_mask(
        packed.numpy()).reshape(n, 1, s, HP, WP)[..., :H, :W].transpose(
            2, 0, 3, 4, 1))
    np.testing.assert_array_equal(unpack(packed.numpy(), n, s, H, W),
                                  want_unpacked)
    io = BatchIO(torch.device("cpu"), H, W, c, False, s, (1,), 1)
    packed_io = BatchIO(torch.device("cpu"), H, W, 1, True, s, (1,), 1)
    torch.testing.assert_close(io.maps(out, n), want, rtol=0, atol=0)
    torch.testing.assert_close(packed_io.maps(mask, n), packed,
                               rtol=0, atol=0)
    if s == 1:  # one stream's (n, H, W, C), without the stream axis
        one = BatchIO(torch.device("cpu"), H, W, c, False, None, (1,), 1)
        torch.testing.assert_close(
            one.maps(out, n),
            out[:n, :, :H, :W].permute(0, 2, 3, 1).contiguous(),
            rtol=0, atol=0)
        np.testing.assert_array_equal(
            unpack(packed.numpy(), n, 1, H, W)[0],
            np.moveaxis(wire.unpack_mask(packed.numpy())[:, :, :H, :W],
                        1, -1))


@pytest.mark.parametrize("streams", [None, 3])
def test_collect_shapes_on_the_cpu(streams):
    """Stats-only results come down with empty maps; packed masks come
    down unpacked, or as they are with ``packed``."""
    s, n = streams or 1, 2
    lead = (n,) if streams is None else (s, n)
    stats = torch.rand((n, 4)) if streams is None else torch.rand((s, n, 4))
    none = BatchIO(torch.device("cpu"), H, W, 0, False, streams, (1,), 1)
    maps, got = none.collect(planar_maps(s, 0), stats, n)
    assert maps.shape == lead + (H, W, 0) and maps.dtype == np.uint8
    np.testing.assert_array_equal(got, stats.numpy())
    io = BatchIO(torch.device("cpu"), H, W, 1, True, streams, (1,), 1)
    dev = io.maps(planar_maps(s, 1), n)
    maps, _ = io.collect(dev, stats, n)
    assert maps.shape == lead + (H, W, 1)
    raw, _ = io.collect(dev, stats, n, packed=True)
    np.testing.assert_array_equal(raw, dev.numpy())


@pytest.mark.parametrize("cursor,n,markers,pending,want", [
    (0, B, (), False, [1, 0, 0, 0]),         # the stream's frame 0
    (0, 1, (), True, [1, 0, 0, 0]),
    (5, B, (6, 8, 40), False, [0, 1, 0, 1]),  # markers 6 and 8 in the batch
    (5, 2, (7,), False, [0, 0, 0, 0]),        # marker 7 past its 2 frames
    (5, 2, (), True, [1, 0, 0, 0]),           # a pending snapshot
    (9, 3, (2, 30), False, [0, 0, 0, 0]),     # nothing fires
])
def test_capture_flags(cursor, n, markers, pending, want):
    row = np.zeros((B,), np.bool_)
    capture_flags(row, cursor, n, markers, pending)
    np.testing.assert_array_equal(row, np.asarray(want, np.bool_))


# -- the upload buffers ----------------------------------------------------------
class FakeEvent:
    def __init__(self, log: list, k: int):
        self.log, self.k = log, k

    def record(self):
        self.log.append(("record", self.k))

    def synchronize(self):
        self.log.append(("synchronize", self.k))


def test_buffers_rotate_and_wait_for_their_upload():
    io = BatchIO(torch.device("cpu"), H, W, 3, False, None, (B, H, W, 3), 2)
    a, b = io.buffer(), io.buffer()
    assert a is not b and io.buffer() is a  # rotation, no events
    assert io._events == []
    a[:] = 5
    up = io.upload(a, 1, 3)  # on the CPU: a view of the rows
    assert up.shape == (2, H, W, 3) and up.data_ptr() == a[1:].ctypes.data
    # what a card does, with events that log
    log: list = []
    io._events = [FakeEvent(log, k) for k in range(2)]
    io._next = 0
    buf = io.buffer()
    io.upload(buf)
    io.upload(np.zeros((B, H, W, 3), np.uint8))  # not the layer's: no event
    assert log == [("synchronize", 0), ("record", 0)]
    io.buffer()
    assert io.buffer() is buf  # handed out again after its own event
    assert log[-2:] == [("synchronize", 1), ("synchronize", 0)]


def test_engines_hand_out_their_buffers():
    single, fleet = pair("colorize")
    a, b = single.new_batch_buffer(), single.new_batch_buffer()
    assert a is not b and single.new_batch_buffer() is a
    assert a.shape == (B, H, W, 3)
    assert fleet._io.buffer() is fleet._io.buffer()  # the fleet's one
    assert fleet._io.buffer().shape == (1, B, H, W, 3)


# -- the one-stream checkpoint ---------------------------------------------------
def planar_frames(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (3, HP, WP), np.uint8) for _ in range(n)]


@pytest.mark.parametrize("ring", [True, False])
def test_empty_tail_list_per_entry_point(ring):
    """An empty tail list: no tail for ``DiPsEngine`` (as a None tail),
    an error for a fleet slot and for a fleet checkpoint."""
    single, fleet = pair("absdiff", ring_carry=ring)
    single.process_batch(clip(1, B))
    state = dict(single.state_dict(), tail=[])
    single.load_state_dict(state)
    assert single.state_dict()["tail"] is None
    fresh, _ = pair("absdiff", ring_carry=ring)
    fresh.load_state_dict(dict(state, tail=None))
    frames = clip(2, B)
    for a, b in zip(single.process_batch(frames),
                    fresh.process_batch(frames)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="holds no frame"):
        fleet.load_stream_state(0, state)
    fstate = fleet.state_dict()
    with pytest.raises(ValueError, match="holds no frame"):
        fleet.load_state_dict(dict(fstate, tails=[[]]))


@pytest.mark.parametrize("ring", [True, False])
def test_short_tail_is_padded_alike(ring, tmp_path):
    """A tail of fewer than T frames replicates its oldest frame up to T
    in both engines (from a dict and from a file), and they run on
    byte-equal."""
    single, fleet = pair("colorize", ring_carry=ring)
    t = single.props.temporal_size
    short = planar_frames(3, t - 2)
    state = dict(single.state_dict(), frame_index=9, tail=short)
    single.load_state_dict(state)
    fleet.load_stream_state(0, state)
    want = np.stack([short[0]] * 2 + short)
    for st in (single.state_dict(), fleet.stream_state_dict(0)):
        np.testing.assert_array_equal(st["tail"], want)
    path = str(tmp_path / "short.npz")
    single.save(path)
    other, other_fleet = pair("colorize", ring_carry=ring)
    other.load(path)
    other_fleet.load_stream(0, path)
    for k in range(2):
        frames = clip(20 + k, B - k)
        want_maps, want_stats = single.process_batch(frames)
        for maps, stats in (other.process_batch(frames),
                            fleet.process_batch([frames])[:2],
                            other_fleet.process_batch([frames])[:2]):
            np.testing.assert_array_equal(maps.reshape(want_maps.shape),
                                          want_maps)
            np.testing.assert_array_equal(stats.reshape(want_stats.shape),
                                          want_stats)


def test_slot_baseline_shape_is_checked():
    single, fleet = pair("colorize")
    state = dict(single.state_dict(),
                 baseline=np.zeros((3, HP, WP), np.uint8))
    for load in (single.load_state_dict,
                 lambda st: fleet.load_stream_state(0, st)):
        with pytest.raises(ValueError, match="baseline shape"):
            load(state)



# -- on the card -------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["absdiff", "colorize"])
def test_card_one_stream_fleet_equals_single_engine(mode):
    """At 1080p on the card, through the page-locked buffers, their
    events and the fleet's device twin: byte-equal over full and partial
    batches; each upload buffer is page-locked and comes back in turn."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    props = MODES[mode][0]
    h, w, b = 1080, 1920, 16
    single = DiPsEngine(props, h, w, batch=b, device="cuda")
    fleet = MultiStreamEngine(props, h, w, 1, batch=b, device="cuda")
    rng = np.random.default_rng(5)
    pool = [rng.integers(0, 256, (h, w, 3), np.uint8) for _ in range(24)]
    for k, n in enumerate((b, 5, b)):
        frames = [pool[(k * b + i) % len(pool)] for i in range(n)]
        want_maps, want_stats = single.process_batch(frames)
        maps, stats, _ = fleet.process_batch([frames])
        np.testing.assert_array_equal(maps[0], want_maps)
        np.testing.assert_array_equal(stats[0], want_stats)
    np.testing.assert_array_equal(fleet.heatmaps()[0], single.heatmap())
    a, c = single.new_batch_buffer(), single.new_batch_buffer()
    assert single.new_batch_buffer() is a and c is not a
    assert torch.from_numpy(a).is_pinned()
    assert torch.from_numpy(fleet._io.buffer()).is_pinned()
