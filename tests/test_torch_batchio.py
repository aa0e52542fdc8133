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
* The order of a batch sent in pieces (a fake upload that snapshots the
  rows it sends): every row goes up once, in order, already holding its
  final bytes (frames, replica slots, a stale row's zeros); the tails'
  slots are copied after the last upload, also when the launch raises,
  and the buffer's event is recorded once, after it.  The single engine
  makes one staging copy and one upload a batch at any piece size.
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
from dips_tpu_torch.utils import staging
from dips_tpu_torch.utils.staging import Staging

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


# -- a batch in pieces ----------------------------------------------------------
@pytest.fixture
def sends(monkeypatch):
    """A row a piece; the log of every upload enqueued (a snapshot of the
    rows it sends), every whole upload and every staging call (its
    destinations)."""
    monkeypatch.setattr(staging, "PIECE_BYTES", 1)
    log: list = []
    put, upload, copy = BatchIO._put, BatchIO.upload, Staging.copy

    def fake_put(self, buf, i, j):
        log.append(("put", buf, i, j, buf[i:j].copy()))
        put(self, buf, i, j)

    def logged_upload(self, buf, lo=0, hi=None):
        log.append(("upload", buf))
        return upload(self, buf, lo, hi)

    def logged_copy(self, pieces, count=False):
        log.append(("copy", [d for d, _ in pieces]))
        return copy(self, pieces, count)

    monkeypatch.setattr(BatchIO, "_put", fake_put)
    monkeypatch.setattr(BatchIO, "upload", logged_upload)
    monkeypatch.setattr(Staging, "copy", logged_copy)
    return log


def check_sent(log: list, rows: int, want=None):
    """One batch's log: rows ``[0, rows)`` sent once each, in order, each
    already holding the bytes the buffer holds after the batch (and
    ``want[r]``, where given); copies into the buffer before the last
    upload, the tails' slots after it."""
    puts = [k for k, e in enumerate(log) if e[0] == "put"]
    buf = log[puts[0]][1]
    assert [log[k][2:4] for k in puts] == [(r, r + 1) for r in range(rows)]
    for k in puts:
        _, b, r0, r1, snap = log[k]
        assert b is buf
        np.testing.assert_array_equal(snap, buf[r0:r1])
        if want is not None:
            np.testing.assert_array_equal(snap[0], want[r0])
    for e in log[:puts[-1]]:
        if e[0] == "copy":
            assert all(np.shares_memory(d, buf) for d in e[1])
    after = [e for e in log[puts[-1]:] if e[0] == "copy"]
    assert len(after) == 1 and after[0][1]  # the tails' slots
    assert not any(np.shares_memory(d, buf) for d in after[0][1])
    assert not any(e[0] == "upload" for e in log)


@pytest.mark.parametrize("layout", ["hwc", "planar"])
@pytest.mark.parametrize("ring", [True, False])
def test_engine_goes_up_whole(sends, ring, layout):
    """The single engine, a full batch and a short one at a row a piece:
    one staging copy (the frames and the tail's slots), then one upload
    of the frames' rows, as before pieces."""
    eng = DiPsEngine(DiPsProperties(), H, W, batch=B, device="cpu",
                     ring_carry=ring, input_layout=layout)
    for k, n in enumerate((B, 2)):
        del sends[:]
        eng.process_batch(clip(30 + k, n))
        assert [e[0] for e in sends] == ["copy", "upload"]
        buf = sends[1][1]
        dsts = sends[0][1]
        assert all(np.shares_memory(d, buf) for d in dsts[:n])
        assert dsts[n:] and not any(np.shares_memory(d, buf)
                                    for d in dsts[n:])


@pytest.mark.parametrize("layout", ["hwc", "planar"])
@pytest.mark.parametrize("ring", [True, False])
def test_fleet_sends_each_piece_staged(sends, ring, layout):
    """Three streams, a stream a piece: replica slots after a short
    stream's frames, a quiet stream's stale row zeroed before its upload,
    a dead stream's row zeroed, a never-fed row's zeros."""
    s = 3
    f = MultiStreamEngine(DiPsProperties(), H, W, s, batch=B, device="cpu",
                          ring_carry=ring, input_layout=layout)
    bad = [np.zeros((H + 1, W, 3), np.uint8)]
    feeds = [[clip(40, B), clip(41, 2), []],
             [clip(42, 1), [], clip(43, B)],   # stream 1 quiet: stale
             [clip(44, 3), bad, clip(45, 2)]]  # stream 1 dead
    zero = np.zeros((B, H, W, 3), np.uint8)
    for feed in feeds:
        del sends[:]
        f.process_batch(feed)
        want = [np.stack([fr[min(i, len(fr) - 1)] for i in range(B)])
                if fr and fr is not bad else zero for fr in feed]
        check_sent(sends, s, want if layout == "hwc" else None)
        buf = next(e[1] for e in sends if e[0] == "put")
        for si, fr in enumerate(feed):
            if not fr or fr is bad:
                assert not buf[si].any()
    assert sorted(f.failed) == [1]


@pytest.mark.parametrize("piece", [1, 1 << 62])
def test_send_records_the_event_once_after_the_last_upload(monkeypatch,
                                                           piece):
    """A buffer sent in pieces records its event once, after its last
    upload; sent whole, as ``upload`` does."""
    log: list = []
    io = BatchIO(torch.device("cpu"), H, W, 3, False, None, (B, H, W, 3), 2)
    io._events = [FakeEvent(log, k) for k in range(2)]
    monkeypatch.setattr(BatchIO, "_put", lambda self, buf, i, j:
                        log.append(("put", i, j)))
    monkeypatch.setattr(staging, "PIECE_BYTES", piece)
    frames = clip(50, B)
    buf = io.buffer()
    with io.send(buf, [[(buf[i], f)] for i, f in enumerate(frames)],
                 []) as up:
        puts = [("put", i, i + 1) for i in range(B)] if piece == 1 else []
        assert log == [("synchronize", 0)] + puts + [("record", 0)]
        np.testing.assert_array_equal(up.numpy(), np.stack(frames))


@pytest.mark.parametrize("piece", [1, 1 << 62])
@pytest.mark.parametrize("layout", ["hwc", "planar"])
@pytest.mark.parametrize("ring", [True, False])
def test_fleet_tails_written_when_dispatch_raises(monkeypatch, ring, layout,
                                                  piece):
    """A launch that raises after the batch went up, whole or a stream a
    piece: the tails the fleet now points at hold their frames (the
    slots' copies are made on the way out), and a later batch, which
    restages the upload buffer first, leaves the failed batch's tails as
    they were written."""
    monkeypatch.setattr(staging, "PIECE_BYTES", piece)
    s = 3
    f = MultiStreamEngine(DiPsProperties(), H, W, s, batch=B, device="cpu",
                          ring_carry=ring, input_layout=layout)
    f.process_batch([clip(60 + si, B) for si in range(s)])
    launch = "_launch_ring" if ring else "_launch_tail"

    def boom(*a, **k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(f, launch, boom)
    feed = [clip(70 + si, B) for si in range(s)]
    with pytest.raises(RuntimeError, match="launch failed"):
        f.process_batch(feed)
    t = f.props.temporal_size

    def check_tails(fed):
        for si in range(s):
            want = [native_planar(fr, f) if layout == "planar" else fr
                    for fr in fed[si][-t:]]
            np.testing.assert_array_equal(np.stack(f._tails[si]),
                                          np.stack(want))

    check_tails(feed)
    monkeypatch.setattr(f, launch, getattr(MultiStreamEngine, launch)
                        .__get__(f))
    new = [clip(80 + si, 1) for si in range(s)]
    f.process_batch(new)
    check_tails([feed[si] + new[si] for si in range(s)])


def native_planar(frame: np.ndarray, f) -> np.ndarray:
    """One (H, W, 3) frame in the fleet's padded planar layout."""
    from dips_tpu_torch import native
    return native.planarize(frame, f.hp, f.wp)


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


def card_feeds(kind: str, b: int = 16, s: int = 8):
    """Three batches of 1080p frames: full, short (the fleet's stream 3
    quiet and stream 5 short), full."""
    rng = np.random.default_rng(7)
    pool = [rng.integers(0, 256, (1080, 1920, 3), np.uint8)
            for _ in range(24)]
    at = lambda i0, n: [pool[(i0 + i) % len(pool)] for i in range(n)]
    if kind == "engine":
        return [at(0, b), at(b, 5), at(2 * b, b)]
    return [[at(k * b + 3 * si, b if k != 1 or si != 5 else 5)
             if k != 1 or si != 3 else [] for si in range(s)]
            for k in range(3)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["engine", "fleet"])
def test_card_whole_and_in_pieces_byte_equal(monkeypatch, kind):
    """At 1080p x 16 (and 8 streams) on the card: a frame or a stream a
    piece against one piece, byte-equal over three batches with a short
    batch and a quiet stream; the pieces a batch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dips_tpu_torch.utils.profiling import StageTimers
    feeds = card_feeds(kind)
    got = {}
    for piece in (1 << 62, 1):
        monkeypatch.setattr(staging, "PIECE_BYTES", piece)
        if kind == "engine":
            eng = DiPsEngine(DiPsProperties(), 1080, 1920, batch=16,
                             device="cuda")
        else:
            eng = MultiStreamEngine(DiPsProperties(), 1080, 1920, 8,
                                    batch=16, device="cuda")
        eng.timers = StageTimers()
        res = [[np.copy(x) for x in eng.process_batch(feed)[:2]]
               for feed in feeds]
        res.append(eng.heatmap() if kind == "engine" else eng.heatmaps())
        got[piece] = res
        want = 1.0 if piece > 1 or kind == "engine" else 8.0
        assert eng.staging.pieces == want
        del eng
    for a, b in zip(got[1 << 62][:3], got[1][:3]):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(got[1 << 62][3], got[1][3])


@pytest.mark.gpu
@pytest.mark.parametrize("b", [16, 1])
def test_card_fleet_pieces_at_the_default_size(b):
    """The 1080p 8 x 16 fleet goes up in pieces at the chosen size, the
    8 x 1 fleet (serving's coalesced batch) whole."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dips_tpu_torch.utils.profiling import StageTimers
    eng = MultiStreamEngine(DiPsProperties(), 1080, 1920, 8, batch=b,
                            device="cuda")
    eng.timers = StageTimers()
    for feed in card_feeds("fleet", b)[::2]:
        eng.process_batch(feed)
    if b == 1:
        assert eng.staging.pieces == 1.0
    else:
        assert eng.staging.pieces > 1
