"""The host staging of a batch (``utils/staging.py``, ``native.
copy_pieces``): one copy of the frames into the engine's upload buffer
and of the tail's newest frames into slots the engine reuses, on a pool
of host threads above a size.

* The copier equals NumPy's copy byte for byte: odd widths, a 4K frame,
  one frame, chunk boundaries inside rows, non-contiguous and
  overlapping sources; the size crossover on both sides; the NumPy
  fallback without the native module; a forked child builds a pool of
  its own (under a timeout).
* ``TailSlots``: T slots reused in ring order, no kept frame overwritten.
* ``DiPsEngine`` and ``MultiStreamEngine``: outputs, stats, heatmaps and
  ``state_dict`` byte-equal with the pool forced on and forced off, both
  protocols, hwc and hwc_bgr, partial batches, a fleet with quiet, dead
  and fresh streams; the host tail views neither the caller's frames nor
  an upload buffer, and a checkpoint's tail views no slot; a saved,
  loaded and resumed engine goes on byte-equal.
* The ``staging`` counts: only while ``timers`` is set; a pooled share of
  1.0 for a 1080p x 16 batch and 0.0 for one 64 x 64 frame.
* Marked ``gpu`` (they skip without a card; no JAX here, so they run with
  ``--noconftest``): the 1080p x 16 engine and the 1080p 8 x 16 fleet
  byte-equal with the pool on and off, and ``stage_in`` faster with it.

Sizes: H = 24, W = 37 (odd), B = 4, S = 3 but where said.
"""

import os
import signal
import time

import numpy as np
import pytest
import torch

from dips_tpu_torch import (DiPsEngine, DiPsProperties, MultiStreamEngine,
                            OutputMode, native)
from dips_tpu_torch.utils import staging
from dips_tpu_torch.utils.profiling import StageTimers
from dips_tpu_torch.utils.staging import Staging, TailSlots

H, W, B, S = 24, 37, 4, 3
PROPS = {"colorize": DiPsProperties(),
         "absdiff": DiPsProperties(output=OutputMode.ABSDIFF)}
needs_native = pytest.mark.skipif(
    not native.NATIVE_AVAILABLE, reason="the framepump module did not load")


def clip(seed: int, n: int, h=H, w=W):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), np.uint8) for _ in range(n)]


@pytest.fixture
def pool(monkeypatch):
    """``pool(True)``: every staging call with bytes to copy takes the
    thread pool; ``pool(False)``: none does."""
    def force(on: bool):
        monkeypatch.setattr(staging, "POOL_ABOVE", -1 if on else 1 << 62)
    return force


def copied(pieces, on: bool, monkeypatch) -> bool:
    monkeypatch.setattr(staging, "POOL_ABOVE", -1 if on else 1 << 62)
    return Staging().copy(pieces)


# -- the copier --------------------------------------------------------------
@needs_native
@pytest.mark.parametrize("shape,chunk", [
    ((H, W, 3), 1000),            # odd width; chunks end inside rows
    ((1, 1, 3), 1),               # a frame of three bytes, byte chunks
    ((2160, 3840, 3), 3 << 20),   # 4K; a chunk is not a whole number of rows
    ((1080, 1920, 3), 1 << 20),
])
@pytest.mark.parametrize("n", [1, 5])
def test_copier_equals_numpy(monkeypatch, shape, chunk, n):
    monkeypatch.setattr(staging, "CHUNK_BYTES", chunk)
    rng = np.random.default_rng(n)
    src = [rng.integers(0, 256, shape, np.uint8) for _ in range(n)]
    want = [s.copy() for s in src]
    got = [np.zeros(shape, np.uint8) for _ in range(n)]
    assert copied(list(zip(got, src)), True, monkeypatch)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@needs_native
def test_copier_pieces_of_any_size_into_one_buffer(monkeypatch):
    """Pieces of odd sizes into neighbouring rows of one buffer, zero-size
    pieces among them: every byte lands once, none outside."""
    monkeypatch.setattr(staging, "CHUNK_BYTES", 7)
    buf = np.full((6, 11, 13, 3), 0xAA, np.uint8)
    src = clip(3, 6, 11, 13)
    pieces = [(buf[i], src[i]) for i in (0, 2, 3, 5)]
    pieces.append((buf[1, :0], src[1][:0]))  # an empty piece
    assert copied(pieces, True, monkeypatch)
    for i in (0, 2, 3, 5):
        np.testing.assert_array_equal(buf[i], src[i])
    assert (buf[[1, 4]] == 0xAA).all()


def test_non_contiguous_and_other_dtypes_go_through_numpy(monkeypatch):
    """A non-contiguous source, one of another dtype and one that shares
    the destination's memory are copied by NumPy, with its casting: the
    bytes are what ``dst[...] = src`` gives."""
    base = clip(4, 1, H, 2 * W)[0]
    flipped = base[:, ::-1][:, :W]          # negative strides
    crop = base[:, 5:5 + W]                 # a strided view
    wide = base[:, :W].astype(np.int64)     # another dtype
    buf = np.zeros((4, H, W, 3), np.uint8)
    overlap = buf[0]                        # the destination itself
    buf[0] = clip(5, 1)[0]
    want = buf[0].copy()
    pieces = [(buf[0], overlap), (buf[1], flipped), (buf[2], crop),
              (buf[3], wide)]
    assert not copied(pieces, True, monkeypatch)  # nothing left to pool
    np.testing.assert_array_equal(buf[0], want)
    np.testing.assert_array_equal(buf[1], flipped)
    np.testing.assert_array_equal(buf[2], crop)
    np.testing.assert_array_equal(buf[3], wide.astype(np.uint8))


def test_bad_pieces_raise():
    with pytest.raises(ValueError, match="source"):
        Staging().copy([(np.zeros((2, 3), np.uint8),
                         np.zeros((3, 2), np.uint8))])
    with pytest.raises(ValueError, match="destination"):
        Staging().copy([(np.zeros((3, 4), np.uint8)[:, ::2],
                         np.zeros((3, 2), np.uint8))])
    with pytest.raises(ValueError, match="destination"):
        Staging().copy([(np.zeros((2,), np.float32),
                         np.zeros((2,), np.uint8))])


@needs_native
def test_crossover_both_sides(monkeypatch):
    """A call takes the pool only when its contiguous bytes exceed
    ``POOL_ABOVE``; the bytes are the same on both sides."""
    src = clip(6, 4)
    nbytes = sum(f.nbytes for f in src)
    for above, pooled in ((nbytes - 1, True), (nbytes, False)):
        monkeypatch.setattr(staging, "POOL_ABOVE", above)
        dst = np.zeros((4, H, W, 3), np.uint8)
        st = Staging()
        assert st.copy(list(zip(dst, src)), count=True) is pooled
        np.testing.assert_array_equal(dst, np.stack(src))
        assert (st.batches, st.nbytes, st.pooled) == (1, nbytes, pooled)
        assert st.threads == (staging.pool_threads() if pooled else 1)


def test_numpy_fallback_without_the_native_module(monkeypatch):
    monkeypatch.setattr(native, "NATIVE_AVAILABLE", False)
    monkeypatch.setattr(staging, "POOL_ABOVE", -1)
    src = clip(7, 3)
    dst = np.zeros((3, H, W, 3), np.uint8)
    st = Staging()
    assert st.copy(list(zip(dst, src)), count=True) is False
    np.testing.assert_array_equal(dst, np.stack(src))
    assert (st.pooled, st.threads, st.pooled_share) == (0, 1, 0.0)


@needs_native
@pytest.mark.skipif(not hasattr(os, "fork"), reason="no os.fork here")
def test_a_forked_child_builds_its_own_pool(monkeypatch):
    """The parent's pool exists before the fork; the child's copies on a
    pool of its own and exits 0 with the right bytes, well inside its
    time limit."""
    monkeypatch.setattr(staging, "POOL_ABOVE", -1)
    monkeypatch.setattr(staging, "CHUNK_BYTES", 4096)
    src = clip(8, 6, 64, 96)
    dst = np.zeros((6, 64, 96, 3), np.uint8)
    assert Staging().copy(list(zip(dst, src)))
    pid = os.fork()
    if pid == 0:  # the child: numpy and the native module only
        code = 1
        try:
            out = np.zeros_like(dst)
            st = Staging()
            if st.copy(list(zip(out, src)), count=True) and \
                    np.array_equal(out, np.stack(src)) and st.threads > 1:
                code = 0
        finally:
            os._exit(code)
    deadline = time.monotonic() + 60
    status = None
    while time.monotonic() < deadline:
        done, status = os.waitpid(pid, os.WNOHANG)
        if done:
            break
        time.sleep(0.02)
    else:
        os.kill(pid, signal.SIGKILL)
        os.waitpid(pid, 0)
        pytest.fail("the forked child's staging hung")
    assert os.WIFEXITED(status) and os.WEXITSTATUS(status) == 0
    # the parent's pool still works after the fork
    dst[:] = 0
    assert Staging().copy(list(zip(dst, src)))
    np.testing.assert_array_equal(dst, np.stack(src))


# -- the tail slots -----------------------------------------------------------
@pytest.mark.parametrize("t", [1, 3, 4])
def test_tail_slots_reuse_and_keep(t):
    """Uneven batches: the tail is always the last T frames fed (T copies
    of the first before), each entry a view of the T slots, which are
    allocated once; a batch's copies never hit a slot the kept part of
    the tail holds."""
    slots = TailSlots(t)
    fed, tail = [], None
    rng = np.random.default_rng(t)
    for k, n in enumerate((1, 2, 5, 1, 3, 4, 1, 1, 2)):
        frames = [rng.integers(0, 256, (5, 7, 3), np.uint8) for _ in range(n)]
        survivors = None if tail is None else [f.copy() for f in tail]
        new, copies = slots.keep(tail, frames)
        for slot, f in copies:
            slot[...] = f
        fed = ([frames[0]] * t if not fed else fed) + frames
        want = fed[-t:]
        assert len(new) == t
        for got, exp in zip(new, want):
            np.testing.assert_array_equal(got, exp)
            assert got.base is slots._slots
            assert not any(np.shares_memory(got, f) for f in frames)
        if survivors is not None:  # the kept old frames are untouched
            kept = t - min(n, t)
            for got, exp in zip(new[:kept], survivors[len(survivors)
                                                      - kept:]):
                np.testing.assert_array_equal(got, exp)
        tail = new
    assert len(copies) <= t


def test_tail_slots_load_copies():
    slots = TailSlots(4)
    planar = [np.full((3, 8, 8), v, np.uint8) for v in (1, 2, 3)]
    tail = slots.load([planar[0]] + planar)  # a short tail, replicated
    assert [int(f[0, 0, 0]) for f in tail] == [1, 1, 2, 3]
    assert tail[0] is tail[1]  # the replica takes one slot
    for f in planar:
        f[:] = 99
    assert [int(f[0, 0, 0]) for f in tail] == [1, 1, 2, 3]


# -- the engines ------------------------------------------------------------
def engine(props="colorize", **kw):
    return DiPsEngine(PROPS[props], H, W, batch=B, device="cpu", **kw)


def fleet(props="colorize", **kw):
    return MultiStreamEngine(PROPS[props], H, W, S, batch=B, device="cpu",
                             **kw)


def assert_states_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        if key in ("tail", "tails"):
            tails_a = a[key] if key == "tails" else [a[key]]
            tails_b = b[key] if key == "tails" else [b[key]]
            assert len(tails_a) == len(tails_b)
            for x, y in zip(tails_a, tails_b):
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_array_equal(x, y)
        elif isinstance(a[key], np.ndarray):
            np.testing.assert_array_equal(a[key], b[key])
        else:
            assert a[key] == b[key]


def run_engine(props, ring, layout, on, pool):
    pool(on)
    eng = engine(props, ring_carry=ring, input_layout=layout)
    got = []
    for k, n in enumerate((B, 2, B, 1, 3)):  # partial batches
        got.append(eng.process_batch(clip(10 + k, n)))
    return got, eng.heatmap(), eng.state_dict()


@needs_native
@pytest.mark.parametrize("layout", ["hwc", "hwc_bgr"])
@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("props", sorted(PROPS))
def test_engine_byte_equal_pool_on_and_off(pool, props, ring, layout):
    off = run_engine(props, ring, layout, False, pool)
    on = run_engine(props, ring, layout, True, pool)
    for (oa, sa), (ob, sb) in zip(off[0], on[0]):
        np.testing.assert_array_equal(oa, ob)
        np.testing.assert_array_equal(sa, sb)
    np.testing.assert_array_equal(off[1], on[1])
    assert_states_equal(off[2], on[2])


def run_fleet(props, ring, layout, on, pool):
    """Streams fresh, quiet, dead (a wrong-shape frame) and reset."""
    pool(on)
    f = fleet(props, ring_carry=ring, input_layout=layout)
    feeds = [
        [clip(1, B), clip(2, 2), []],                   # stream 2 fresh later
        [clip(3, 1), [], clip(4, B)],                   # stream 1 quiet
        [clip(5, 3), clip(6, 1, H + 1), clip(7, 2)],    # stream 1 dies
        [clip(8, B), [], clip(9, B)],
    ]
    got = []
    for k, feed in enumerate(feeds):
        if k == 3:
            f.reset_stream(1)  # fresh again
            feed = [feed[0], clip(10, 2), feed[2]]
        got.append(f.process_batch(feed))
    assert sorted(f.failed) == []
    return got, f.heatmaps(), f.state_dict()


@needs_native
@pytest.mark.parametrize("layout", ["hwc", "hwc_bgr", "planar"])
@pytest.mark.parametrize("ring", [True, False])
def test_fleet_byte_equal_pool_on_and_off(pool, ring, layout):
    off = run_fleet("colorize", ring, layout, False, pool)
    on = run_fleet("colorize", ring, layout, True, pool)
    for a, b in zip(off[0], on[0]):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]
    np.testing.assert_array_equal(off[1], on[1])
    assert_states_equal(off[2], on[2])


@pytest.mark.parametrize("layout", ["hwc", "planar"])
@pytest.mark.parametrize("ring", [True, False])
def test_tail_views_nothing_the_caller_holds(ring, layout):
    """After ``process_batch`` and ``process_buffer``, writing into the
    caller's frames, the buffer it filled and the next upload buffer
    leaves the engine's tail as it was; writing into a ``state_dict``'s
    tail leaves the next one as it was."""
    eng = engine(ring_carry=ring, input_layout=layout)
    frames = clip(20, B)
    eng.process_batch(frames)
    want = eng.state_dict()["tail"].copy()
    for f in frames:
        f[:] = 7
    eng.new_batch_buffer()[:] = 9
    np.testing.assert_array_equal(eng.state_dict()["tail"], want)
    eng.state_dict()["tail"][:] = 5
    np.testing.assert_array_equal(eng.state_dict()["tail"], want)
    if layout == "planar":
        return
    buf = eng.new_batch_buffer()
    buf[:2] = np.stack(clip(21, 2))
    eng.process_buffer(buf, 2)
    want = eng.state_dict()["tail"].copy()
    buf[:] = 3
    eng.new_batch_buffer()[:] = 4
    np.testing.assert_array_equal(eng.state_dict()["tail"], want)


def test_fleet_tail_views_nothing_the_caller_holds():
    f = fleet()
    feeds = [clip(30 + si, B) for si in range(S)]
    f.process_batch(feeds)
    want = f.state_dict()["tails"]
    for frames in feeds:
        for x in frames:
            x[:] = 7
    f._host_np[:] = 9
    for got, exp in zip(f.state_dict()["tails"], want):
        np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("layout", ["hwc", "planar"])
@pytest.mark.parametrize("ring", [True, False])
def test_save_load_resume_byte_equal(tmp_path, ring, layout):
    """One engine runs on; another loads its checkpoint (a file, then a
    state dict whose arrays the caller overwrites after the load) and
    goes on byte-equal."""
    ref = engine(ring_carry=ring, input_layout=layout)
    for k, n in enumerate((B, 3)):
        ref.process_batch(clip(40 + k, n))
    path = str(tmp_path / "ck.npz")
    ref.save(path)
    state = ref.state_dict()
    from_file, from_dict = (engine(ring_carry=ring, input_layout=layout)
                            for _ in range(2))
    from_file.load(path)
    from_dict.load_state_dict(state)
    state["tail"][:] = 0  # the engine holds copies
    for k, n in enumerate((2, B, 1, B)):
        frames = clip(50 + k, n)
        want = ref.process_batch(frames)
        for eng in (from_file, from_dict):
            got = eng.process_batch(frames)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    for eng in (from_file, from_dict):
        assert_states_equal(eng.state_dict(), ref.state_dict())


@pytest.mark.parametrize("ring", [True, False])
def test_fleet_save_load_resume_byte_equal(tmp_path, ring):
    ref = fleet(ring_carry=ring)
    ref.process_batch([clip(60, B), clip(61, 2), []])
    path = str(tmp_path / "fleet.npz")
    ref.save(path)
    slot = ref.stream_state_dict(1)
    other = fleet(ring_carry=ring)
    other.load(path)
    single = fleet(ring_carry=ring)
    single.load_stream_state(1, slot)
    slot["tail"][:] = 0
    for k in range(3):
        feeds = [clip(70 + k, B), clip(80 + k, 3), clip(90 + k, 1)]
        want = ref.process_batch(feeds)
        got = other.process_batch(feeds)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(
            single.process_batch(feeds)[0][1], want[0][1])
    assert_states_equal(other.state_dict(), ref.state_dict())


# -- the counts --------------------------------------------------------------
def test_counts_only_while_timed():
    eng, f = engine(), fleet()
    for k in range(2):
        eng.process_batch(clip(k, B))
        f.process_batch([clip(k, B)] * S)
    assert (eng.staging.batches, f.staging.batches) == (0, 0)
    assert eng.staging.pooled_share is None
    eng.timers, f.timers = StageTimers(), StageTimers()
    eng.process_batch(clip(3, B))
    f.process_batch([clip(3, B)] * S)
    nbytes = H * W * 3
    # the B frames and the T = 4 tail frames; the fleet's per stream
    assert (eng.staging.batches, eng.staging.nbytes) == (1, 8 * nbytes)
    assert (f.staging.batches, f.staging.nbytes) == (1, 8 * nbytes * S)
    assert eng.staging.gbps(eng.timers) > 0
    assert "staging: 1 batches" in str(eng.staging)


@needs_native
def test_pooled_share_by_size():
    """The real crossover: a 1080p x 16 batch's staging copy takes the
    pool (the engine's own pieces, staged without a launch), one
    64 x 64 frame does not."""
    big = DiPsEngine(PROPS["absdiff"], 1080, 1920, batch=16, device="cpu")
    big.timers = StageTimers()
    frames = clip(90, 16, 1080, 1920)
    buf, tail = big._stage_frames(frames)
    np.testing.assert_array_equal(buf, np.stack(frames))
    np.testing.assert_array_equal(np.stack(tail), np.stack(frames[-4:]))
    assert big.staging.pooled_share == 1.0
    assert big.staging.threads == staging.pool_threads()
    del big, buf, tail, frames
    small = DiPsEngine(PROPS["colorize"], 64, 64, batch=1, device="cpu")
    small.timers = StageTimers()
    small.process_batch(clip(91, 1, 64, 64))
    assert small.staging.pooled_share == 0.0


# -- on the card -------------------------------------------------------------
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("props", sorted(PROPS))
def test_card_engine_1080p_byte_equal_and_faster(pool, props):
    dev = card()
    frames = [clip(100 + k, 16, 1080, 1920) for k in range(2)]
    got, stage_in = {}, {}
    for on in (False, True, True, False):
        pool(on)
        eng = DiPsEngine(PROPS[props], 1080, 1920, batch=16, device=dev)
        eng.process_batch(frames[0])  # warm-up: slots and pages faulted
        eng.timers = StageTimers()
        outs = [eng.process_batch(frames[k % 2]) for k in range(6)]
        stage_in.setdefault(on, []).append(
            eng.timers.totals["stage_in"] / 6)
        if on:
            assert eng.staging.pooled_share == 1.0
        res = [(o.copy(), s.copy()) for o, s in outs] + [
            eng.heatmap(), eng.state_dict()]
        if on in got:
            continue
        got[on] = res
        del eng, outs
    for a, b in zip(got[False][:6], got[True][:6]):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(got[False][6], got[True][6])
    assert_states_equal(got[False][7], got[True][7])
    # generous: the pool's stage_in under 0.8 x the serial one
    assert max(stage_in[True]) < 0.8 * min(stage_in[False]), stage_in


@pytest.mark.gpu
def test_card_fleet_1080p_byte_equal(pool):
    dev = card()
    feeds = [[clip(200 + 10 * k + si, 16, 1080, 1920)[:16 - si]
              for si in range(8)] for k in range(2)]
    got = {}
    for on in (False, True):
        pool(on)
        f = MultiStreamEngine(PROPS["absdiff"], 1080, 1920, 8, batch=16,
                              device=dev)
        f.timers = StageTimers()
        outs = [f.process_batch(feeds[k % 2]) for k in range(3)]
        assert f.staging.pooled_share == (1.0 if on else 0.0)
        got[on] = [(o.copy(), s.copy(), g) for o, s, g in outs] + [
            f.heatmaps(), f.state_dict()]
        del f, outs
    for a, b in zip(got[False][:3], got[True][:3]):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]
    np.testing.assert_array_equal(got[False][3], got[True][3])
    assert_states_equal(got[False][4], got[True][4])


def test_cli_profile_prints_the_staging_record(tmp_path, capsys):
    """``--profile`` on a file run (``stream_dips``: the tail's copies out
    of the batch buffer) prints the record: every batch counted."""
    cv2 = pytest.importorskip("cv2")
    from dips_tpu_torch import cli
    src = str(tmp_path / "in.avi")
    vw = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"HFYU"), 10, (W, H))
    for f in clip(110, 9):
        vw.write(f)
    vw.release()
    assert cli.main(["--input", src, "--output", str(tmp_path / "o.avi"),
                     "--batch", str(B), "--device", "cpu",
                     "--profile"]) == 0
    out = capsys.readouterr().out
    (line,) = [ln for ln in out.splitlines() if ln.startswith("staging:")]
    assert line.startswith("staging: 3 batches, ")
    assert "GB/s" in line
