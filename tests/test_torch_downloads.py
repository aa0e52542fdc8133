"""The engines' downloads (``utils/downloads.py``): each batch's maps and
stats belong to the caller, on the CPU and on the card.

* The ownership contract: batch k's maps and stats are still bit-equal to
  a copy taken when they were returned after three more batches, through
  ``DiPsEngine.process_batch``, ``dispatch_async`` + ``collect`` and
  ``MultiStreamEngine.process_batch`` (a ring of result buffers reused
  from batch to batch fails it).
* A coalesced serving session's results are arrays of its own, which
  later batches leave as they were.
* ``process_frames`` equals the batch-by-batch results; on the CPU the
  downloads are the tensors' own views and count nothing.
* Marked ``gpu`` (they skip without a card; no JAX here, so they run with
  ``--noconftest``): the maps are views of page-locked memory, a loop
  that holds one earlier batch page-locks at most two new blocks after
  warm-up, ``process_frames`` and a coalesced session hold one batch's
  download at a time, and without stage timers nothing is counted.

Sizes: H = 40, W = 72, B = 4, S = 3.
"""

import numpy as np
import pytest
import torch

from dips_tpu_torch import (DiPsEngine, DiPsProperties, MultiStreamEngine,
                            OutputMode)
from dips_tpu_torch.serve.coalesce import StreamCoalescer, _CoalescedSession
from dips_tpu_torch.utils.downloads import Downloads
from dips_tpu_torch.utils.profiling import StageTimers

H, W, B, S = 40, 72, 4, 3
PROPS = {"colorize": DiPsProperties(),
         "absdiff": DiPsProperties(output=OutputMode.ABSDIFF),
         "threshold": DiPsProperties(output=OutputMode.THRESHOLD),
         "stats_only": DiPsProperties(emit_maps=False)}
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)]


def device_of(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device(name)


def frames(seed: int, n: int, h=H, w=W):
    """Seeded (H, W, 3) u8 frames: a square moving over noise, so every
    batch's maps differ from the last one's."""
    rng = np.random.default_rng(seed)
    bg = rng.integers(0, 256, (h, w, 3), np.uint8)
    out = []
    for i in range(n):
        f = bg.copy()
        y, x = (3 * i) % (h - 8), (5 * i) % (w - 8)
        f[y:y + 8, x:x + 8] = (250, 30, 30)
        out.append(f)
    return out


def single(props, dev, **kw):
    eng = DiPsEngine(props, H, W, batch=B, device=dev, **kw)
    eng.timers = StageTimers()  # the downloads are counted
    return eng


def fleet(props, dev, **kw):
    eng = MultiStreamEngine(props, H, W, S, batch=B, device=dev, **kw)
    eng.timers = StageTimers()
    return eng


@pytest.fixture
def coalesced():
    """``make(props, device)``: a session on one slot of a coalescer of S
    slots, its downloads counted; every coalescer made is shut down."""
    made = []

    def make(props, dev):
        co = StreamCoalescer(props, H, W, S, batch=B, device=dev)
        made.append(co)
        co.engine.timers = StageTimers()
        return _CoalescedSession(co, co.bind())

    yield make
    for co in made:
        co.shutdown()


def run_single(eng, k):
    return eng.process_batch(frames(k, B))


def filled(eng, seed):
    """A batch buffer of ``eng`` holding B frames of ``seed``."""
    buf = eng.new_batch_buffer()
    for i, f in enumerate(frames(seed, B)):
        buf[i] = f
    return buf


def run_async(eng, k):
    return eng.collect(eng.dispatch_async(filled(eng, k), B))


def run_fleet(eng, k):
    maps, stats, _ = eng.process_batch(
        [frames(10 * k + si, B) for si in range(S)])
    return maps, stats


PATHS = {"process_batch": (single, run_single),
         "dispatch_collect": (single, run_async),
         "fleet": (fleet, run_fleet)}


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("pipeline", ["colorize", "absdiff"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_results_outlive_later_batches(path, pipeline, device):
    make, run = PATHS[path]
    eng = make(PROPS[pipeline], device_of(device))
    held = []
    for k in range(4):
        maps, stats = run(eng, k)
        held.append((maps, stats, maps.copy(), stats.copy()))
    assert not np.array_equal(held[0][2], held[1][2])  # batches differ
    for k, (maps, stats, maps0, stats0) in enumerate(held):
        np.testing.assert_array_equal(maps, maps0, err_msg=f"batch {k}")
        np.testing.assert_array_equal(stats, stats0, err_msg=f"batch {k}")


@pytest.mark.parametrize("device", DEVICES)
def test_coalesced_results_are_the_sessions_own(coalesced, device):
    sess = coalesced(PROPS["colorize"], device_of(device))
    held = []
    for k in range(4):
        maps, stats = sess.process_frames(frames(k, B + 1))
        assert maps.base is None and stats.base is None
        held.append((maps, stats, maps.copy(), stats.copy()))
    assert not np.array_equal(held[0][2], held[1][2])
    for k, (maps, stats, maps0, stats0) in enumerate(held):
        np.testing.assert_array_equal(maps, maps0, err_msg=f"batch {k}")
        np.testing.assert_array_equal(stats, stats0, err_msg=f"batch {k}")


@pytest.mark.parametrize("n", [2 * B, 2 * B + 3])
@pytest.mark.parametrize("packed", [False, True])
def test_process_frames_equals_batch_by_batch(n, packed):
    props = PROPS["threshold"]
    clip = frames(7, n)
    got = single(props, "cpu", packed_wire=True).process_frames(
        clip, packed=packed)
    eng = single(props, "cpu", packed_wire=True)
    parts = [eng.process_batch(clip[i:i + B], packed=packed)
             for i in range(0, n, B)]
    np.testing.assert_array_equal(got[0],
                                  np.concatenate([o for o, _ in parts]))
    np.testing.assert_array_equal(got[1],
                                  np.concatenate([s for _, s in parts]))


@pytest.mark.parametrize("pipeline", sorted(PROPS))
def test_cpu_downloads_are_the_tensors_own_and_count_nothing(pipeline):
    props = PROPS[pipeline]
    eng = single(props, "cpu")
    out, stats, n = eng.dispatch_async(filled(eng, 5), B)
    maps_np, stats_np = eng.collect((out, stats, n))
    assert np.shares_memory(stats_np, stats.numpy())
    if props.out_channels:
        assert np.shares_memory(maps_np, out.numpy())
    else:
        assert maps_np.shape == (B, H, W, 0)
    d = eng.downloads
    assert (d.batches, d.nbytes, d.new_blocks, d.reuse_share) == (
        0, 0, 0, None)


def test_reuse_share_counts_batches_that_page_locked_nothing():
    d = Downloads(torch.device("cpu"))
    d.batches, d.new_blocks = 40, 2
    assert d.reuse_share == pytest.approx(0.95)


# -- on the card -------------------------------------------------------------

def _empty_host_cache():
    """Free the caching host allocator's cached blocks, so what a test
    counts is page-locked by that test."""
    torch.cuda.synchronize()
    torch._C._host_emptyCache()


def _host_allocs():
    return torch.cuda.host_memory_stats()["num_host_alloc"]


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(PATHS))
def test_results_are_views_of_page_locked_memory(path):
    make, run = PATHS[path]
    eng = make(PROPS["absdiff"], device_of("cuda"))
    maps, stats = run(eng, 0)
    assert isinstance(maps.base, torch.Tensor) and maps.base.is_pinned()
    # the stats, under a page, are copied out of their block
    assert stats.base is None
    d = eng.downloads
    assert d.batches == 1 and d.nbytes == maps.nbytes + stats.nbytes


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(PATHS))
def test_a_loop_that_holds_a_batch_page_locks_at_most_two_blocks(path):
    make, run = PATHS[path]
    eng = make(PROPS["colorize"], device_of("cuda"))
    _empty_host_cache()
    run(eng, 0)  # warm-up: its blocks go back to the pool
    new0, alloc0 = eng.downloads.new_blocks, _host_allocs()
    # hold batch 1 and the last batch, as the benchmark's closed loop
    # holds a sample batch and the last one
    first = run(eng, 1)
    last = None
    for k in range(2, 11):
        last = run(eng, k)
    d = eng.downloads
    assert d.batches == 11 and first is not last
    assert d.new_blocks - new0 <= 2
    # the maps' blocks: the stats' block goes back at every return
    assert _host_allocs() - alloc0 <= 2


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
def test_process_frames_holds_one_download_at_a_time(packed):
    eng = single(PROPS["threshold"], device_of("cuda"), packed_wire=True)
    clip = frames(3, 8 * B)
    _empty_host_cache()
    eng.process_batch(clip[:B], packed=packed)  # warm-up
    eng.reset()
    new0 = eng.downloads.new_blocks
    got = eng.process_frames(clip, packed=packed)
    assert eng.downloads.batches == 9
    assert eng.downloads.new_blocks == new0  # the warm-up's blocks serve
    assert not isinstance(got[0].base, torch.Tensor)  # the caller's array
    exp = single(PROPS["threshold"], "cpu", packed_wire=True).process_frames(
        clip, packed=packed)
    np.testing.assert_array_equal(got[0], exp[0])


@pytest.mark.gpu
def test_a_coalesced_session_holds_one_download_at_a_time(coalesced):
    sess = coalesced(PROPS["absdiff"], device_of("cuda"))
    clip = frames(3, 8 * B)
    _empty_host_cache()
    sess.process_frames(clip[:B])  # warm-up
    sess.reset()
    d = sess._co.engine.downloads
    new0 = d.new_blocks
    got = sess.process_frames(clip)
    assert d.batches == 9
    assert d.new_blocks == new0  # the warm-up's block serves every batch
    assert got[0].base is None
    cpu = StreamCoalescer(PROPS["absdiff"], H, W, S, batch=B, device="cpu")
    try:
        exp = _CoalescedSession(cpu, cpu.bind()).process_frames(clip)
    finally:
        cpu.shutdown()
    np.testing.assert_array_equal(got[0], exp[0])


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(PATHS))
def test_without_timers_the_downloads_count_nothing(path):
    make, run = PATHS[path]
    eng = make(PROPS["absdiff"], device_of("cuda"))
    eng.timers = None
    maps, _ = run(eng, 0)
    assert maps.base.is_pinned()
    d = eng.downloads
    assert (d.batches, d.nbytes, d.new_blocks, d.reuse_share) == (
        0, 0, 0, None)
