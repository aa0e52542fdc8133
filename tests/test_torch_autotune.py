"""The port's tuning slice on the CPU: the tuning store
(``ops/tuning.py``), the tuner's search and choice (``autotune.py``, with
the measurement faked: the real probes need a card), the geometry pickers
of ``ops/cuda_fused.py``, the geometry as a build parameter
(``ops/_build.py``), the kernel build cache (``utils/compilecache.py``,
``--compile-cache`` on every entry point) and the doctor's two sections.
The JAX package's counterparts are the reference where one carries over
(``find_largest_fitting``, ``_bh_candidates``, ``add_compile_cache_flag``).
"""

import argparse
import inspect
import json
import os
import sys

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import dips_tpu.autotune as jautotune
import dips_tpu.ops.tuning as jtuning
import dips_tpu.utils.compilecache as jcc
from dips_tpu_torch import autotune
from dips_tpu_torch.ops import _build, cuda_fused, tuning
from dips_tpu_torch.ops._build import Geometry, MedianTile, RawBlock
from dips_tpu_torch.properties import DiPsProperties, OutputMode
from dips_tpu_torch.utils import compilecache

CARD = "NVIDIA H100 80GB HBM3"
#: the opt-in shared memory of a block on an H100
H100_SMEM = 232448
T24 = MedianTile(24, 2, 2)
B512 = RawBlock(512, 32)


@pytest.fixture(autouse=True)
def restore_build_root(monkeypatch):
    """Every test leaves ``_build.BUILD_ROOT`` as it found it."""
    monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT)
    monkeypatch.delenv("DIPS_COMPILE_CACHE", raising=False)


@pytest.fixture()
def cache(tmp_path, monkeypatch):
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv("DIPS_TPU_TORCH_AUTOTUNE_CACHE", path)
    tuning.invalidate()
    yield path
    tuning.invalidate()


@pytest.fixture()
def card(cache, monkeypatch):
    """A card named CARD with an H100's shared memory, for the pickers."""
    monkeypatch.setattr(tuning, "_device_kind", lambda device=None: CARD)
    monkeypatch.setattr(cuda_fused, "_smem_limit", lambda device: H100_SMEM)
    return torch.device("cpu")


# -- the tuning store ---------------------------------------------------------

def test_store_roundtrip(cache):
    tuning.save(CARD, ring_tiles={3: T24, 7: {"rows": 16, "px": 4,
                                              "stages": 3}},
                raw_block=B512, meta={"tool": "test"})
    assert tuning.ring_tile(3, CARD) == T24
    assert tuning.ring_tile(7, CARD) == MedianTile(16, 4, 3)
    assert tuning.ring_tile(5, CARD) is None
    assert tuning.raw_block(CARD) == B512
    assert tuning.ring_tile(3, "other card") is None
    # partial updates merge; a window measured again is replaced
    tuning.save(CARD, ring_tiles={5: MedianTile(8, 2, 4)})
    assert tuning.ring_tile(3, CARD) == T24
    assert tuning.ring_tile(5, CARD) == MedianTile(8, 2, 4)
    tuning.save(CARD, ring_tiles={3: MedianTile()})
    assert tuning.ring_tile(3, CARD) == MedianTile()
    assert tuning.raw_block(CARD) == B512
    with open(cache) as f:
        entry = json.load(f)[CARD]
    assert entry["meta"] == {"tool": "test"}
    assert entry["ring_tiles"]["7"] == {"rows": 16, "px": 4, "stages": 3}


def test_store_stacked_and_tail_keys(cache):
    tuning.save(CARD, ring_tiles={3: T24}, tail_tiles={3: MedianTile(16)},
                stacked_ring_tiles={3: MedianTile(8, 1, 2)},
                raw_block=RawBlock(128, 16), stacked_raw_block=B512)
    assert tuning.tail_tile(3, CARD) == MedianTile(16)
    assert tuning.stacked_ring_tile(3, CARD) == MedianTile(8, 1, 2)
    assert tuning.stacked_ring_tile(5, CARD) is None
    assert tuning.stacked_raw_block(CARD) == B512
    # the single-stream keys are untouched
    assert tuning.ring_tile(3, CARD) == T24
    assert tuning.raw_block(CARD) == RawBlock(128, 16)


def test_store_slab_keys(cache):
    tuning.save(CARD, slab_ring_tiles={3: {360: T24}})
    assert tuning.slab_ring_tile(3, 360, CARD) == T24
    assert tuning.slab_ring_tile(3, 272, CARD) is None
    assert tuning.slab_ring_tile(5, 360, CARD) is None
    tuning.save(CARD, slab_ring_tiles={3: {272: MedianTile(16)},
                                       5: {360: MedianTile(8, 2, 3)}})
    assert tuning.slab_ring_tile(3, 360, CARD) == T24  # kept
    assert tuning.slab_ring_tile(3, 272, CARD) == MedianTile(16)
    assert tuning.slab_ring_tile(5, 360, CARD) == MedianTile(8, 2, 3)


def test_store_stacked_slab_keys(cache):
    """The stacked-slab tiles ({window: {owned_hp: tile}}) round-trip and
    merge like the s = 1 slab tiles, apart from them."""
    tuning.save(CARD, stacked_slab_ring_tiles={3: {360: T24}},
                slab_ring_tiles={3: {360: MedianTile(16)}})
    assert tuning.stacked_slab_ring_tile(3, 360, CARD) == T24
    assert tuning.slab_ring_tile(3, 360, CARD) == MedianTile(16)
    assert tuning.stacked_slab_ring_tile(3, 272, CARD) is None
    assert tuning.stacked_slab_ring_tile(5, 360, CARD) is None
    assert tuning.stacked_slab_ring_tile(3, 360, "other card") is None
    tuning.save(CARD, stacked_slab_ring_tiles={3: {272: MedianTile(8, 1, 2)},
                                               7: {360: MedianTile()}})
    assert tuning.stacked_slab_ring_tile(3, 360, CARD) == T24  # kept
    assert tuning.stacked_slab_ring_tile(3, 272, CARD) == MedianTile(8, 1, 2)
    assert tuning.stacked_slab_ring_tile(7, 360, CARD) == MedianTile()
    assert tuning.slab_ring_tile(3, 360, CARD) == MedianTile(16)
    with open(cache) as f:
        entry = json.load(f)[CARD]
    assert entry["stacked_slab_ring_tiles"]["3"] == {
        "360": {"rows": 24, "px": 2, "stages": 2},
        "272": {"rows": 8, "px": 1, "stages": 2}}


@pytest.mark.parametrize("bad", [{"rows": 12, "px": 4, "stages": 3},
                                 [8, 4, 3], "24x64/s2", None])
def test_store_malformed_stacked_slab_tile_is_no_override(cache, bad):
    for tiles in ({"3": {"360": bad}}, {"3": [bad]}, [bad]):
        with open(cache, "w") as f:
            json.dump({CARD: {"stacked_slab_ring_tiles": tiles}}, f)
        tuning.invalidate()
        assert tuning.stacked_slab_ring_tile(3, 360, CARD) is None


def test_store_keywords_match_the_jax_store():
    """Every keyword of the JAX store's ``save`` has its counterpart in the
    port's: a cap of the VMEM edge there is a tile here, the raw target
    bytes a raw block.  The port adds the tail kernel's own tiles (the JAX
    caps cover both protocols' kernels)."""
    names = {"raw_target": "raw_block",
             "stacked_raw_target": "stacked_raw_block"}
    jax_kw = [k for k in inspect.signature(jtuning.save).parameters
              if k not in ("kind", "meta")]
    port_kw = [k for k in inspect.signature(tuning.save).parameters
               if k not in ("kind", "meta")]
    want = [names.get(k, k.replace("_caps", "_tiles")) for k in jax_kw]
    assert "stacked_slab_ring_caps" in jax_kw
    assert sorted(want + ["tail_tiles"]) == sorted(port_kw)
    assert sorted(tuning.TILE_KEYS + tuning.SLAB_KEYS) == sorted(
        k for k in port_kw if k.endswith("_tiles"))


def test_store_corrupt_file_is_ignored(cache):
    with open(cache, "w") as f:
        f.write("{not json")
    tuning.invalidate()
    assert tuning.ring_tile(3, CARD) is None
    tuning.save(CARD, ring_tiles={3: T24})  # and save still works
    assert tuning.ring_tile(3, CARD) == T24


@pytest.mark.parametrize("bad", [{"rows": 12, "px": 4, "stages": 3},
                                 {"rows": 8, "px": 3, "stages": 3},
                                 {"rows": 8, "px": 4, "stages": 0},
                                 {"rows": "8", "px": 4, "stages": 3},
                                 {"rows": 8}, [8, 4, 3], "8x128"])
def test_store_malformed_tile_is_no_override(cache, bad):
    with open(cache, "w") as f:
        json.dump({CARD: {"ring_tiles": {"3": bad},
                          "raw_block": {"threads": 100, "bytes": 16}}}, f)
    tuning.invalidate()
    assert tuning.ring_tile(3, CARD) is None
    assert tuning.raw_block(CARD) is None


def test_store_no_device_kind_means_no_override(cache):
    """Without a card (this CPU run) the store never activates."""
    tuning.save(CARD, ring_tiles={3: T24}, raw_block=B512)
    assert tuning._device_kind() is None
    assert tuning.ring_tile(3) is None and tuning.raw_block() is None
    assert tuning.device_entry() == {}


def test_store_path_is_apart_from_the_jax_store(tmp_path, monkeypatch):
    from dips_tpu.ops import tuning as jtuning
    monkeypatch.delenv("DIPS_TPU_TORCH_AUTOTUNE_CACHE", raising=False)
    monkeypatch.setenv("DIPS_TPU_AUTOTUNE_CACHE", str(tmp_path / "j.json"))
    assert tuning.cache_path() == os.path.expanduser(
        "~/.cache/dips_tpu_torch/autotune.json")
    assert tuning.cache_path() != jtuning.cache_path()
    monkeypatch.setenv("DIPS_TPU_TORCH_AUTOTUNE_CACHE", "/x/y.json")
    assert tuning.cache_path() == "/x/y.json"


# -- the search, against the JAX tuner's where it carries over ---------------

@pytest.mark.parametrize("cands,prior,edge", [
    ([8, 16, 24, 32, 40, 48], 24, 24), ([8, 16, 24, 32, 40, 48], 48, 16),
    ([8, 16, 24, 32, 40, 48], 8, 99), ([8, 16, 24, 32, 40, 48], 24, 0),
    ([], 24, 99), ([8, 24, 40, 72], 30, 40)])
def test_find_largest_fitting_matches_jax(cands, prior, edge):
    calls = {"port": [], "jax": []}

    def fits(who):
        return lambda x: calls[who].append(x) or x <= edge

    got = autotune.find_largest_fitting(cands, prior, fits("port"))
    exp = jautotune.find_largest_fitting(cands, prior, fits("jax"))
    assert got == exp and calls["port"] == calls["jax"]


@pytest.mark.parametrize("hp", [8, 360, 1080, 2160, 4320])
def test_bh_candidates_match_jax(hp):
    assert autotune._bh_candidates(hp) == jautotune._bh_candidates(hp)


def test_tile_candidates_at_1080p():
    """At 1080p the rows are 8 and 24 (1080 = 8 * 135), each with every
    (px, stages); at T = 4 all fit an H100's shared memory."""
    cands = autotune.tile_candidates(1080, 3, 4, H100_SMEM)
    assert sorted({c.rows for c in cands}) == [8, 24]
    assert len(cands) == 2 * len(autotune.TILE_PX) * len(
        autotune.TILE_STAGES)
    assert MedianTile() in cands and T24 in cands


def test_tile_candidates_drop_what_cannot_launch():
    """At T = 16 a 24-row tile of 4 pixels a thread needs more shared
    memory than a block may use: dropped before it is built."""
    big = MedianTile(24, 4, 4)
    assert big.smem_bytes(3, autotune.EXACT, 16) > H100_SMEM
    cands = autotune.tile_candidates(1080, 3, 16, H100_SMEM)
    assert big not in cands and MedianTile() in cands
    assert all(c.smem_bytes(3, autotune.EXACT, 16) <= H100_SMEM
               for c in cands)
    assert MedianTile(24, 1, 4) in cands


def test_block_candidates():
    assert autotune.block_candidates(2048) == [
        RawBlock(th, by) for th in (128, 256, 512) for by in (16, 32)]
    assert autotune.block_candidates(272) == [
        RawBlock(th, 16) for th in (128, 256, 512)]


# -- probes with a fake measurement -------------------------------------------

def _fake_factory(times, bad=(), seen=None, noise=0.0, seed=0, calls=None):
    """A measure factory: seconds a launch from ``times`` (by name, else
    1.0), each time scaled by a uniform draw within +-``noise`` (a numpy
    generator from ``seed``); the geometries in ``bad`` disagree with the
    default; ``calls`` collects ("hold" | "time", name) in order."""
    rng = np.random.default_rng(seed)

    def factory(*args, **kw):
        if seen is not None:
            seen.append((args, kw))

        def hold(geometry):
            if calls is not None:
                calls.append(("hold", geometry.name()))
            if geometry in bad:
                raise autotune.GeometryMismatch(f"{geometry.name()}: maps")

        def time(geometry):
            if calls is not None:
                calls.append(("time", geometry.name()))
            return times.get(geometry.name(), 1.0) * (
                1 + rng.uniform(-noise, noise))
        hp, wp = 1080, 2048
        return hold, time, hp // kw.get("rows_ax", 1), wp
    return factory


def test_probe_tiles_picks_the_fastest_that_agrees():
    built = []
    res = autotune.probe_tiles(
        windows=(3,), b=16, limit=H100_SMEM,
        measure_factory=_fake_factory({"8x128/s3": 0.8, "24x64/s2": 0.5}),
        build=built.extend)
    assert res[3]["tile"] == T24
    assert res[3]["ms"] == pytest.approx(0.5e3 / 16)
    assert res[3]["default_ms"] == pytest.approx(0.8e3 / 16)
    assert len(res[3]["times"]) == 18
    # every candidate built for the ring kernel's window-3 unit alone
    assert {u for _, u in built} == {(("median_ring.cu", 3),)}


def test_probe_tiles_rejects_a_disagreeing_candidate():
    with pytest.raises(autotune.GeometryMismatch, match="24x64/s2"):
        autotune.probe_tiles(windows=(3,), limit=H100_SMEM,
                             measure_factory=_fake_factory({}, bad=(T24,)),
                             build=lambda specs: None)


def test_probe_keeps_the_default_within_two_percent():
    res = autotune.probe_tiles(
        windows=(3,), limit=H100_SMEM,
        measure_factory=_fake_factory({"8x128/s3": 0.50, "24x64/s2": 0.495}),
        build=lambda specs: None)
    assert res[3]["tile"] == MedianTile()
    times = {B512.name(): 0.9, "256x16": 1.0}
    assert autotune.probe_raw_block(
        measure_factory=_fake_factory(times),
        build=lambda specs: None)["block"] == B512
    times[B512.name()] = 0.99
    assert autotune.probe_raw_block(
        measure_factory=_fake_factory(times),
        build=lambda specs: None)["block"] == RawBlock()


def test_probe_tiles_clamps_windows_and_slabs_skip_window_1():
    seen = []
    res = autotune.probe_tiles(windows=(9, 4, 3), limit=H100_SMEM,
                               measure_factory=_fake_factory({}, seen=seen),
                               build=lambda specs: None)
    assert sorted(res) == [3, 7] and [a[0] for a, _ in seen] == [3, 7]
    seen.clear()
    res = autotune.probe_tiles(windows=(1, 3), rows_ax=3, tail=False,
                               limit=H100_SMEM,
                               measure_factory=_fake_factory({}, seen=seen),
                               build=lambda specs: None)
    assert sorted(res) == [3] and seen[0][1]["rows_ax"] == 3
    # 360 owned rows: 8, 24 (and 40, 72 above the 32-row cap)
    assert {t.split("x")[0] for t in res[3]["times"]} == {"8", "24"}


def test_probe_tail_and_stacked_reach_the_factory():
    seen = []
    autotune.probe_tiles(windows=(5,), s=4, tail=True, limit=H100_SMEM,
                         measure_factory=_fake_factory({}, seen=seen),
                         build=lambda specs: None)
    assert seen[0][1] == {"s": 4, "tail": True, "rows_ax": 1}


def test_noise_within_the_spread_keeps_the_default():
    """Equal means under +-5% noise: no candidate's slowest round can beat
    the default's fastest by 2%, so every seeded call keeps the default,
    where one estimate a candidate would have picked a tile most times."""
    for seed in range(40):
        res = autotune.probe_tiles(
            windows=(3,), limit=H100_SMEM, build=lambda specs: None,
            measure_factory=_fake_factory({}, noise=0.05, seed=seed))
        assert res[3]["tile"] == MedianTile()
        assert res[3]["margin"] < autotune.MIN_GAIN
        assert 0 < max(res[3]["spread"].values()) <= 0.1 / 0.95
        raw = autotune.probe_raw_block(
            build=lambda specs: None,
            measure_factory=_fake_factory({}, noise=0.05, seed=seed))
        assert raw["block"] == RawBlock()


def test_a_win_beyond_the_spread_is_chosen_every_time():
    """A 10% win under +-2% noise (its slowest round still beats the
    default's fastest by more than 2%) is chosen in every seeded call."""
    for seed in range(40):
        res = autotune.probe_tiles(
            windows=(3,), limit=H100_SMEM, build=lambda specs: None,
            measure_factory=_fake_factory({"24x64/s2": 0.9}, noise=0.02,
                                          seed=seed))
        assert res[3]["tile"] == T24 and res[3]["rival"] == T24
        assert res[3]["margin"] > autotune.MIN_GAIN
        raw = autotune.probe_raw_block(
            build=lambda specs: None,
            measure_factory=_fake_factory({"128x16": 0.9}, noise=0.02,
                                          seed=seed))
        assert raw["block"] == RawBlock(128, 16)


def test_choose_compares_the_slowest_round_with_the_default_fastest():
    d, c = MedianTile(), T24
    assert autotune.choose({d: [1.0, 1.0], c: [0.9, 0.9]}, d) == c
    # the faster median, but one round inside the default's spread
    assert autotune.choose({d: [1.0, 0.95], c: [0.9, 0.94]}, d) == d
    # within 2% of the default's fastest round
    assert autotune.choose({d: [1.0, 1.0], c: [0.97, 0.985]}, d) == d
    assert autotune.choose({d: [1.0, 1.0], c: [0.97, 0.97]}, d) == c
    assert autotune.choose({d: [0.9, 0.9], c: [1.0, 1.0]}, d) == d


@pytest.mark.parametrize("ms,k", [(20.0, 1), (8.0, 1), (3.4, 3),
                                  (0.5, 16)])
def test_fit_lengths_make_the_longer_loop_last_8_ms(monkeypatch, ms, k):
    """A loop of 24 default launches lasting ``ms`` gives loops of (8k,
    24k) launches, the longer one at least FIT_SECONDS."""
    class Event:
        def __init__(self, enable_timing):
            pass

        def record(self):
            pass

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return ms

    monkeypatch.setattr(torch.cuda, "Event", Event)
    runs = []
    assert autotune._fit_lengths(runs.append) == (8 * k, 24 * k)
    assert runs == [24, 24]
    assert 24 * k * ms / 24 >= autotune.FIT_SECONDS * 1e3


def test_every_candidate_is_held_once_then_timed_in_interleaved_rounds():
    calls = []
    res = autotune.probe_raw_block(build=lambda specs: None,
                                   measure_factory=_fake_factory(
                                       {}, calls=calls))
    names = list(res["times"])
    n = len(names)
    assert n == 6 and calls[:n] == [("hold", g) for g in names]
    timed = calls[n:]
    assert [k for k, _ in timed] == ["time"] * (n * autotune.ROUNDS)
    rounds = [[g for _, g in timed[r * n:(r + 1) * n]]
              for r in range(autotune.ROUNDS)]
    starts = [names.index(r[0]) for r in rounds]
    assert starts == [r * n // autotune.ROUNDS
                      for r in range(autotune.ROUNDS)]
    assert len(set(starts)) == autotune.ROUNDS
    for r, k in zip(rounds, starts):
        assert r == names[k:] + names[:k]
    # a disagreeing candidate stops the probe before anything is timed
    calls.clear()
    with pytest.raises(autotune.GeometryMismatch):
        autotune.probe_raw_block(build=lambda specs: None,
                                 measure_factory=_fake_factory(
                                     {}, bad=(RawBlock(512, 32),),
                                     calls=calls))
    assert all(k == "hold" for k, _ in calls)


def test_autotune_cli_refuses_without_a_card(capsys):
    assert autotune.main([]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err


def test_autotune_cli_refuses_without_a_card_in_a_process(tmp_path):
    env = dict(os.environ, DIPS_TPU_TORCH_AUTOTUNE_CACHE=str(
        tmp_path / "a.json"))
    res = __import__("subprocess").run(
        [sys.executable, "-m", "dips_tpu_torch.autotune", "--windows", "3",
         "--dry-run"], capture_output=True, text=True, timeout=120, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert res.returncode == 1 and "needs a CUDA card" in res.stderr
    assert not (tmp_path / "a.json").exists()


# -- the pickers ---------------------------------------------------------------

W3 = DiPsProperties(window_size=3, temporal_size=4)


def test_no_store_means_the_default_geometry(card):
    for tail in (False, True):
        for s in (1, 8):
            assert cuda_fused.median_tile(W3, 1080, s, tail, False,
                                          card) == MedianTile()
    assert cuda_fused.median_tile(W3, 360, 4, False, True,
                                  card) == MedianTile()
    assert cuda_fused.raw_block(1, 2048, card) == RawBlock()
    assert cuda_fused.raw_block(8, 2048, card) == RawBlock()


def test_picker_honours_a_stored_tile(card):
    tuning.save(CARD, ring_tiles={3: T24}, raw_block=B512)
    assert cuda_fused.median_tile(W3, 1080, 1, False, False, card) == T24
    # measured in the exact median: the other spatial modes keep the default
    for kw in (dict(approx_median=True), dict(quirk_compat=True)):
        props = DiPsProperties(window_size=3, temporal_size=4, **kw)
        assert cuda_fused.median_tile(props, 1080, 1, False, False,
                                      card) == MedianTile()
    assert cuda_fused.raw_block(1, 2048, card) == B512
    # another window and the tail kernel keep the default
    w5 = DiPsProperties(window_size=5)
    assert cuda_fused.median_tile(w5, 1080, 1, False, False,
                                  card) == MedianTile()
    assert cuda_fused.median_tile(W3, 1080, 1, True, False,
                                  card) == MedianTile()


@pytest.mark.parametrize("stored,hp,rows", [(24, 1080, 24), (24, 376, 8),
                                            (32, 1080, 24), (32, 2160, 24),
                                            (16, 1080, 8), (24, 360, 24)])
def test_picker_falls_to_the_largest_dividing_rows(card, stored, hp, rows):
    tuning.save(CARD, ring_tiles={3: MedianTile(stored, 2, 2)})
    assert cuda_fused.median_tile(W3, hp, 1, False, False,
                                  card) == MedianTile(rows, 2, 2)


def test_picker_drops_rows_that_do_not_fit_the_ring(card):
    """A 24-row tile measured at T = 4 does not fit at T = 16: the launch
    takes the largest height that does."""
    tuning.save(CARD, ring_tiles={3: MedianTile(24, 4, 4)})
    assert cuda_fused.median_tile(W3, 1080, 1, False, False,
                                  card) == MedianTile(24, 4, 4)
    t16 = DiPsProperties(window_size=3, temporal_size=16)
    assert cuda_fused.median_tile(t16, 1080, 1, False, False,
                                  card) == MedianTile(8, 4, 4)


def test_picker_keys_per_launch(card):
    tuning.save(CARD, ring_tiles={3: T24},
                stacked_ring_tiles={5: MedianTile(8, 1, 2)},
                tail_tiles={3: MedianTile(8, 2, 4)},
                slab_ring_tiles={3: {360: MedianTile(24, 1, 3)}},
                stacked_raw_block=RawBlock(128, 32))
    w5 = DiPsProperties(window_size=5)
    pick = cuda_fused.median_tile
    assert pick(w5, 1080, 8, False, False, card) == MedianTile(8, 1, 2)
    assert pick(w5, 1080, 1, False, False, card) == MedianTile()
    # stacked without its own key: the single-stream key
    assert pick(W3, 1080, 8, False, False, card) == T24
    assert pick(W3, 1080, 8, True, False, card) == MedianTile(8, 2, 4)
    # a slab tile only at its owned height, only with bands, and only on
    # a launch of one section: a stacked band launch without its own key
    # keeps the default
    assert pick(W3, 360, 1, False, True, card) == MedianTile(24, 1, 3)
    assert pick(W3, 360, 3, False, True, card) == MedianTile()
    assert pick(W3, 272, 3, False, True, card) == MedianTile()
    assert pick(W3, 360, 3, False, False, card) == T24
    assert cuda_fused.raw_block(8, 2048, card) == RawBlock(128, 32)
    assert cuda_fused.raw_block(1, 2048, card) == RawBlock()
    # a width that does not divide the row falls to 16 bytes
    assert cuda_fused.raw_block(8, 272, card) == RawBlock(128, 16)


def test_picker_stacked_band_launches_take_the_stacked_slab_key(card):
    tuning.save(CARD, slab_ring_tiles={3: {360: MedianTile(24, 1, 3)}},
                stacked_slab_ring_tiles={3: {360: T24}},
                stacked_ring_tiles={3: MedianTile(8, 1, 2)},
                tail_tiles={3: MedianTile(8, 2, 4)})
    pick = cuda_fused.median_tile
    for s in (2, 4, 8):
        assert pick(W3, 360, s, False, True, card) == T24
        assert pick(W3, 272, s, False, True, card) == MedianTile()
        # no bands: the stacked ring key; the tail kernel: its own key
        assert pick(W3, 360, s, False, False, card) == MedianTile(8, 1, 2)
        assert pick(W3, 360, s, True, True, card) == MedianTile(8, 2, 4)
    assert pick(W3, 360, 1, False, True, card) == MedianTile(24, 1, 3)
    w5 = DiPsProperties(window_size=5)
    assert pick(w5, 360, 4, False, True, card) == MedianTile()
    # measured in the exact median only
    approx = DiPsProperties(window_size=3, approx_median=True)
    assert pick(approx, 360, 4, False, True, card) == MedianTile()
    # a stored height that does not divide the owned height falls back
    assert pick(W3, 376, 4, False, True, card) == MedianTile()
    tuning.save(CARD, stacked_slab_ring_tiles={3: {376: T24}})
    assert pick(W3, 376, 4, False, True, card) == MedianTile(8, 2, 2)


def test_autotune_main_mesh_stacked_probes_and_stores_the_stacked_slab(
        cache, monkeypatch, capsys):
    """``--mesh 2x3 --stacked 4`` reaches the median factory with s = 4
    and rows_ax = 3 (after the s = 1 slab probe) and stores the result
    under ``stacked_slab_ring_tiles`` at the owned height 360."""
    seen = []
    fake = _fake_factory({"24x64/s2": 0.5, "128x16": 0.5}, seen=seen)
    monkeypatch.setattr(autotune, "_median_measure_factory", fake)
    monkeypatch.setattr(autotune, "_raw_measure_factory", fake)
    monkeypatch.setattr(_build, "build", lambda **kw: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: CARD)
    monkeypatch.setattr(cuda_fused, "_smem_limit", lambda device: H100_SMEM)
    monkeypatch.setattr(autotune, "_card_line", lambda: CARD + ", 700 W")
    assert autotune.main(["--windows", "1", "3", "--mesh", "2x3",
                          "--stacked", "4"]) == 0
    median = [kw for args, kw in seen if len(args) == 5]
    assert median[-2:] == [{"s": 1, "tail": False, "rows_ax": 3},
                           {"s": 4, "tail": False, "rows_ax": 3}]
    assert [a[0] for a, kw in seen if kw.get("rows_ax", 1) > 1] == [3, 3]
    out = capsys.readouterr().out
    assert "[autotune] chosen stacked[4]-slab[2x3] ring w3: 24x64/s2" in out
    assert "margin" in out
    tuning.invalidate()
    with open(cache) as f:
        entry = json.load(f)[CARD]
    assert entry["stacked_slab_ring_tiles"] == {
        "3": {"360": {"rows": 24, "px": 2, "stages": 2}}}
    assert entry["slab_ring_tiles"] == entry["stacked_slab_ring_tiles"]
    assert entry["meta"]["rounds"] == autotune.ROUNDS
    assert entry["meta"]["mesh"] == "2x3" and entry["meta"]["stacked"] == 4
    assert tuning.stacked_slab_ring_tile(3, 360, CARD) == T24
    assert entry["stacked_raw_block"] == {"threads": 128, "bytes": 16}


def test_plain_twins_ignore_the_store(card):
    """On CPU tensors the wrappers run the plain twins whatever the store
    says, and count no launch."""
    tuning.save(CARD, ring_tiles={3: T24}, raw_block=B512)
    cuda_fused.reset_launch_counts()
    h, w = 16, 40
    hp, wp = 16, 128
    g = torch.Generator().manual_seed(0)
    raw = torch.randint(0, 256, (2, 3, hp, wp), dtype=torch.uint8,
                        generator=g)
    st = [torch.zeros((4, hp, wp))] + [torch.zeros((hp, wp))
                                       for _ in range(3)]
    cuda_fused.batch_step_ring(W3, h, w, raw, *st[:3], [1, 0], st[3],
                               [1, 1], 0, 1)
    assert cuda_fused.launch_counts()["batch_step_ring"] == 0
    assert cuda_fused.geometry_counts() == {}


# -- the geometry as a build parameter ------------------------------------------

def test_default_geometry_builds_what_it_built_before():
    """The default geometry adds no flag: its key, compile commands and
    units are those of a build without a geometry."""
    header = _build.network_header()
    assert Geometry().defines() == ()
    assert _build.build_key(header) == _build.build_key(
        header, Geometry(), _build.UNITS)
    cmds = _build.compile_commands("nvcc", _build.BUILD_ROOT, 1)
    assert cmds == _build.compile_commands("nvcc", _build.BUILD_ROOT, 1,
                                           Geometry(), _build.UNITS)
    assert [c[-1].rsplit("/", 1)[-1] for c, _ in cmds] == [
        src for src, _ in _build.UNITS]
    flags = {f for c, _ in cmds for f in c if f.startswith("-D")}
    assert flags == {f"-DDIPS_WINDOW={w}" for w in _build.WINDOWS}
    assert len(_build.UNITS) == 9 and _build.UNITS[0] == _build.RAW_UNIT


@pytest.mark.parametrize("geometry,flags", [
    (Geometry(tile=T24), ["-DDIPS_TILE_ROWS=24", "-DDIPS_PX=2",
                          "-DDIPS_STAGES=2"]),
    (Geometry(tile=MedianTile(stages=4)), ["-DDIPS_STAGES=4"]),
    (Geometry(block=B512), ["-DDIPS_RAW_THREADS=512", "-DDIPS_RAW_BYTES=32"]),
    (Geometry(block=RawBlock(threads=128)), ["-DDIPS_RAW_THREADS=128"])])
def test_geometry_flags_change_the_build_key(geometry, flags):
    header = _build.network_header()
    assert list(geometry.defines()) == flags
    unit = (_build.median_unit(False, 3),)
    assert _build.build_key(header, geometry, unit) != _build.build_key(
        header, Geometry(), unit)
    assert _build.build_key(header, Geometry(), unit) != _build.build_key(
        header)
    (cmd, _), = _build.compile_commands("nvcc", _build.BUILD_ROOT, 1,
                                        geometry, unit)
    assert all(f in cmd for f in flags) and "-DDIPS_WINDOW=3" in cmd


@pytest.mark.parametrize("kw", [dict(rows=4), dict(rows=40), dict(px=3),
                                dict(stages=0), dict(rows=8.0)])
def test_tile_limits_raise(kw):
    with pytest.raises(ValueError):
        MedianTile(**kw)


@pytest.mark.parametrize("kw", [dict(threads=100), dict(threads=2048),
                                dict(threads=1024), dict(bytes=8),
                                dict(bytes=64)])
def test_block_limits_raise(kw):
    with pytest.raises(ValueError):
        RawBlock(**kw)


def test_tile_shared_memory_grows_with_rows_pixels_and_ring():
    d = MedianTile()
    assert MedianTile(16).smem_bytes(3, 0, 4) > d.smem_bytes(3, 0, 4)
    assert MedianTile(8, 2).smem_bytes(3, 0, 4) < d.smem_bytes(3, 0, 4)
    assert d.smem_bytes(3, 0, 16) - d.smem_bytes(3, 0, 4) == \
        12 * 4 * 256 * 4
    # the exact mode keeps W sorted rows per tile row, the quirk mode two
    # strips and no column buffer
    assert d.smem_bytes(7, 0, 4) > d.smem_bytes(7, 1, 4)
    # the raw block: tiles a block walks at 1080p over a card's two blocks
    # an SM (132 SMs), and four stages of 12 KB (two of 48 KB at 512 x 32)
    assert RawBlock().tiles(1080, 2048, 264) == 3
    assert B512.tiles(1080, 2048, 132) == 2
    assert RawBlock().smem_bytes() == 128 + 4 * 3 * 256 * 16
    assert B512.smem_bytes() == 128 + 2 * 3 * 512 * 32


def test_a_geometry_loads_a_library_of_its_unit_alone(monkeypatch):
    """``kernel_lib`` gives the default geometry the default library and
    builds another geometry for the launched kernel's unit alone, once."""
    calls = []

    class Handle:
        def __getattr__(self, name):
            return self.__dict__.setdefault(name, type("Fn", (), {})())

    def build(force=False, geometry=None, units=None):
        calls.append((geometry, units))
        return "lib.so"

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Handle())
    unit = _build.median_unit(True, 5)
    a = _build.kernel_lib(Geometry(tile=T24), unit)
    assert _build.kernel_lib(Geometry(tile=T24), unit) is a
    d = _build.kernel_lib(Geometry(), unit)
    assert d is _build.lib() and d is not a
    assert calls == [(Geometry(tile=T24), (unit,)), (None, None)]
    assert a.dips_median_tail_w5.restype is _build.ctypes.c_int
    assert a.dips_median_tail_smem_w5.argtypes == [_build.ctypes.c_int] * 2


# -- the kernel build cache ----------------------------------------------------

def _flag(parser, dest="compile_cache"):
    return next(a for a in parser._actions if a.dest == dest)


def test_compile_cache_flag_parses_like_jax():
    port, jx = argparse.ArgumentParser(), argparse.ArgumentParser()
    compilecache.add_compile_cache_flag(port)
    jcc.add_compile_cache_flag(jx)
    a, b = _flag(port), _flag(jx)
    assert (a.option_strings, a.nargs, a.const, a.default, a.metavar) == (
        b.option_strings, b.nargs, b.const, b.default, b.metavar)
    for argv in ([], ["--compile-cache"], ["--compile-cache", "/d"]):
        assert port.parse_args(argv).compile_cache == \
            jx.parse_args(argv).compile_cache


def test_compile_cache_moves_the_build_root(tmp_path, monkeypatch):
    ap = argparse.ArgumentParser()
    compilecache.add_compile_cache_flag(ap)
    root = _build.BUILD_ROOT
    assert compilecache.apply_compile_cache_flag(ap.parse_args([])) is None
    assert _build.BUILD_ROOT == root
    d = tmp_path / "kernels"
    got = compilecache.apply_compile_cache_flag(
        ap.parse_args(["--compile-cache", str(d)]))
    assert got == str(d) and _build.BUILD_ROOT == d and d.is_dir()
    # the environment variable turns it on without the flag
    monkeypatch.setenv("DIPS_COMPILE_CACHE", str(tmp_path / "env"))
    assert compilecache.default_cache_dir() == str(tmp_path / "env")
    assert compilecache.apply_compile_cache_flag(ap.parse_args([])) == str(
        tmp_path / "env")
    assert _build.BUILD_ROOT == tmp_path / "env"
    monkeypatch.delenv("DIPS_COMPILE_CACHE")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    compilecache.apply_compile_cache_flag(
        ap.parse_args(["--compile-cache"]))
    assert _build.BUILD_ROOT == tmp_path / "home/.cache/dips_tpu_torch/kernels"


def test_entry_points_accept_compile_cache(tmp_path, capsys):
    """dips-torch, dips-torch-serve, dips-torch-validate and the tuner
    take ``--compile-cache DIR`` and build under DIR (each exits here
    without a card, after honouring it)."""
    from dips_tpu_torch import cli, validate
    from dips_tpu_torch.serve import daemon
    runs = [
        (cli.main, ["--input", str(tmp_path / "none.avi"), "--output",
                    str(tmp_path / "o.avi")]),
        (daemon.main, ["--height", "16", "--width", "16", "--port", "0"]),
        (validate.main, []),
        (autotune.main, ["--windows", "3"])]
    for i, (main, argv) in enumerate(runs):
        d = tmp_path / f"cache{i}"
        assert main(argv + ["--compile-cache", str(d)]) != 0
        assert _build.BUILD_ROOT == d, main
    assert f"compile cache: {tmp_path / 'cache1'}" in capsys.readouterr().out


# -- the doctor ------------------------------------------------------------------

def test_doctor_autotune_section(cache, monkeypatch):
    from dips_tpu_torch import doctor
    a = doctor.collect(timeout_s=5)["autotune"]
    assert (a["cache_path"], a["entry_present"], a["ok"], a["hint"]) == (
        cache, False, True, None)
    monkeypatch.setattr(doctor, "_probe_torch", lambda t: {
        "ok": True, "device_name": CARD})
    a = doctor.collect(timeout_s=5)["autotune"]
    assert a["device_kind"] == CARD and a["entry_present"] is False
    assert "baked-in default geometry in use" in a["hint"]
    assert "python -m dips_tpu_torch.autotune" in a["hint"]
    tuning.save(CARD, ring_tiles={3: T24})
    a = doctor.collect(timeout_s=5)["autotune"]
    assert (a["entry_present"], a["hint"]) == (True, None)


def test_doctor_compile_cache_section(tmp_path, monkeypatch):
    from dips_tpu_torch import doctor
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "repo-build")
    c = doctor.collect(timeout_s=5)["compile_cache"]
    assert c["dir"] == str(tmp_path / "repo-build")
    assert (c["env_enabled"], c["entries"], c["built"], c["ok"]) == (
        False, 0, False, True)
    assert "DIPS_COMPILE_CACHE" in c["hint"]
    cache_dir = tmp_path / "cache"
    monkeypatch.setenv("DIPS_COMPILE_CACHE", str(cache_dir))
    key = _build.build_key(_build.network_header())
    (cache_dir / key).mkdir(parents=True)
    (cache_dir / key / _build.LIB_NAME).write_bytes(b"")
    c = doctor.collect(timeout_s=5)["compile_cache"]
    assert (c["dir"], c["env_enabled"], c["entries"], c["built"],
            c["hint"]) == (str(cache_dir), True, 1, True, None)


def test_median_tile_names_its_geometry():
    assert MedianTile().name() == "8x128/s3" and T24.name() == "24x64/s2"
    assert RawBlock().name() == "256x16" and B512.name() == "512x32"
    props = DiPsProperties(output=OutputMode.ABSDIFF)
    assert props.window_size in _build.WINDOWS
