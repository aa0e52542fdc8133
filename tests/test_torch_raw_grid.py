"""The raw kernel's grid on the CPU: how ``ops/_build.RawBlock`` sizes a
launch and cuts a stream among its blocks and tiles (the host's mirror of
``csrc/raw_ring.cu``, whose kernel runs only on a card), and how
``ops/cuda_fused`` asks the library for the card's resident blocks.

Every chunk of every stream is covered exactly once, the shares of a
stream differ by at most one chunk, a tile never holds more chunks than
the block has threads, and the statistic partials number one per block,
tile and warp.  The card's side of it (the library's own counts, the
kernel on uneven splits) is in ``tests/test_torch_cuda.py``.
"""

import re

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dips_tpu_torch.ops import _build, cuda_fused
from dips_tpu_torch.ops._build import RawBlock
from dips_tpu_torch.ops.reference import pad_geometry

BLOCKS = [RawBlock(t, b) for t in (32, 128, 256, 512, 992)
          for b in (16, 32)]


def _geometry(draw_hp, draw_wp16, block):
    """(Hp, Wp) with Wp a multiple of the block's bytes."""
    return draw_hp, draw_wp16 * block.bytes


@settings(max_examples=300, deadline=None)
@given(s=st.integers(1, 40), hp=st.integers(1, 2200),
       wp=st.integers(1, 300), resident=st.integers(1, 600),
       which=st.integers(0, len(BLOCKS) - 1))
def test_every_chunk_is_covered_once(s, hp, wp, resident, which):
    block = BLOCKS[which]
    hp, wp = _geometry(hp, wp, block)
    nb = block.blocks(s, hp, wp, resident)
    n = block.chunks(hp, wp)
    assert 1 <= nb <= max(1, n // block.threads)
    if resident >= s:
        assert s * nb <= resident
    tiles = block.split(hp, wp, nb)
    per = block.tiles(hp, wp, nb)
    assert len(tiles) == nb * per
    covered = []
    for start, size in tiles:
        assert 1 <= size <= block.threads
        covered.extend(range(start, start + size))
    assert covered == list(range(n))
    shares = [sum(size for _, size in tiles[b * per:(b + 1) * per])
              for b in range(nb)]
    assert max(shares) - min(shares) <= 1
    assert block.parts(hp, wp, nb) == nb * per * (block.threads // 32)


@settings(max_examples=200, deadline=None)
@given(hp=st.integers(1, 4400), wp16=st.integers(1, 500),
       nb=st.integers(1, 700), which=st.integers(0, len(BLOCKS) - 1))
def test_any_block_count_splits_into_even_tiles(hp, wp16, nb, which):
    """Any block count the kernel takes (1 <= nb <= chunks), not only the
    one :meth:`RawBlock.blocks` picks: the tiles of a share differ by at
    most one chunk too."""
    block = BLOCKS[which]
    hp, wp = _geometry(hp, wp16, block)
    n = block.chunks(hp, wp)
    nb = min(nb, n)
    per = block.tiles(hp, wp, nb)
    tiles = block.split(hp, wp, nb)
    assert [s for s, _ in tiles] == sorted(s for s, _ in tiles)
    assert sum(size for _, size in tiles) == n
    for b in range(nb):
        sizes = [size for _, size in tiles[b * per:(b + 1) * per]]
        assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
        assert max(sizes) <= block.threads


@pytest.mark.parametrize("s,h,w,nb,tiles", [
    (1, 1080, 1920, 264, 3),    # 138240 chunks: shares of 523 and 524
    (8, 1080, 1920, 33, 17),    # the fleet: 33 blocks a stream
    (1, 4320, 7680, 264, 32),   # 8K (Wp 7808)
    (1, 24, 140, 1, 2),          # the acceptance clips: one block
    (4, 360, 1920, 66, 3),      # a (2, 3) grid cell: 4 streams x 360 rows
])
def test_the_main_path_shapes_on_an_h100(s, h, w, nb, tiles):
    """The grid at the main path's shapes on an H100's 132 SMs at two
    blocks an SM (``dips_raw_resident`` = 264)."""
    hp, wp = pad_geometry(h, w)
    block = RawBlock()
    assert block.blocks(s, hp, wp, 264) == nb
    assert block.tiles(hp, wp, nb) == tiles


def test_the_mirror_reads_the_source_constants():
    """The host's mirror of the kernel's geometry uses the source's own
    constants: the stage budget, the barrier slot, the split."""
    src = (_build.CSRC / "raw_ring.cu").read_text()
    assert "constexpr int kStageBudget = 96 * 1024;" in src
    assert "constexpr int kBarBytes = 128;" in src
    assert "constexpr int kMaxStages = 4;" in src
    assert "return k * q + min(k, r);" in src
    for block in BLOCKS:
        stage = 3 * block.threads * block.bytes
        stages = min(4, max(2, 96 * 1024 // stage))
        assert block.stages == stages
        assert block.smem_bytes() == 128 + stages * stage
        assert block.smem_bytes() <= 227 * 1024


class _FakeLib:
    """A library stand-in: its resident count and an error string."""

    def __init__(self, resident):
        self.resident, self.calls = resident, 0

    def dips_raw_resident(self, mode):
        self.calls += 1
        return self.resident

    def dips_error_string(self, code):
        return b"fake error"


def test_resident_blocks_are_asked_once_a_device_block_and_mode(
        monkeypatch):
    monkeypatch.setattr(cuda_fused, "_RESIDENT", {})
    lib = _FakeLib(264)
    dev = torch.device("cuda", 3)
    for _ in range(3):
        assert cuda_fused._raw_resident(lib, dev, RawBlock(), 1) == 264
    assert lib.calls == 1
    assert cuda_fused._raw_resident(lib, dev, RawBlock(128, 16), 1) == 264
    assert cuda_fused._raw_resident(lib, torch.device("cuda", 1),
                                    RawBlock(), 1) == 264
    assert cuda_fused._raw_resident(lib, dev, RawBlock(), 0) == 264
    assert lib.calls == 4


def test_a_resident_query_that_fails_raises(monkeypatch):
    monkeypatch.setattr(cuda_fused, "_RESIDENT", {})
    with pytest.raises(RuntimeError, match="dips_raw_resident"):
        cuda_fused._raw_resident(_FakeLib(-2), torch.device("cuda", 0),
                                 RawBlock(), 2)
    assert cuda_fused._RESIDENT == {}


def test_the_library_exports_the_grid_entry_points():
    sig = _build.unit_signatures(_build.RAW_UNIT)
    assert set(sig) == {"dips_raw_ring", "dips_raw_tail",
                        "dips_raw_resident", "dips_raw_parts",
                        "dips_raw_smem"}
    src = (_build.CSRC / "raw_ring.cu").read_text()
    for name, args in sig.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        assert m, name
        params = [p for p in m[1].split(",") if p.strip()]
        assert len(params) == len(args), name
