"""Persisted per-card kernel tuning store.

Counterpart of ``dips_tpu/ops/tuning.py``.  The CUDA kernels' block
geometry is a build parameter (``ops/_build.py``): the median kernels'
tile (rows, adjacent pixels a thread, frames staged ahead) and the raw
kernel's block (threads, bytes of a row a thread).  The defaults are fixed
in the sources; run

    python -m dips_tpu_torch.autotune

once on a card to measure the candidates there and persist the fastest
that agrees with the default here.  The geometry pickers
(``ops/cuda_fused.median_tile`` / ``raw_block``) consult this store first
and fall back to the defaults, so the file is an override, never a
requirement.

Location: ``$DIPS_TPU_TORCH_AUTOTUNE_CACHE`` or
``~/.cache/dips_tpu_torch/autotune.json`` (apart from the JAX package's
store: the schemas differ).  Schema (one entry per card name, as
``torch.cuda.get_device_name`` gives it)::

    {"NVIDIA H100 80GB HBM3": {
        "ring_tiles": {"3": {"rows": 8, "px": 4, "stages": 3}},
        "tail_tiles": {"3": {...}},
        "stacked_ring_tiles": {"3": {...}},        # --stacked S probes
        "slab_ring_tiles": {"3": {"360": {...}}},  # --mesh SxR probes
        "stacked_slab_ring_tiles": {"3": {"360": {...}}},
                                       # --mesh SxR --stacked S probes
        "raw_block": {"threads": 256, "bytes": 16},
        "stacked_raw_block": {"threads": 256, "bytes": 16},
        "meta": {...provenance, "rounds": 5...}}}

A corrupt file, a malformed entry or no card means no override.  The
entries are timed optima, not bounds: a later run replaces the keys it
measured and keeps the others.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import fields
from typing import Optional

from ._build import MedianTile, RawBlock

log = logging.getLogger("dips_tpu_torch.tuning")

_ENV = "DIPS_TPU_TORCH_AUTOTUNE_CACHE"
_cache: Optional[dict] = None          # parsed file, loaded once
_cache_path_loaded: Optional[str] = None

#: the per-window tile keys, the per-(window, owned height) slab tile keys
#: and the raw block keys of an entry
TILE_KEYS = ("ring_tiles", "tail_tiles", "stacked_ring_tiles")
SLAB_KEYS = ("slab_ring_tiles", "stacked_slab_ring_tiles")
BLOCK_KEYS = ("raw_block", "stacked_raw_block")


def cache_path() -> str:
    return os.environ.get(
        _ENV, os.path.expanduser("~/.cache/dips_tpu_torch/autotune.json"))


def _load() -> dict:
    """Parsed cache file ({} when absent/corrupt), reloaded if the
    configured path changed (tests point the env var at tmp files)."""
    global _cache, _cache_path_loaded
    path = cache_path()
    if _cache is not None and path == _cache_path_loaded:
        return _cache
    data: dict = {}
    try:
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict):
            raise ValueError("autotune cache root must be an object")
    except FileNotFoundError:
        pass
    except (OSError, ValueError) as e:  # a corrupt cache never breaks a run
        log.warning("ignoring unreadable autotune cache %s: %s", path, e)
        data = {}
    _cache = data
    _cache_path_loaded = path
    return data


def invalidate() -> None:
    """Drop the in-memory copy (after a save, or in tests)."""
    global _cache, _cache_path_loaded
    _cache = None
    _cache_path_loaded = None


def _device_kind(device=None) -> Optional[str]:
    """The card's name (``torch.cuda.get_device_name``), or None without
    a card; any CUDA error degrades to 'no override'."""
    try:
        import torch
        if not torch.cuda.is_available():
            return None
        return torch.cuda.get_device_name(device)
    except (RuntimeError, AssertionError, ValueError):
        return None


def device_entry(kind: Optional[str] = None) -> dict:
    kind = kind if kind is not None else _device_kind()
    if kind is None:
        return {}
    entry = _load().get(kind, {})
    if not isinstance(entry, dict):
        log.warning("ignoring malformed autotune entry for %r", kind)
        return {}
    return entry


def _parse(cls, v, what: str):
    """An entry as ``cls`` (every field given, within the kernels'
    limits), or None with a warning."""
    if v is None:
        return None
    names = {f.name for f in fields(cls)}
    try:
        if not isinstance(v, dict) or set(v) != names:
            raise ValueError(f"want the fields {sorted(names)}")
        return cls(**v)
    except (TypeError, ValueError) as e:
        log.warning("ignoring malformed %s %r: %s", what, v, e)
        return None


def _tile(v, what: str) -> Optional[MedianTile]:
    return _parse(MedianTile, v, what)


def _window_tile(key: str, window: int,
                 kind: Optional[str]) -> Optional[MedianTile]:
    tiles = device_entry(kind).get(key, {})
    if not isinstance(tiles, dict):
        return None
    return _tile(tiles.get(str(window)), f"{key}[{window}]")


def ring_tile(window: int, kind: Optional[str] = None) -> Optional[MedianTile]:
    """Measured tile of the median ring kernel at this window on this card,
    or None (the default tile)."""
    return _window_tile("ring_tiles", window, kind)


def tail_tile(window: int, kind: Optional[str] = None) -> Optional[MedianTile]:
    """Measured tile of the median tail kernel at this window, or None."""
    return _window_tile("tail_tiles", window, kind)


def stacked_ring_tile(window: int,
                      kind: Optional[str] = None) -> Optional[MedianTile]:
    """Measured tile of the STACKED median ring kernel (s streams folded
    along the rows: the fleet and coalesced-serving shape, ``python -m
    dips_tpu_torch.autotune --stacked S``), or None (the picker then takes
    :func:`ring_tile`)."""
    return _window_tile("stacked_ring_tiles", window, kind)


def _slab_tile(key: str, window: int, owned_hp: int,
               kind: Optional[str]) -> Optional[MedianTile]:
    tiles = device_entry(kind).get(key, {})
    if not isinstance(tiles, dict):
        return None
    per_h = tiles.get(str(window))
    if not isinstance(per_h, dict):
        return None
    return _tile(per_h.get(str(owned_hp)), f"{key}[{window}][{owned_hp}]")


def slab_ring_tile(window: int, owned_hp: int,
                   kind: Optional[str] = None) -> Optional[MedianTile]:
    """Measured tile of the band-form median ring kernel at this window
    and owned (padded height / row cells) slab height, one section a
    launch (``--mesh SxR``), or None (the default tile)."""
    return _slab_tile("slab_ring_tiles", window, owned_hp, kind)


def stacked_slab_ring_tile(window: int, owned_hp: int,
                           kind: Optional[str] = None
                           ) -> Optional[MedianTile]:
    """Measured tile of the STACKED band-form median ring kernel (several
    streams' owned slabs along one launch's rows: a grid cell holding more
    than one stream, ``--mesh SxR --stacked S``) at this window and owned
    height, or None (the default tile: a tile measured on one section is
    not taken for this shape)."""
    return _slab_tile("stacked_slab_ring_tiles", window, owned_hp, kind)


def _block(key: str, kind: Optional[str]) -> Optional[RawBlock]:
    return _parse(RawBlock, device_entry(kind).get(key), key)


def raw_block(kind: Optional[str] = None) -> Optional[RawBlock]:
    """Measured block of the raw kernel on this card, or None."""
    return _block("raw_block", kind)


def stacked_raw_block(kind: Optional[str] = None) -> Optional[RawBlock]:
    """Measured block of the STACKED raw kernel, or None (the picker then
    takes :func:`raw_block`)."""
    return _block("stacked_raw_block", kind)


def _as_dict(geometry) -> dict:
    """A MedianTile / RawBlock or a dict of its fields, checked."""
    if isinstance(geometry, dict):
        geometry = (MedianTile(**geometry) if "rows" in geometry
                    else RawBlock(**geometry))
    return dict(vars(geometry))


def _merge(prior, tiles: dict, depth: int) -> dict:
    """``tiles`` over the stored map ``prior``, ``depth`` levels of keys
    deep (1: {window: tile}; 2: {window: {owned_hp: tile}}): each tile
    given replaces the stored one, the others stay."""
    merged = dict(prior) if isinstance(prior, dict) else {}
    for k, v in tiles.items():
        merged[str(k)] = (_as_dict(v) if depth == 1
                          else _merge(merged.get(str(k)), v, depth - 1))
    return merged


def save(kind: str, ring_tiles: Optional[dict] = None,
         tail_tiles: Optional[dict] = None,
         stacked_ring_tiles: Optional[dict] = None,
         slab_ring_tiles: Optional[dict] = None,
         stacked_slab_ring_tiles: Optional[dict] = None,
         raw_block: Optional[RawBlock] = None,
         stacked_raw_block: Optional[RawBlock] = None,
         meta: Optional[dict] = None) -> str:
    """Merge measurements for ``kind`` into the cache file; returns the
    path written.  Tile maps are {window: tile} (the slab keys {window:
    {owned_hp: tile}}), a tile a :class:`MedianTile` or a dict of its
    fields, a block a :class:`RawBlock`.  Each window, owned height and
    block given replaces the stored one; the others stay."""
    path = cache_path()
    invalidate()        # re-read the FILE: another process (a concurrent
    data = _load().copy()  # autotune run) may have written since we loaded
    raw_entry = data.get(kind, {})
    entry = dict(raw_entry) if isinstance(raw_entry, dict) else {}
    for keys, maps, depth in (
            (TILE_KEYS, (ring_tiles, tail_tiles, stacked_ring_tiles), 1),
            (SLAB_KEYS, (slab_ring_tiles, stacked_slab_ring_tiles), 2)):
        for key, tiles in zip(keys, maps):
            if tiles:
                entry[key] = _merge(entry.get(key), tiles, depth)
    for key, block in zip(BLOCK_KEYS, (raw_block, stacked_raw_block)):
        if block is not None:
            entry[key] = _as_dict(block)
    if meta:
        entry["meta"] = meta
    data[kind] = entry
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    invalidate()
    return path
