"""Bit-packed THRESHOLD masks for the device-to-host copy.

Counterpart of ``dips_tpu/ops/wire.py``.  A THRESHOLD map is a binary mask
stored one byte per pixel; :func:`pack_mask` packs it to one bit per pixel
on the device before the download (1/8 of the bytes), and the host unpacks
it.  Masks are packed along the ROW axis (8 rows -> 1 byte row), so the
padded width stays the minor dimension.  Bit order is little-endian within
each byte (numpy ``bitorder="little"``): original row ``8*r + i`` lives at
packed row ``r``, bit ``i``.

:func:`pack_mask` is plain torch on the mask's device (the JAX package
leaves it to XLA).  :func:`pack_mask_host` and :func:`unpack_mask_host` are
verbatim copies of the JAX package's numpy twins; :func:`unpack_mask`, the
engines' host unpack, gives the same bytes as the JAX package's without
``np.unpackbits`` along the row axis, a strided axis, which makes it
several times slower than a broadcast along the minor one.
"""

from __future__ import annotations

import numpy as np
import torch

#: bit i of a packed byte is row 8*r + i
_BITS = np.arange(8, dtype=np.uint8)[:, None]


def pack_mask(out: torch.Tensor) -> torch.Tensor:
    """uint8 mask (..., H, W) with H % 8 == 0 -> packed uint8 (..., H//8, W).

    Any non-zero byte counts as a set bit, so it accepts both {0, 255}
    masks and {0, 1} bit planes.
    """
    h = out.shape[-2]
    if h % 8:
        raise ValueError(f"pack_mask: {h} rows is not a multiple of 8")
    bits = (out > 0).to(torch.uint8)
    grouped = bits.reshape(bits.shape[:-2] + (h // 8, 8, bits.shape[-1]))
    packed = grouped[..., 0, :].clone()
    for i in range(1, 8):
        packed |= grouped[..., i, :] << i
    return packed


def unpack_mask(packed: np.ndarray) -> np.ndarray:
    """Packed uint8 (..., H // 8, W) -> uint8 {0, 255} mask (..., H, W),
    equal to ``unpack_mask_host(packed, H)``: each packed row spread over
    its 8 rows by one broadcast along the minor axis."""
    bits = (packed[..., None, :] >> _BITS) & np.uint8(1)
    return (bits * np.uint8(255)).reshape(
        packed.shape[:-2] + (8 * packed.shape[-2], packed.shape[-1]))


def pack_mask_host(out: np.ndarray) -> np.ndarray:
    """Host-side twin of :func:`pack_mask` (numpy, for TCP payloads).
    Unlike the device twin it accepts any H — numpy zero-pads the row axis
    to a byte boundary; invert with :func:`unpack_mask_host`."""
    return np.packbits(out > 0, axis=-2, bitorder="little")


def unpack_mask_host(packed: np.ndarray, h: int) -> np.ndarray:
    """Packed uint8 (..., ceil(h/8), W) -> uint8 {0, 255} mask (..., h, W).

    The single owner of the wire bit-order contract for consumers that
    need the crop (``h`` need not be a multiple of 8)."""
    bits = np.unpackbits(np.ascontiguousarray(packed), axis=-2, count=h,
                         bitorder="little")
    return bits * np.uint8(255)
