"""Wrapping counter (ref: UCircularIndex, dips/src/utils/indexing.rs:1-34,
cloned in dips_alt and dips_opencv).

The device ring uses modular arithmetic directly (``lax.rem`` ring slots in
ops/pallas_fused.py); on the host this counter drives the head/tail cursors
of the pure-Python ``native.FrameRing`` fallback.
"""

from __future__ import annotations


class UCircularIndex:
    """An unsigned index that wraps at ``modulus`` on every mutation."""

    def __init__(self, value: int, modulus: int):
        if modulus <= 0:
            raise ValueError("modulus must be positive")
        self.modulus = int(modulus)
        self.value = int(value) % self.modulus

    def __iadd__(self, other: int) -> "UCircularIndex":
        self.value = (self.value + int(other)) % self.modulus
        return self

    def __int__(self) -> int:
        return self.value

    def __index__(self) -> int:
        return self.value

    def __eq__(self, other) -> bool:
        if isinstance(other, UCircularIndex):
            return (self.value, self.modulus) == (other.value, other.modulus)
        return self.value == other

    def __repr__(self) -> str:
        return f"UCircularIndex({self.value} mod {self.modulus})"
