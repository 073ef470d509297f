"""Small shared helpers, the port's copy of what it needs of
``repro.utils``: ``stable_hash64``, which the engine's distributed cache
hashes keys with. The rest of that module works on JAX trees and has no
caller here."""

from __future__ import annotations


def stable_hash64(data: bytes) -> int:
    """Deterministic 64-bit FNV-1a hash (no Python hash randomization)."""
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h
