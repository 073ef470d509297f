"""Small shared helpers, the port's copy of what it needs of
``repro.utils``: ``stable_hash64``, which the engine's distributed cache
hashes keys with, and ``tree_size_bytes``, which the dry run's twin
(``launch.dryrun``) sums a cell's inputs with. The JAX package's trees
are pytrees; the port's are nested dicts whose leaves are tensors or
``models.common.ArraySpec``s (anything with a ``shape`` and a torch
``dtype``). The rest of that module has no caller here."""

from __future__ import annotations

import math


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def tree_size_bytes(tree) -> int:
    """Total bytes of all leaves (tensors or ``ArraySpec``s)."""
    return sum(math.prod(x.shape) * x.dtype.itemsize for x in _leaves(tree))


def stable_hash64(data: bytes) -> int:
    """Deterministic 64-bit FNV-1a hash (no Python hash randomization)."""
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h
