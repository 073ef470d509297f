"""Carry arrays, parameters and caches between the JAX package and the port.

``to_torch`` turns the JAX package's arrays (record rows, keys, the
``(order, starts, counts)`` triple, blob layouts, ``(q, scales)``, decode
caches), given as numpy or as anything ``np.asarray`` accepts, into
tensors, keeping dicts, tuples and named tuples as they are.
``to_numpy`` turns tensors back. ``params_from_jax`` loads the JAX
package's parameter tree into the port's model modules, and
``cache_from_jax`` its decode cache.
Both keep every bit: a JAX bf16 array converts to numpy with the
``ml_dtypes`` bfloat16 dtype, which ``torch.from_numpy`` refuses, so bf16
crosses as its uint16 bit pattern.
"""

from __future__ import annotations

import numpy as np
import torch


def _is_tuple(obj) -> bool:
    return isinstance(obj, (tuple, list))


def _rebuild(obj, items):
    if hasattr(obj, "_fields"):          # a NamedTuple such as Packing
        return type(obj)(*items)
    return type(obj)(items)


def to_torch(obj, device="cuda"):
    """numpy (or array-like) leaves -> tensors on ``device``."""
    if isinstance(obj, dict):
        return {k: to_torch(v, device) for k, v in obj.items()}
    if _is_tuple(obj):
        return _rebuild(obj, [to_torch(o, device) for o in obj])
    # tensors share memory with writable, C-ordered arrays only
    a = np.require(np.asarray(obj), requirements=["C", "W"])
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def to_numpy(obj):
    """Tensor leaves -> numpy arrays; bf16 comes back with the
    ``ml_dtypes`` bfloat16 dtype that JAX uses."""
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if _is_tuple(obj):
        return _rebuild(obj, [to_numpy(o) for o in obj])
    t = obj.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def assert_same_bits(a, b) -> None:
    """Raise ``AssertionError`` unless ``a`` and ``b`` (arrays, tensors or
    tuples of them) have the same shapes, dtypes and bytes."""
    if _is_tuple(a) or _is_tuple(b):
        if not (_is_tuple(a) and _is_tuple(b) and len(a) == len(b)):
            raise AssertionError(f"structure differs: {type(a)} vs {type(b)}")
        for x, y in zip(a, b):
            assert_same_bits(x, y)
        return
    x = to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    y = to_numpy(b) if isinstance(b, torch.Tensor) else np.asarray(b)
    if x.shape != y.shape or x.dtype != y.dtype:
        raise AssertionError(f"{x.shape} {x.dtype} != {y.shape} {y.dtype}")
    xb = np.ascontiguousarray(x).view(np.uint8)
    yb = np.ascontiguousarray(y).view(np.uint8)
    if not np.array_equal(xb, yb):
        raise AssertionError(
            f"{int((xb != yb).sum())} of {xb.size} bytes differ "
            f"(shape {x.shape}, dtype {x.dtype})")


def _jax_leaf(tree, name: str):
    """The JAX parameter of the port's parameter ``name``: a layer of the
    ``nn.ModuleList`` ``blocks.<i>.<path>`` (or ``dense_blocks.<i>.<path>``)
    is row ``i`` of the stacked leaf ``blocks/<path>``
    (``dense_blocks/<path>``); every other name is a path as it stands."""
    parts = name.split(".")
    layer = None
    if parts[0] in ("blocks", "dense_blocks"):
        layer = int(parts.pop(1))
    leaf = tree
    for part in parts:
        leaf = leaf[part]
    leaf = np.asarray(leaf)
    return leaf if layer is None else leaf[layer]


def params_from_jax(cfg, params, device="cuda"):
    """The JAX package's parameter tree for ``cfg`` (leaves as numpy or
    array-likes, every layer stacked on a leading ``layers`` axis) -> the
    port's ``repro_torch.models.lm.LM`` on ``device``, bit for bit."""
    from repro_torch.models.lm import LM
    model = LM(cfg, device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            t = to_torch(_jax_leaf(params, name), device)
            if t.shape != p.shape or t.dtype != p.dtype:
                raise ValueError(f"JAX parameter for {name} is "
                                 f"{tuple(t.shape)} {t.dtype}, the port's "
                                 f"{tuple(p.shape)} {p.dtype}")
            p.copy_(t)
    return model


def cache_from_jax(cache, device="cuda") -> dict:
    """The JAX package's decode cache (nested dicts of stacked arrays) ->
    the port's cache of the same layout, bit for bit."""
    return to_torch(cache, device)
