"""Carry arrays, parameters and caches between the JAX package and the port.

``to_torch`` turns the JAX package's arrays (record rows, keys, the
``(order, starts, counts)`` triple, blob layouts, ``(q, scales)``, decode
caches), given as numpy or as anything ``np.asarray`` accepts, into
tensors, keeping dicts, tuples and named tuples as they are.
``to_numpy`` turns tensors back. ``params_from_jax`` loads the JAX
package's parameter tree into the port's model modules, and
``cache_from_jax`` its decode cache. ``train_state_tree`` lays the port's
train state (the model and its AdamW state) out as the JAX package's
tree (``params_tree`` lays out the parameters alone), which
``train_state_to_jax`` copies to numpy and ``train_state_from_jax`` loads
back onto a device.
Both keep every bit: a JAX bf16 array converts to numpy with the
``ml_dtypes`` bfloat16 dtype, which ``torch.from_numpy`` refuses, so bf16
crosses as its uint16 bit pattern.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.training.optimizer import adamw_init


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
    model = lm.LM(cfg, device=device)
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


class StackedRows:
    """The JAX package's stacked leaf of one per-layer tensor of the port:
    row ``i`` of the leaf is layer ``i``'s tensor. It has the leaf's
    ``shape``; ``np.asarray`` copies the rows off their device into one
    array, and ``copy_`` writes a stacked source into the rows in place."""

    def __init__(self, rows):
        self.rows = list(rows)
        self.shape = (len(self.rows), *self.rows[0].shape)
        self.dtype = self.rows[0].dtype

    def __array__(self, dtype=None, copy=None):
        kind = to_numpy(self.rows[0].reshape(-1)[:0]).dtype
        out = np.empty(self.shape, kind)
        bf16 = kind.name == "bfloat16"
        for i, row in enumerate(self.rows):   # each row straight into its place
            dst = torch.from_numpy(out[i].view(np.uint16) if bf16 else out[i])
            (dst.view(torch.bfloat16) if bf16 else dst).copy_(row.detach())
        return out if dtype is None else out.astype(dtype)

    def copy_(self, src):
        for i, row in enumerate(self.rows):
            row.copy_(src[i])
        return self


def params_tree(model) -> dict:
    """The port's model's parameters as the JAX package's parameter tree,
    each stacked leaf a ``StackedRows`` over the layers' tensors."""
    return lm.jax_layout(dict(model.named_parameters()), StackedRows)


def train_state_tree(model, opt: dict) -> dict:
    """The port's train state as the JAX package's train state tree,
    ``{"opt": {"count", "m", "v"}, "params": ...}`` with every layer
    stacked on a leading ``layers`` axis. The leaves are the state's own
    tensors (a stacked leaf a ``StackedRows`` over the layers' tensors),
    so ``np.asarray`` of a leaf copies it to the host and ``copy_`` into
    it writes the state in place."""
    return {"opt": {"count": opt["count"],
                    "m": lm.jax_layout(opt["m"], StackedRows),
                    "v": lm.jax_layout(opt["v"], StackedRows)},
            "params": params_tree(model)}


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def train_state_to_jax(model, opt: dict) -> dict:
    """The port's ``(lm.LM, AdamW state)`` -> the JAX package's train state
    tree of fresh numpy arrays (bf16 with the ``ml_dtypes`` dtype)."""
    def host(leaf):
        return np.asarray(leaf) if isinstance(leaf, StackedRows) else np.array(to_numpy(leaf))
    return _map_leaves(host, train_state_tree(model, opt))


def train_state_from_jax(cfg, state: dict, device="cuda"):
    """The JAX package's train state tree for ``cfg`` (``{"opt": {"count",
    "m", "v"}, "params": ...}``, leaves numpy or array-likes) -> the port's
    ``(lm.LM, AdamW state)`` on ``device``, bit for bit."""
    model = lm.LM(cfg, device=device)
    opt = adamw_init(model)

    def load(target, leaf, path):
        if isinstance(target, dict):
            if not isinstance(leaf, dict) or sorted(leaf) != sorted(target):
                raise ValueError(f"the JAX train state at {path or '/'} has other "
                                 f"keys than the port's")
            for k in target:
                load(target[k], leaf[k], f"{path}/{k}")
            return
        t = to_torch(leaf, "cpu")
        if tuple(t.shape) != tuple(target.shape) or t.dtype != target.dtype:
            raise ValueError(f"JAX leaf {path} is {tuple(t.shape)} {t.dtype}, the "
                             f"port's {tuple(target.shape)} {target.dtype}")
        target.copy_(t)

    with torch.no_grad():
        load(train_state_tree(model, opt), state, "")
    return model, opt
