"""Logical-axis -> mesh-axis sharding rules with divisibility fallback, the
port of ``repro.distributed.sharding``.

Every array carries *logical* axis names on its ``ArraySpec`` (see
``repro_torch.models.common``). A ``ShardingRules`` table maps those
names to mesh axes; ``partition_spec`` applies the table with two safety
rails, as the JAX package does:

  * a mesh axis is used at most once per tensor,
  * an axis is only applied if the dimension is divisible by the mesh-axis
    product so far (e.g. 8 kv-heads on a 16-way model axis => replicated).

The port has no ``jax.sharding``: ``PartitionSpec`` is a tuple whose
``str()`` is JAX's, and ``NamedSharding`` pairs it with its mesh (a
``repro_torch.launch.mesh`` mesh, of which only ``shape`` is read).
``named_shardings`` maps a nested dict of parameter specs
(``models.lm.param_defs``) to the same dict of ``NamedSharding``s, which
``runtime.elastic_restore_plan`` and ``BlobCheckpointer.restore`` read.
``NamedSharding.shard_shape`` gives one device's block, as JAX's does;
the dry run's twin (``launch.dryrun``) sums a cell's inputs by it, under
the rules that ``ShardingRules.override`` makes for each cell.
``constrain`` has no twin: it is a layout hint under ``jit``
(``with_sharding_constraint``), and the JAX package calls it nowhere.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

from repro_torch.models.common import ArraySpec


class PartitionSpec(tuple):
    """One entry per dimension: a mesh axis, a tuple of them, or None."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A ``PartitionSpec`` over the axes of ``mesh``."""
    mesh: object
    spec: PartitionSpec

    def shard_shape(self, global_shape) -> tuple:
        """The shape of one device's block of an array of ``global_shape``,
        as JAX's ``NamedSharding.shard_shape``: each dimension divided by
        the product of the mesh axes its entry names."""
        out = []
        for i, dim in enumerate(global_shape):
            part = self.spec[i] if i < len(self.spec) else None
            axes = () if part is None else (part,) if isinstance(part, str) else part
            n = math.prod(self.mesh.shape[a] for a in axes)
            if dim % n:
                raise ValueError(f"dimension {i} of {tuple(global_shape)} does not divide "
                                 f"into {n} blocks over {axes}")
            out.append(dim // n)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Map logical axis name -> tuple of mesh axes (in order of preference)."""
    rules: Dict[str, Tuple[str, ...]]

    def get(self, name) -> Tuple[str, ...]:
        if name is None:
            return ()
        r = self.rules.get(name, ())
        return (r,) if isinstance(r, str) else tuple(r)

    def override(self, **kw) -> "ShardingRules":
        new = dict(self.rules)
        for k, v in kw.items():
            new[k] = v
        return ShardingRules(new)


# The JAX package's default rules for the (pod, data, model) mesh family:
# FSDP over "data", TP over "model", EP over ("pod", "model"), the batch
# over ("pod", "data").
DEFAULT_RULES = ShardingRules({
    "vocab": ("model",),
    "embed": ("data",),
    "kv_embed": ("data",),
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "experts": ("pod", "model"),
    "expert_mlp": (),
    "layers": (),
    "stack": (),
    "batch": ("pod", "data"),
    "seq": (),
    "kv_seq": (),
})


def partition_spec(spec: ArraySpec, rules: ShardingRules, mesh) -> PartitionSpec:
    used = set()
    parts = []
    axes = spec.axes or (None,) * len(spec.shape)
    for dim, name in zip(spec.shape, axes):
        chosen = []
        prod = 1
        for mesh_ax in rules.get(name):
            if mesh_ax in used or mesh_ax not in mesh.shape:
                continue
            size = mesh.shape[mesh_ax]
            if size > 1 and dim % (prod * size) == 0:
                chosen.append(mesh_ax)
                used.add(mesh_ax)
                prod *= size
        parts.append(tuple(chosen) if len(chosen) > 1
                     else (chosen[0] if chosen else None))
    return PartitionSpec(*parts)


def named_shardings(defs, rules: ShardingRules, mesh):
    """ArraySpec tree (nested dicts) -> the same tree of NamedShardings."""
    if isinstance(defs, dict):
        return {k: named_shardings(v, rules, mesh) for k, v in defs.items()}
    return NamedSharding(mesh, partition_spec(defs, rules, mesh))


def batch_specs(shapes: Dict[str, ArraySpec], rules: ShardingRules, mesh):
    return {k: NamedSharding(mesh, partition_spec(s, rules, mesh))
            for k, s in shapes.items()}
