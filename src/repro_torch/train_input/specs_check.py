"""Dryrun lane: validate the shuffle-fed batch against the sharded specs,
the port of ``repro.train_input.specs_check``.

Three layers, cheapest first:

* ``input_spec_report`` — from ``launch.specs.input_specs`` +
  ``distributed.sharding`` rules alone: each input's global shape,
  dtype, PartitionSpec, and per-rank shard shape (with the divisibility
  proof that the spec actually tiles the mesh); the same dict as JAX's;
* ``validate_device_batch`` — a batch the pipeline actually produced:
  every tensor must match the spec's shape and dtype and lie on the
  pipeline's device, and its per-rank shard (``shuffle.exchange``'s
  ``shard`` over the spec's axes) must have the report's shape;
* ``lower_train_step`` — one run of the real ``make_train_step`` on a
  throwaway model at the spec's shapes: proves the specs are consumable
  by the actual step.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.distributed.sharding import DEFAULT_RULES, partition_spec
from repro_torch.launch.specs import input_specs
from repro_torch.models.common import ShapeConfig


def _shard_shape(global_shape, pspec, mesh):
    """Per-device shard shape under ``pspec`` (raises on non-divisible —
    ``partition_spec`` should never emit such a spec)."""
    out = []
    for dim, part in zip(global_shape, tuple(pspec) + (None,) * (
            len(global_shape) - len(tuple(pspec)))):
        axes = (part,) if isinstance(part, str) else (part or ())
        n = 1
        for ax in axes:
            n *= mesh.shape[ax]
        if dim % n:
            raise ValueError(f"dim {dim} not divisible by mesh product {n} "
                             f"for spec {pspec}")
        out.append(dim // n)
    return tuple(out)


def _dtype_name(dtype) -> str:
    """JAX's name of a dtype (``int32``, ``bfloat16``)."""
    return str(dtype).removeprefix("torch.")


def input_spec_report(model_cfg, shape: ShapeConfig, mesh,
                      rules=None) -> Dict[str, dict]:
    rules = rules or DEFAULT_RULES
    report = {}
    for name, spec in input_specs(model_cfg, shape).items():
        ps = partition_spec(spec, rules, mesh)
        report[name] = {
            "global_shape": list(spec.shape),
            "dtype": _dtype_name(spec.dtype),
            "partition_spec": str(ps),
            "per_device_shape": list(_shard_shape(spec.shape, ps, mesh)),
        }
    return report


def _on(t, device) -> bool:
    want = torch.device(device)
    return t.device.type == want.type and want.index in (None, t.device.index)


def validate_device_batch(batch, model_cfg, shape: ShapeConfig, mesh,
                          rules=None, *, device="cuda") -> Dict[str, dict]:
    """Assert a produced device batch matches the sharded input specs;
    returns the report on success, raises AssertionError on any drift.
    JAX's sharding check becomes two: the tensor lies on ``device``, and
    each rank's block of it (its dimension 0 split over the spec's mesh
    axes, every other dimension whole) has the report's shard shape."""
    from repro_torch.shuffle.exchange import for_mesh

    rules = rules or DEFAULT_RULES
    specs = input_specs(model_cfg, shape)
    report = input_spec_report(model_cfg, shape, mesh, rules)
    assert set(batch) == set(specs), \
        f"batch keys {sorted(batch)} != spec keys {sorted(specs)}"
    exchange = for_mesh(mesh)
    for name, arr in batch.items():
        spec = specs[name]
        assert tuple(arr.shape) == tuple(spec.shape), \
            f"{name}: shape {tuple(arr.shape)} != spec {spec.shape}"
        assert arr.dtype == spec.dtype, \
            f"{name}: dtype {arr.dtype} != spec {spec.dtype}"
        assert _on(arr, device), f"{name}: on {arr.device}, not on {device}"
        parts = tuple(partition_spec(spec, rules, mesh))
        assert all(p is None for p in parts[1:]), \
            f"{name}: {parts} shards a dimension past the first"
        if parts:
            axes = (parts[0],) if isinstance(parts[0], str) else (parts[0] or ())
            got_shard = tuple(exchange.shard(arr, axes).shape[1:])
        else:
            got_shard = ()
        assert got_shard == tuple(report[name]["per_device_shape"]), \
            f"{name}: shard shape {got_shard} != " \
            f"{report[name]['per_device_shape']}"
    return report


def lower_train_step(model_cfg, tcfg, mesh, shape: ShapeConfig,
                     rules=None, *, device="cuda") -> str:
    """Run the real train step once on a zero batch of the spec's shapes
    and dtypes; returns a short text head (each input's shape, dtype and
    spec; the loss's shape and dtype; the count of gradient tensors the
    optimizer took) or raises if the specs don't feed the step.

    JAX lowers the jitted step against abstract inputs and touches no
    device. The port computes: its MoE path reads the device on the host
    in its range checks (``repro_torch/kernels/_checks.py``), which a
    meta tensor or a FakeTensor cannot answer, and those checks are not
    dropped for a dry run. So a fresh model and its AdamW state are drawn
    from a fixed generator on ``device``, and thrown away after the step."""
    from repro_torch.models import lm
    from repro_torch.models.common import init_params
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_step import make_train_step

    rules = rules or DEFAULT_RULES
    specs = input_specs(model_cfg, shape)
    model = init_params(lm.LM(model_cfg, device=device),
                        torch.Generator(device=device).manual_seed(0))
    batch = {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
             for k, s in specs.items()}
    step = make_train_step(model_cfg, tcfg, mesh=mesh)
    _, opt_state, metrics = step(model, adamw_init(model), batch)
    loss = metrics["loss"]
    lines = [f"{k}: {list(s.shape)} {_dtype_name(s.dtype)} "
             f"{partition_spec(s, rules, mesh)}" for k, s in specs.items()]
    lines.append(f"loss: {list(loss.shape)} {_dtype_name(loss.dtype)}")
    lines.append(f"gradients: {len(opt_state['m'])} tensors")
    return "\n".join(lines)
