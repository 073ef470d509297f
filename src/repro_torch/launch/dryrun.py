"""The dry run's twin, the port of ``repro.launch.dryrun``: a planner that
runs nothing.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --list
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-v2-lite-16b \\
        --shape decode_32k --mesh multi
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single [--force]

JAX's dry run lowers and compiles each (arch x shape) cell on the
production meshes (``launch.mesh.make_production_mesh``: data 16 x model
16, or pod 2 x data 16 x model 16) over 256 or 512 fake devices, and
reads XLA's per-device memory, its HLO counts and a roofline off the
compiled program. The port compiles nothing: its model has no FSDP or
tensor-parallel partitioner, so no program of a cell exists to read.
What it computes exactly is each device's argument bytes: the block of
every input of the cell's step that the sharding plan
(``distributed.partition_spec`` under ``cell_rules``) gives one device,
by group (parameters, optimizer state, decode cache, batch). These are
the bytes XLA reports as the compiled step's ``argument_size_in_bytes``
(the tests hold them to the byte). They are the plan's bytes, not a
device measurement. It also gives ``model_flops`` and the time those
FLOPs take at the card's peak. Nothing here touches a device, imports
JAX or sets ``XLA_FLAGS``.

The hardware model is one H100 SXM's: ``PEAK_FLOPS`` from NVIDIA's data
sheet (dense bf16, without sparsity), ``HBM_PER_CHIP`` the
``total_memory`` torch reports on an "NVIDIA H100 80GB HBM3, 700.00 W"
(``nvidia-smi --query-gpu=name,power.limit``). JAX's ``HBM_BW`` (read
only for ``memory_s``), ``ICI_BW`` and ``DCN_BW`` have no twin: the twin
counts no bytes accessed and no collective bytes.

Keys of JAX's result that need a compiled program are left out:
``lower_s``, ``compile_s``, ``memory.output_bytes``, ``temp_bytes``,
``alias_bytes`` and ``peak_est_bytes``, ``xla_cost_analysis``, ``hlo.*``,
and of ``roofline`` ``compute_s``, ``memory_s``, ``collective_s``,
``dominant``, ``step_time_s``, ``useful_flops_ratio`` and
``roofline_fraction``. Added: ``q_chunk`` (train and prefill), the
memory's breakdown by group, and ``roofline.bound_s``.

JAX's step flags and config overrides (``--moe-mode``, ``--grad-sync``,
``--microbatches``, ``--remat``, ``--cf``, ``--ssd-chunk``,
``--ssd-bf16``, ``--mla-absorb``, ``--compress-dcn``) have no twin: each
changes only the compiled step, never the shape of an input, so no
number of the plan depends on it. ``microbatches`` is the count JAX's
step takes by default (``MICROBATCH``). Plans are written under
``results/dryrun_torch``, beside and apart from JAX's ``results/dryrun``,
whose files carry the compiled-program keys that its readers
(``benchmarks/run.py``, ``benchmarks/roofline_table.py``) expect.

``cell_state`` is the twin of JAX's ``build_cell``: the same groups of
inputs, with no step built. ``make_hints`` and ``_strip_ambient_manual``
have no twin: they are ``with_sharding_constraint`` layout hints under
``jit``, like ``distributed.sharding.constrain``. Nor has
``launch/hlo_analysis.py``, which parses the HLO text of XLA's compiled
program.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from repro_torch.configs import all_cells, all_skips, get_config, get_shape
from repro_torch.distributed.sharding import (DEFAULT_RULES, NamedSharding,
                                              ShardingRules, partition_spec)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.models import lm
from repro_torch.models.common import ArraySpec, ModelConfig, ShapeConfig
from repro_torch.utils import tree_size_bytes

# --- hardware model (one H100 SXM) ------------------------------------------
PEAK_FLOPS = 989e12          # bf16 FLOP/s per card, dense
HBM_PER_CHIP = 85_017_493_504  # torch's total_memory, NVIDIA H100 80GB HBM3, 700.00 W

#: the JAX package's ``ModelConfig.flash_q_chunk``, 512 in every config;
#: the port's config has no such field (its flash tiles are fixed)
FLASH_Q_CHUNK = 512

# microbatch counts for train cells (activation-memory control)
MICROBATCH = {
    "qwen2-72b": 8, "llava-next-34b": 8,
    "zamba2-2.7b": 8, "mamba2-130m": 8,
    # one big microbatch amortizes FSDP/SP gathers
    "deepseek-v2-lite-16b": 1, "qwen2-moe-a2.7b": 1,
    "starcoder2-3b": 2, "granite-3-2b": 2, "gemma-2b": 2,
    "hubert-xlarge": 2,
}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _float_to(dtype):
    def f(s: ArraySpec) -> ArraySpec:
        if s.dtype.is_floating_point:
            return dataclasses.replace(s, dtype=dtype)
        return s
    return f


def serving_param_defs(cfg: ModelConfig):
    """Serving keeps weights in compute dtype (bf16)."""
    return _tree_map(_float_to(cfg.compute_dtype), lm.param_defs(cfg))


def cell_rules(cfg: ModelConfig, shape: ShapeConfig, mesh) -> ShardingRules:
    """Per-cell sharding rules, JAX's.

    Decode: pure tensor parallelism, no FSDP ("embed" -> data) on serving
    weights: FSDP'd weights make the QKV projections a partial sum over
    "data", which XLA pushes through the cache update, all-reducing the
    whole stacked cache every step. MLA latent caches (no head dim) and
    GQA caches whose kv-head count does not divide the model axis are
    sequence-sharded instead.
    """
    rules = DEFAULT_RULES
    if shape.is_decode:
        model_size = mesh.shape.get("model", 1)
        if cfg.mla is not None:
            rules = rules.override(embed=(), kv_embed=(),
                                   kv_heads=(), kv_seq=("model",))
        elif cfg.num_kv_heads % model_size != 0:
            rules = rules.override(kv_heads=(), kv_seq=("model",))
    return rules


def pick_q_chunk(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """q-chunk so that the q-block count divides the model axis when the
    arch needs context-parallel attention (heads % model != 0)."""
    model_size = mesh.shape.get("model", 1)
    if cfg.num_heads % model_size == 0:
        return FLASH_Q_CHUNK
    qc = FLASH_Q_CHUNK
    while qc > 128 and (shape.seq_len // qc) % model_size != 0:
        qc //= 2
    return qc


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic MODEL_FLOPS: 6·N·D (train) / 2·N·D (inference tokens)."""
    n_active = cfg.active_param_count()
    embed = cfg.vocab_size * cfg.d_model
    n = max(n_active - embed, 1)
    if shape.step == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n * toks
    if shape.step == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n * toks
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def _blocks(defs, rules: ShardingRules, mesh):
    """Each spec of ``defs`` -> the spec of one device's block of it."""
    def block(s: ArraySpec) -> ArraySpec:
        sharding = NamedSharding(mesh, partition_spec(s, rules, mesh))
        return dataclasses.replace(s, shape=sharding.shard_shape(s.shape))
    return _tree_map(block, defs)


def cell_state(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """The inputs that JAX's ``build_cell`` passes to its jitted step ->
    {group: bytes one device holds}: train ``params`` (f32, from
    ``lm.param_defs``), ``opt`` (AdamW's f32 ``m`` and ``v`` and its int32
    ``count``) and ``batch``; prefill serving ``params`` and ``batch``;
    decode serving ``params``, ``cache`` (``lm.cache_defs``) and
    ``batch``. Every group is sharded by ``cell_rules``."""
    rules = cell_rules(cfg, shape, mesh)
    if shape.step == "train":
        defs = lm.param_defs(cfg)
        f32 = _tree_map(_float_to(torch.float32), defs)
        groups = {"params": defs,
                  "opt": {"m": f32, "v": f32, "count": ArraySpec((), torch.int32, ())}}
    elif shape.step == "prefill":
        groups = {"params": serving_param_defs(cfg)}
    else:
        groups = {"params": serving_param_defs(cfg),
                  "cache": lm.cache_defs(cfg, shape.global_batch, shape.seq_len)}
    groups["batch"] = input_specs(cfg, shape)
    return {name: tree_size_bytes(_blocks(defs, rules, mesh))
            for name, defs in groups.items()}


def run_cell(arch: str, shape_name: str, mesh_kind: str) -> dict:
    """One cell's plan on the production mesh (``mesh_kind`` ``single``
    or ``multi``)."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    n_dev = mesh.size
    mb = MICROBATCH.get(arch, 1) if shape.step == "train" else 1
    groups = cell_state(cfg, shape, mesh)
    mf = model_flops(cfg, shape) / n_dev
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "step": shape.step, "devices": n_dev, "microbatches": mb,
        "q_chunk": (pick_q_chunk(cfg, shape, mesh)
                    if shape.step in ("train", "prefill") else None),
        "memory": {
            "argument_bytes": sum(groups.values()),
            "params_bytes": groups["params"],
            "opt_bytes": groups.get("opt", 0),
            "cache_bytes": groups.get("cache", 0),
            "batch_bytes": groups["batch"],
            "hbm_per_chip": HBM_PER_CHIP,
        },
        "roofline": {
            "model_flops_per_dev": mf,
            "bound_s": mf / PEAK_FLOPS,
        },
    }


def _write_cell(res: dict, out: str) -> None:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(res, f, indent=2)
    print(f"{res['arch']} {res['shape']} [{res['mesh']}] "
          f"args={res['memory']['argument_bytes'] / 2**30:.2f}GiB "
          f"bound={res['roofline']['bound_s']:.4f}s")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    if args.list:
        for arch, shp in all_cells():
            print(f"{arch:24s} {shp}")
        for arch, shp, why in all_skips():
            print(f"{arch:24s} {shp:12s} SKIP: {why}")
        return

    if args.all:
        # in this process: no device count to lock; skip existing files
        for arch, shp in all_cells():
            out = _cell_path(args.out, args.mesh, arch, shp, args.tag)
            if os.path.exists(out) and not args.force:
                print(f"skip (exists): {out}")
                continue
            _write_cell(run_cell(arch, shp, args.mesh), out)
        print("all cells OK")
        return

    if not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all, or --list")
    _write_cell(run_cell(args.arch, args.shape, args.mesh), _cell_path(args.out, args.mesh, args.arch, args.shape,
                                args.tag))


def _cell_path(out, mesh, arch, shape, tag=""):
    suffix = f"__{tag}" if tag else ""
    return os.path.join(out, mesh, f"{arch}__{shape}{suffix}.json")


if __name__ == "__main__":
    main()
