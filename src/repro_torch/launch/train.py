"""Training launcher of the port:
``python -m repro_torch.launch.train --arch <id> ...``

``training.make_train_step`` driven by ``runtime.FaultTolerantTrainer``
over a ``checkpoint.FileStore``, as ``repro.launch.train`` runs it:
parameters drawn from seed 0 on ``--device`` (default ``cuda``), batches
from ``data.lm_batch_stream`` (frames or patches for the configs with a
stub frontend), a blob checkpoint at step 0, every ``--ckpt-every``
steps and at the end into ``--ckpt-dir`` (default
``repro_ckpt_<arch>`` in the temporary directory, JAX's
``/tmp/repro_ckpt_<arch>``), in the JAX package's layout, the loss
printed at the first and the last step. The default ``--arch`` is
granite-3-2b, as in the JAX launcher. ``--smoke`` (default) takes the
reduced config, ``--full`` the published one.

One process runs no mesh, so the blob gradient-sync modes take the plain
step there, as the JAX launcher does on one device. Over several
``torch.distributed`` processes (torchrun's ``WORLD_SIZE`` above 1, or a
default process group of more than one process that the caller has
initialised) the launcher lays the JAX launcher's
``make_test_mesh(devices=n)`` axes over the n processes, one rank a
process (``launch.mesh.process_group_test_mesh``: 8 -> pod 2 x data 2 x
model 2, 4 -> data 2 x model 2, else data n), and passes that mesh to
``make_train_step``; so ``--grad-sync blob`` takes the blob step only
where the mesh has a pod axis (8 processes), as on JAX's devices. A
group it finds uninitialised it initialises from the environment
(``env://``): NCCL for ``--device cuda``, each process on
``cuda:<LOCAL_RANK>``, gloo for ``--device cpu``; it destroys that group
at the end. Every process draws the same parameters and batches (each
takes the global batch, where JAX's device takes its block); before the
first step the processes compare a digest of their initial parameters
and all raise if any differs. Each process checkpoints its whole state
into its own directory, ``<ckpt-dir>/process<rank>``, in JAX's layout,
so no two processes write one path. Only rank 0 prints.

    torchrun --nproc-per-node 8 -m repro_torch.launch.train \
        --arch deepseek-v2-lite-16b --smoke --grad-sync blob_int8
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch deepseek-v2-lite-16b --smoke --moe-mode blob --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch
import torch.distributed as dist


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--moe-mode", default="dense", choices=["dense", "direct", "blob"])
    ap.add_argument("--grad-sync", default="auto", choices=["auto", "blob", "blob_int8"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    ours = world > 1 and not dist.is_initialized()
    if world > 1 and device.type == "cuda" and device.index is None:
        if "LOCAL_RANK" not in os.environ:
            raise ValueError(f"{world} processes on cuda: each needs LOCAL_RANK (torchrun "
                             f"sets it) or a --device with its index")
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if ours:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    try:
        return _train(args, device, world)
    finally:
        if ours:
            dist.destroy_process_group()


def _train(args, device: torch.device, world: int) -> list:
    from repro_torch.checkpoint import FileStore
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch_stream
    from repro_torch.launch.mesh import process_group_test_mesh
    from repro_torch.models import lm
    from repro_torch.models.common import init_params
    from repro_torch.runtime import FaultTolerantTrainer
    from repro_torch.shuffle import exchange
    from repro_torch.shuffle.api import ShuffleConfig
    from repro_torch.training import (OptConfig, TrainConfig, adamw_init,
                                      make_train_step)

    mesh = process_group_test_mesh() if world > 1 else None
    rank = dist.get_rank() if mesh is not None else 0
    cfg = get_config(args.arch, smoke=args.smoke)
    params = init_params(lm.LM(cfg, device=device),
                         torch.Generator(device=device).manual_seed(0))
    if mesh is not None:
        exchange.check_same(exchange.for_mesh(mesh),
                            exchange.digest64(list(params.parameters())), device,
                            "the initial parameters")
    opt = adamw_init(params)
    shuf = ShuffleConfig(mode=args.moe_mode if cfg.moe else "dense")
    tcfg = TrainConfig(opt=OptConfig(learning_rate=args.lr, total_steps=args.steps),
                       microbatches=args.microbatches, shuffle=shuf,
                       grad_sync=args.grad_sync)
    step = make_train_step(cfg, tcfg, mesh=mesh)
    batch_fn = lm_batch_stream(cfg.vocab_size, args.batch, args.seq,
                               multimodal=cfg.multimodal, d_model=cfg.d_model,
                               device=device)
    n_params = sum(p.numel() for p in params.parameters())
    if rank == 0:
        print(f"arch={cfg.name} params={n_params:,} device={device} processes={world}"
              + (f" mesh={mesh.shape}" if mesh is not None else ""))

    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             f"repro_ckpt_{args.arch}")
    if mesh is not None:
        ckpt_dir = os.path.join(ckpt_dir, f"process{rank}")
    trainer = FaultTolerantTrainer(FileStore(ckpt_dir), step, batch_fn,
                                   ckpt_every=args.ckpt_every)
    t0 = time.perf_counter()
    params, opt, losses = trainer.run(params, opt, steps=args.steps)
    if rank == 0:
        print(f"done: {args.steps} steps in {time.perf_counter() - t0:.1f}s; "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; ckpt={ckpt_dir}")
    return losses


if __name__ == "__main__":
    main()
