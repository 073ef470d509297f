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
reduced config, ``--full`` the published one. One device runs no mesh,
so the blob gradient-sync modes take the plain step there, as the JAX
launcher does on one device.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch


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

    from repro_torch.checkpoint import FileStore
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch_stream
    from repro_torch.models import lm
    from repro_torch.models.common import init_params
    from repro_torch.runtime import FaultTolerantTrainer
    from repro_torch.shuffle.api import ShuffleConfig
    from repro_torch.training import (OptConfig, TrainConfig, adamw_init,
                                      make_train_step)

    device = torch.device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    params = init_params(lm.LM(cfg, device=device),
                         torch.Generator(device=device).manual_seed(0))
    opt = adamw_init(params)
    shuf = ShuffleConfig(mode=args.moe_mode if cfg.moe else "dense")
    tcfg = TrainConfig(opt=OptConfig(learning_rate=args.lr, total_steps=args.steps),
                       microbatches=args.microbatches, shuffle=shuf,
                       grad_sync=args.grad_sync)
    step = make_train_step(cfg, tcfg)
    batch_fn = lm_batch_stream(cfg.vocab_size, args.batch, args.seq,
                               multimodal=cfg.multimodal, d_model=cfg.d_model,
                               device=device)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"arch={cfg.name} params={n_params:,} device={device}")

    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             f"repro_ckpt_{args.arch}")
    trainer = FaultTolerantTrainer(FileStore(ckpt_dir), step, batch_fn,
                                   ckpt_every=args.ckpt_every)
    t0 = time.perf_counter()
    params, opt, losses = trainer.run(params, opt, steps=args.steps)
    print(f"done: {args.steps} steps in {time.perf_counter() - t0:.1f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; ckpt={ckpt_dir}")
    return losses


if __name__ == "__main__":
    main()
