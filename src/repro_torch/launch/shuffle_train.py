"""MoE training fed by the BlobShuffle engine, with crash and resume:
``python -m repro_torch.launch.shuffle_train [--steps 12] [--crash-at N | --resume]``

The port of the JAX package's ``examples/moe_blobshuffle_train.py``.
Step-keyed token records flow source -> Batcher -> blob -> zonal object
store -> notification log -> Debatcher, and ``ShuffleFedInput``
reassembles the deliveries into batches, double-buffered ahead of the
port's ``make_train_step`` on the test mesh (pod 2, data 2, model 2,
stacked on ``--device``, default ``cuda``). deepseek-v2-lite SMOKE's MoE
layers take the blob shuffle (``--mode blob``, capacity factor 2.0);
``--grad-sync`` picks the gradient sync.

Model and optimizer state checkpoint through ``BlobCheckpointer`` over a
``SimulatedS3`` under ``TieredCheckpointStore`` (synchronous uploads, a
manifest every 4 steps), with the pipeline's committed per-partition
offsets in the manifest. ``--crash-at N`` dies mid-step N and pickles
the store to ``ckpt_file()`` in the temporary directory (another name
than the JAX example's file); ``--resume``, a fresh process, unpickles
it, restores the last manifest, replays the engine's virtual clock past
the committed prefix, and continues with a loss trajectory
bit-identical to an uninterrupted run. A real deployment
points ``TieredCheckpointStore`` at a durable bucket instead.

    python -m repro_torch.launch.shuffle_train --steps 12
    python -m repro_torch.launch.shuffle_train --steps 12 --crash-at 6
    python -m repro_torch.launch.shuffle_train --steps 12 --resume

``main(argv)`` returns the run's ``ShuffleTrainResult``.
"""

from __future__ import annotations

import argparse
import os
import pickle
import tempfile


def ckpt_file() -> str:
    """Where a crashed run leaves its checkpoint store for ``--resume``."""
    return os.path.join(tempfile.gettempdir(), "repro_torch_shuffle_train_ckpt.pkl")


def make_engine():
    """Fresh deterministic shuffle engine: zonal store, 3 instances,
    exactly-once, with an AZ-1 outage mid-stream for flavor."""
    from repro_torch.cluster import ElasticCluster
    from repro_torch.core import (AsyncShuffleEngine, BlobShuffleConfig,
                                  EngineConfig)
    from repro_torch.core.stores import ExpressOneZoneStore

    eng = AsyncShuffleEngine(
        BlobShuffleConfig(batch_bytes=4096, max_interval_s=0.02,
                          num_partitions=9, num_az=3),
        EngineConfig(commit_interval_s=0.15), n_instances=3,
        store=ExpressOneZoneStore(seed=7, num_az=3), seed=5,
        exactly_once=True)
    ElasticCluster(eng, mode="cooperative").az_outage_at(0.3, 1)
    return eng


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--mode", default="blob",
                    choices=["dense", "direct", "blob"])
    ap.add_argument("--grad-sync", default="auto",
                    choices=["auto", "blob", "blob_int8"])
    ap.add_argument("--crash-at", type=int, default=None,
                    help="die mid-step N (then rerun with --resume)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the last manifest and continue")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.checkpoint import BlobCheckpointer, TieredCheckpointStore
    from repro_torch.configs import get_config
    from repro_torch.core.stores import SimulatedS3
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.shuffle.api import ShuffleConfig
    from repro_torch.train_input import TokenStreamConfig, train_shuffle_fed
    from repro_torch.training import OptConfig, TrainConfig

    mesh = make_test_mesh(devices=8)
    print(f"mesh: {mesh.shape}  devices: {mesh.size}")
    cfg = get_config("deepseek-v2-lite-16b", smoke=True)
    shuf = ShuffleConfig(mode=args.mode,
                         token_axes=("pod", "data", "model"),
                         expert_axes=("pod", "model"),
                         capacity_factor=2.0)
    tcfg = TrainConfig(opt=OptConfig(learning_rate=3e-3, warmup_steps=5,
                                     total_steps=args.steps),
                       shuffle=shuf, grad_sync=args.grad_sync,
                       grad_sync_blob_bytes=1 << 16)
    stream = TokenStreamConfig(vocab_size=cfg.vocab_size, batch=8,
                               seq_len=32, seed=0)
    if args.resume:
        with open(ckpt_file(), "rb") as f:
            store = pickle.load(f)
    else:
        store = SimulatedS3(seed=404)
    ckpt = BlobCheckpointer(TieredCheckpointStore(store),
                            async_upload=False)

    res = train_shuffle_fed(
        cfg, tcfg, mesh, stream, steps=args.steps,
        engine_factory=make_engine, ckpt=ckpt, ckpt_every=4,
        resume=args.resume, crash_at_step=args.crash_at,
        pipeline_kwargs={"step_interval_s": 0.05, "prefetch_steps": 2},
        device=args.device)

    st = res.input_stats
    for s, loss in zip(res.steps, res.losses):
        if s % 4 == 0 or s == args.steps - 1:
            print(f"step {s:3d} loss {loss:.4f}")
    print(f"input: {st['records_delivered']} records delivered, "
          f"{st['records_replayed']} replayed across the AZ outage, "
          f"overlap {st['overlap_fraction']:.0%}")
    if res.crashed:
        with open(ckpt_file(), "wb") as f:
            pickle.dump(store, f)
        print(f"CRASHED mid-step {args.crash_at} — rerun with --resume")
    elif res.losses:
        if not res.losses[-1] < res.losses[0]:
            raise RuntimeError("loss did not decrease")
        print(f"OK mode={args.mode} grad_sync={args.grad_sync} "
              f"start_step={res.start_step} "
              f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}")
    return res


if __name__ == "__main__":
    main()
