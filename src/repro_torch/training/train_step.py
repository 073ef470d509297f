"""Train-step builder, the port of ``repro.training.train_step``: the loss,
microbatch gradient accumulation in f32, the remat policy, and the
gradient-sync modes.

grad_sync modes:
  * ``auto``      the plain step: one loss over the whole batch, one
                  backward pass (on one card there is nothing to reduce).
  * ``blob``      with a mesh whose pod axis is above 1: each pod runs its
                  block of the batch as a pod-local region
                  (``ShuffleConfig.pod_local``), and the pods' gradients
                  meet in the blob-bucketed hierarchical all-reduce of
                  ``shuffle.grad_sync``.
  * ``blob_int8`` the same, with int8 on the pod leg.

The JAX package runs the blob modes inside a ``shard_map`` manual over
the pod axis. On a ``StackedMesh`` the port runs the pods in turn and
stacks their gradients on a leading pod axis; on a ``ProcessGroupMesh``
each process runs its own pod's block of the batch, as JAX's
``P("pod")`` gives it, on a gradient tree of one pod, and the processes
of a pod compute the same values. Inside the pod region both packages
pass no mesh to the loss, so its MoE layers take the dense dispatch
there whatever the shuffle mode; an expert-parallel dispatch within each
pod is left for later. ``auto`` with a mesh passes the mesh to the loss
on either back end: every process of a ``ProcessGroupMesh`` takes the
whole batch and dispatches its MoE layers over the processes, and its
gradients, metrics and parameters come out the same on every process
(the exchange's Functions, ``shuffle.exchange``), with no sync after the
backward pass; each step checks that the processes' gradient norms are
the same bits, and raises on every process if not (a replicated weight
read without ``shard(w, ())`` leaves each process its own share of its
gradient). ``cast_compute_params`` has no twin: the port's layers
cast each f32 weight to the compute dtype where they use it, which gives
the same values as casting it once at the top of the step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from repro_torch.launch.mesh import ProcessGroupMesh, StackedMesh
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig
from repro_torch.shuffle import exchange as EX
from repro_torch.shuffle import grad_sync as GS
from repro_torch.shuffle.api import ShuffleConfig
from repro_torch.training.optimizer import OptConfig, adamw_update

IGNORE = -100  # label value ignored by the loss (e.g. image-patch positions)
GRAD_SYNC = ("auto", "blob", "blob_int8")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    microbatches: int = 1
    remat: str = "full"              # none | dots | full
    shuffle: ShuffleConfig = ShuffleConfig(mode="dense")
    grad_sync: str = "auto"          # auto | blob | blob_int8
    grad_sync_blob_bytes: int = 16 * 1024 * 1024
    z_loss: float = 0.0


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Mean CE over labels != IGNORE. logits (B, S, V) any dtype; f32 math."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    idx = torch.clamp(labels.long(), 0, logits.shape[-1] - 1)
    picked = torch.gather(logits, -1, idx[..., None])[..., 0]
    ce = lse - picked
    if z_loss:
        ce = ce + z_loss * torch.square(lse)
    mask = (labels != IGNORE).to(torch.float32)
    return torch.sum(ce * mask) / torch.clamp(torch.sum(mask), min=1.0)


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig, mesh=None) -> Callable:
    """loss_fn(params, batch) -> (ce + aux, {"loss": ce, "aux_loss": aux})."""
    def loss_fn(params, batch):
        logits, aux = lm.forward(cfg, params, batch, mesh=mesh,
                                 shuffle=tcfg.shuffle, remat=tcfg.remat)
        ce = cross_entropy(logits, batch["labels"], tcfg.z_loss)
        return ce + aux, {"loss": ce, "aux_loss": aux}
    return loss_fn


def _split_micro(batch: Dict[str, torch.Tensor], k: int):
    """The batch as k microbatches along its leading axis."""
    def r(x, i):
        if isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] % k == 0:
            return x.reshape(k, x.shape[0] // k, *x.shape[1:])[i]
        return x
    return [{key: r(v, i) for key, v in batch.items()} for i in range(k)]


def _grads(loss_fn, params, batch, microbatches: int):
    """(mean gradients in f32 keyed by parameter name, mean metrics), the
    microbatches' gradients summed in f32 in turn. Every parameter of
    ``params`` becomes a leaf that requires grad."""
    params.requires_grad_(True)
    for p in params.parameters():
        p.grad = None
    micro = _split_micro(batch, microbatches) if microbatches > 1 else [batch]
    totals = None
    for mb in micro:
        loss, metrics = loss_fn(params, mb)
        loss.backward()
        metrics = {k: v.detach().to(torch.float32) for k, v in metrics.items()}
        totals = metrics if totals is None else {k: totals[k] + metrics[k] for k in totals}
    grads = {}
    for name, p in params.named_parameters():
        g = p.grad.to(torch.float32) if p.grad is not None else torch.zeros_like(
            p, dtype=torch.float32)
        p.grad = None
        grads[name] = g * (1.0 / microbatches) if microbatches > 1 else g
    if microbatches > 1:
        totals = {k: v * (1.0 / microbatches) for k, v in totals.items()}
    return grads, totals


def _check_replicated(ex, grad_norm: torch.Tensor) -> None:
    """Raise on every process of ``ex``'s mesh unless all hold the same
    gradient norm (one all-gather of a scalar)."""
    norms = ex.all_gather(grad_norm.reshape(1, 1), ex.mesh.axis_names)[0, :, 0]
    if not bool((norms == norms[0]).all()):
        raise RuntimeError(f"the processes' gradient norms differ ({norms.tolist()}): a "
                           f"replicated weight was read without exchange.shard(w, ())")


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); ``params`` (``lm.LM``) is updated in place and returned.
    Metrics: loss, aux_loss (the pods' mean in the blob modes),
    grad_norm, lr; the blob modes add ``grad_sync_bytes``, the bytes each
    pod sent across pods."""
    if tcfg.grad_sync not in GRAD_SYNC:
        raise ValueError(f"grad_sync must be one of {GRAD_SYNC}, got {tcfg.grad_sync!r}")
    loss_fn = make_loss_fn(cfg, tcfg, mesh=mesh)
    replicas = EX.for_mesh(mesh) if isinstance(mesh, ProcessGroupMesh) else None

    def plain_step(params, opt_state, batch):
        grads, metrics = _grads(loss_fn, params, batch, tcfg.microbatches)
        params, opt_state, om = adamw_update(tcfg.opt, grads, opt_state, params)
        if replicas is not None:
            _check_replicated(replicas, om["grad_norm"])
        metrics.update(om)
        return params, opt_state, metrics

    pod = tcfg.shuffle.pod_axis
    use_blob = (tcfg.grad_sync != "auto" and mesh is not None
                and pod in mesh.axis_names and mesh.shape[pod] > 1)
    if not use_blob:
        return plain_step

    compress = tcfg.grad_sync == "blob_int8"
    npods = mesh.shape[pod]
    stacked_pods = isinstance(mesh, StackedMesh)
    exchange = GS.pod_exchange(mesh, pod)
    tcfg_pod = dataclasses.replace(tcfg, shuffle=tcfg.shuffle.pod_local())
    pod_loss_fn = make_loss_fn(cfg, tcfg_pod, mesh=None)

    def pod_local_step(params, opt_state, batch):
        parts = _split_micro(batch, npods)
        if not stacked_pods:
            parts = [parts[mesh.coords[pod]]]        # this process's pod's block
        stacked, metrics = None, []
        for p_idx, part in enumerate(parts):
            grads, m = _grads(pod_loss_fn, params, part, tcfg.microbatches)
            if stacked is None:
                stacked = {n: g.new_empty((len(parts), *g.shape)) for n, g in grads.items()}
            for n, g in grads.items():
                stacked[n][p_idx] = g
            del grads
            metrics.append(m)
        synced, _, nbytes = GS.blob_allreduce_grads(
            stacked, exchange=exchange, pod_axis=pod,
            blob_bytes=tcfg.grad_sync_blob_bytes, compress=compress, average=True)
        del stacked
        # every pod holds the same synced gradients: the first pod's
        grads = {n: g[0] for n, g in synced.items()}
        if not stacked_pods:
            # every pod's metrics (JAX's pmean), averaged as on stacked pods
            keys = list(metrics[0])
            row = torch.stack([metrics[0][k] for k in keys])[None]
            every = exchange.all_gather(row, (pod,))[0]
            metrics = [dict(zip(keys, r)) for r in every]
        out = {k: torch.stack([m[k] for m in metrics]).mean() for k in metrics[0]}
        params, opt_state, om = adamw_update(tcfg.opt, grads, opt_state, params)
        out.update(om, grad_sync_bytes=nbytes)
        return params, opt_state, out

    return pod_local_step
