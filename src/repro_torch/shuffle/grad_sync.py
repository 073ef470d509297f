"""Blob-bucketed hierarchical cross-pod gradient synchronization, the port
of ``repro.shuffle.grad_sync``.

The BlobShuffle pattern applied to data parallelism across pods: the
cross-pod ("cross-AZ") reduction of the gradients is

  * **bucketed** into ~``blob_bytes`` flat blobs (the ``S_batch`` knob:
    it amortizes the per-collective cost as batching amortizes the
    per-request S3 cost), at most ``MAX_BLOBS`` of them;
  * optionally **int8-compressed** on the pod leg (the divide form of
    ``shuffle.compression``, the JAX package's arithmetic), with optional
    **error feedback** (``residual``).

Exact algorithm per blob (P pods): reshape (P, n/P) -> all-to-all over
the pod axis (each pod receives every pod's copy of its shard) ->
dequantize and sum locally -> requantize -> all-gather. Bytes each pod
sends across pods: 2 (P - 1) / P * n * itemsize (itemsize 1 when
compressed, 4 when not; compressed, each blob adds 2 (P - 1) f32 scales).

The JAX functions run inside a ``shard_map`` manual over the pod axis.
Here the gradient tree's leaves carry a leading axis of this process's
pods, and the collectives are the exchange's over ``pod_axis``
(``pod_exchange``): on a ``StackedMesh`` every pod's gradients, (P, ...)
leaves; on a ``ProcessGroupMesh`` this process's pod's, (1, ...). A tree
is a tensor, or a dict (flattened in sorted key order, as ``jax.tree``
does), list or tuple of trees.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import ProcessGroupMesh, StackedMesh
from repro_torch.shuffle import compression
from repro_torch.shuffle.exchange import for_mesh

Tree = Any

MAX_BLOBS = 32  # cap on the number of collectives, as in the JAX package


def pod_exchange(mesh, pod_axis: str = "pod"):
    """The exchange over which a pod-stacked gradient tree is reduced: a
    stacked mesh of the pod axis alone (each pod's gradients are the same
    on all of its ranks), or the process-group mesh itself."""
    if isinstance(mesh, StackedMesh):
        return for_mesh(StackedMesh((pod_axis,), (mesh.shape[pod_axis],)))
    if isinstance(mesh, ProcessGroupMesh):
        return for_mesh(mesh)
    raise TypeError(f"no gradient sync over a mesh of type {type(mesh).__name__}")


def _leaves(tree: Tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _rebuild(tree: Tree, leaves) -> Tree:
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, leaves) for t in tree)
    return next(leaves)


def _flatten_to_blobs(tree: Tree, blob_bytes: int):
    """Concatenate each pod's leaves (as f32) and split them into
    ~blob_bytes blobs: (R, n_blobs, n_per_blob). The blob count is capped
    at ``MAX_BLOBS``, so very large gradients get larger blobs."""
    leaves = _leaves(tree)
    R = leaves[0].shape[0]
    size = sum(l[0].numel() for l in leaves)
    n_per_blob = max(blob_bytes // 4, 1)
    n_blobs = min(max(-(-size // n_per_blob), 1), MAX_BLOBS)
    n_per_blob = -(-size // n_blobs)
    blobs = leaves[0].new_zeros((R, n_blobs * n_per_blob), dtype=torch.float32)
    off = 0
    for l in leaves:
        n = l[0].numel()
        blobs[:, off:off + n] = l.reshape(R, n)
        off += n
    meta = (tree, [(tuple(l.shape[1:]), l.dtype) for l in leaves], size)
    return blobs.view(R, n_blobs, n_per_blob), meta


def _unflatten_from_blobs(blobs: torch.Tensor, meta) -> Tree:
    tree, shapes, size = meta
    R = blobs.shape[0]
    flat = blobs.reshape(R, -1)
    out, off = [], 0
    for shape, dtype in shapes:
        n = math.prod(shape)
        out.append(flat[:, off:off + n].reshape(R, *shape).to(dtype))
        off += n
    return _rebuild(tree, iter(out))


def _blob_allreduce(blob: torch.Tensor, ex, pod_axis: str, npods: int,
                    compress: bool) -> torch.Tensor:
    """All-reduce each pod's (n,) blob, (R, n), across pods: all-to-all,
    local sum, all-gather."""
    if npods == 1:
        return blob
    R, n = blob.shape
    pad = (-n) % npods
    x = F.pad(blob, (0, pad)).reshape(R, npods, -1)
    if compress:
        q, s = compression.int8_quantize(x)
        q = ex.all_to_all(q, (pod_axis,))
        s = ex.all_to_all(s, (pod_axis,))
        shard = torch.sum(compression.int8_dequantize(q, s, torch.float32), dim=1)
        qr, sr = compression.int8_quantize(shard[:, None, :])
        qg = ex.all_gather(qr[:, 0], (pod_axis,))
        sg = ex.all_gather(sr, (pod_axis,))
        full = compression.int8_dequantize(qg, sg[..., 0], torch.float32)
    else:
        x = ex.all_to_all(x, (pod_axis,))
        shard = torch.sum(x, dim=1)
        full = ex.all_gather(shard, (pod_axis,))
    out = full.reshape(R, -1)
    return out[:, :n] if pad else out


def _pod_bytes(n_blobs: int, n_per_blob: int, npods: int, compress: bool) -> float:
    """Bytes each pod sends to the other pods in one sync."""
    if npods == 1:
        return 0.0
    n = n_per_blob + (-n_per_blob) % npods
    per_blob = 2 * (npods - 1) / npods * n * (1 if compress else 4)
    if compress:
        per_blob += 2 * (npods - 1) * 4
    return n_blobs * per_blob


@torch.no_grad()
def blob_allreduce_grads(grads: Tree, *, exchange, pod_axis: str = "pod",
                         blob_bytes: int = 16 * 1024 * 1024,
                         compress: bool = False,
                         residual: Optional[torch.Tensor] = None,
                         average: bool = True
                         ) -> Tuple[Tree, Optional[torch.Tensor], float]:
    """Hierarchically all-reduce a pod-stacked gradient tree across pods.

    ``residual``: error-feedback state (the blobs' shape, from
    ``residual_init``) when compressing; None disables it. Returns
    (synced grads, new residual or None, bytes each pod sent across pods).
    """
    ex = exchange
    npods = ex.axis_size([pod_axis])
    blobs, meta = _flatten_to_blobs(grads, blob_bytes)
    R, n_blobs, n_per_blob = blobs.shape
    target = blobs + residual if compress and residual is not None else blobs

    # one collective per blob, as the JAX package emits them
    reduced = torch.empty_like(target)
    for i in range(n_blobs):
        reduced[:, i] = _blob_allreduce(target[:, i], ex, pod_axis, npods, compress)

    new_residual = None
    if compress and residual is not None:
        # what this pod contributed against what went out on the wire
        sent = torch.stack([compression.compress_decompress(target[:, i])
                            for i in range(n_blobs)], dim=1)
        new_residual = target - sent
    if average:
        reduced.div_(torch.full((), npods, dtype=reduced.dtype, device=reduced.device))
    return (_unflatten_from_blobs(reduced, meta), new_residual,
            _pod_bytes(n_blobs, n_per_blob, npods, compress))


def residual_init(grads_like: Tree, blob_bytes: int = 16 * 1024 * 1024
                  ) -> torch.Tensor:
    """Zero error-feedback state for gradients shaped like ``grads_like``."""
    blobs, _ = _flatten_to_blobs(grads_like, blob_bytes)
    return torch.zeros_like(blobs)
