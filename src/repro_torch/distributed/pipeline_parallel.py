"""GPipe-style pipeline parallelism over the "pod" axis, the port of
``repro.distributed.pipeline_parallel``.

Another use of the costly inter-pod link: instead of a pod-level
data-parallel all-reduce, pipeline STAGES map onto pods, and the link
carries only microbatch boundary activations, point to point
(``exchange.ppermute``), the cheapest inter-pod pattern (in the paper's
terms: one blob a hop instead of an all-to-all).

``gpipe_apply`` runs the classic fill/drain schedule:

    step t: stage s computes microbatch (t - s) if 0 <= t - s < n_micro,
            then passes its activation to stage s + 1.

The other axes of the mesh replicate, as JAX's ``shard_map`` manual over
the stage axis alone leaves them. On a ``StackedMesh`` every stage runs
in this process, each once (a replica would compute the same), one
stage's microbatch at a time: the calls a ``ProcessGroupMesh`` process
makes, so the two back ends agree bit for bit. The stacked schedule is
plain tensor algebra, so autograd differentiates through it. On a
``ProcessGroupMesh`` each process runs its own stage and differentiates
as JAX's ``shard_map`` transposes: each hop's adjoint is the reverse hop,
``x``'s cotangent (``P()``) is summed over the stage axis and each
parameter's (``P(stage_axis)``) gathered over it, on every process, and
nothing is summed over the axes that replicate (``exchange.shard`` with
``manual=(stage_axis,)``). A stage that reads neither ``x`` nor a hop's
output would not reach their backward collectives, and a ``stage_fn``
may close over a weight that requires grad in some stages only: so the
stages agree on what records (``record_together``, up front and before
each hop), and the result is joined to every recorded collective
(``reach``), so that every process posts the same backward collectives
in the same order.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.launch.mesh import StackedMesh
from repro_torch.shuffle import exchange


def gpipe_apply(stage_fn: Callable, params: Dict[str, torch.Tensor],
                x: torch.Tensor, *, mesh, n_micro: int,
                stage_axis: str = "pod") -> torch.Tensor:
    """Run a pipelined stack of ``n_stages = mesh.shape[stage_axis]``.

    stage_fn(stage_params, x_mb) -> y_mb  (same shape as x_mb)
    params: dict of tensors, each with a leading stage dim.
    x: (batch, ...) global input; batch % n_micro == 0.

    Returns y with the shape of x, equal to applying the stages in order
    (stage 0 first), on every rank.
    """
    if stage_axis not in mesh.shape:
        raise ValueError(f"the mesh {mesh.axis_names} has no {stage_axis!r} axis")
    n_stages = mesh.shape[stage_axis]
    B = x.shape[0]
    if not isinstance(n_micro, int) or n_micro < 1 or B % n_micro:
        raise ValueError(f"a batch of {B} does not split into {n_micro!r} "
                         f"microbatches")
    for name, leaf in params.items():
        if leaf.dim() < 1 or leaf.shape[0] != n_stages:
            raise ValueError(f"params[{name!r}] of shape {tuple(leaf.shape)} "
                             f"needs a leading dim of the {n_stages} stages "
                             f"along {stage_axis!r}")
    axes = (stage_axis,)
    if isinstance(mesh, StackedMesh):
        ex = exchange.for_mesh(StackedMesh(axes, (n_stages,)))
        stages = list(range(n_stages))
        local = [{k: v[s] for k, v in params.items()} for s in stages]
        x_in, recorded = x, []
    else:
        ex = exchange.for_mesh(mesh)
        stages = [mesh.coords[stage_axis]]
        # the stages record alike; the cotangents sum over the stage axis
        # alone: x's (read by stage 0 only) and each leaf's, gathered
        x_in, *leaves = ex.record_together(axes, x, *params.values())
        x_in = ex.shard(x_in, (), manual=axes)[0]
        blocks = [ex.shard(v, axes, manual=axes)[0, 0] for v in leaves]
        local = [dict(zip(params, blocks))]
        recorded = [x_in, *blocks]
    x_micro = x_in.reshape(n_micro, B // n_micro, *x.shape[1:])
    last = n_stages - 1

    buf = x_micro.new_zeros((len(stages),) + x_micro.shape[1:])
    done = [None] * n_micro            # the last stage's finished microbatches
    for t in range(n_micro + n_stages - 1):
        ys = []
        for r, s in enumerate(stages):
            m = t - s
            if 0 <= m < n_micro:
                # stage 0 takes fresh microbatches, the others what came in
                y = stage_fn(local[r], x_micro[m] if s == 0 else buf[r])
                if s == last:
                    done[m] = y
            else:
                y = buf[r]             # an idle stage passes its buffer on
            ys.append(y)
        (ys,) = ex.record_together(axes, torch.stack(ys))
        # one hop downstream; the last stage's wraps to stage 0, unread
        buf = ex.ppermute(ys, stage_axis)
        recorded.append(buf)
    # the result lives on the last stage; share it with every stage
    out = torch.stack([torch.stack(done) if s == last else torch.zeros_like(x_micro)
                       for s in stages])
    return ex.psum(ex.reach(out, *recorded), axes)[0].reshape(x.shape)
