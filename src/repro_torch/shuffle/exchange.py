"""Collectives between the ranks of a mesh, the port's stand-in for
``shard_map`` with ``lax.all_to_all`` and ``lax.psum``.

``for_mesh(mesh)`` gives the mesh's back end. Both take and return
tensors with a leading axis of this process's ranks (``ranks`` of them),
rank-major over the mesh's axes, and offer:

  axis_size(axes)       the product of the named axes' sizes
  all_to_all(x, axes)   ``lax.all_to_all(x, axes, 0, 0, tiled=False)``:
                        x (ranks, n, ...) with n = axis_size(axes); rank
                        c's chunk j goes to the rank whose coordinates
                        along ``axes`` (major to minor in the order given)
                        have linear index j and whose other coordinates
                        are c's, and lands there at c's index
  psum(x, axes)         the sum over the ranks that differ only along
                        ``axes``, on each of them
  shard(x, axes)        a global (N, ...) array -> each rank's block of
                        ``PartitionSpec(axes)``: (ranks, N / n, ...)
  unshard(x, axes)      the inverse: the global array, read from the ranks
                        at coordinate 0 of the axes not in ``axes``
  all_gather(x, axes)   ``lax.all_gather(x, axes)``: x (ranks, ...) ->
                        (ranks, n, ...), entry j the x of the rank whose
                        coordinates along ``axes`` have linear index j
                        and whose other coordinates are this rank's
  ppermute(x, axis)     ``lax.ppermute(x, axis, perm)`` with the one-hop
                        ring ``perm = [(i, (i + 1) % n)]``: each rank's x
                        goes to the rank one further along ``axis``
                        (the last to the first), other coordinates kept
  record_together(axes, *tensors)
                        the tensors, each made to require grad where it
                        requires grad in any rank that differs only along
                        ``axes`` (the process-group back end; the stacked
                        one returns them as they are)
  reach(out, *tensors)  out, whose backward pass also runs the backward
                        of every one of ``tensors`` (the process-group back
                        end; the stacked one returns out)

``Stacked`` (a ``StackedMesh``, every rank in this process) moves tensors
by transposing rank axes; ``ProcessGroups`` (a ``ProcessGroupMesh``, one
rank a process) by ``torch.distributed``, with one group per tuple of
axes and coordinates of the other axes.

The stacked back end is plain tensor algebra, so autograd differentiates
through it (an all-to-all's adjoint is the same all-to-all, a psum's a
psum). The process-group back end moves bytes with ``torch.distributed``,
which autograd does not see: so ``all_to_all``, ``psum``, ``shard``,
``unshard``, ``all_gather`` and ``ppermute`` run inside an autograd
Function, which records a backward node only where grad is enabled and
an input requires it.

The Functions' rule: every process computes the same loss, on its own
copy of what the collectives replicate, and must get the stacked back
end's gradient of the ranks it holds. So a replicated value is read
once, as the stacked graph reads it, and each process holds the whole
cotangent of its copy:

  all_to_all   the same all-to-all (a permutation that is its own
               inverse)
  psum         the identity: the output, the same on every rank of the
               group, is read once per group, so each rank's input gets
               that one cotangent (a psum of the cotangents would count
               it once per rank)
  all_gather   this rank's own entry of the cotangent, read once per
               group as the psum's
  unshard      this rank's block of the cotangent where its coordinates
               along the other axes are 0 (the ranks the stacked version
               reads), zeros elsewhere
  shard        the sum over the whole mesh of each rank's block of the
               cotangent in its place: every process then holds the
               input's whole gradient, as every rank expands the same
               global array. It moves as a psum of the block over the
               other axes, then an all-gather of the blocks over
               ``axes``. ``shard(x, axes, manual=...)`` is
               ``shard_map`` manual over ``manual`` alone (its
               ``axis_names``): the sum runs over the manual axes only,
               as the ranks along the others compute the same thing
  ppermute     the reverse hop, ``lax.ppermute``'s transpose (the
               inverse permutation): each rank's cotangent goes to the
               rank one step back along the axis

The rule puts a duty on callers: a replicated tensor that each process
reads against its own part of the work (a weight applied to its own
tokens) enters through ``shard(w, ())`` (``ep_moe_ffn`` so passes the
router's weight), whose adjoint sums its gradient over the mesh. Read
without it, each process gets only its own share and the processes'
parameters drift apart; ``make_train_step``'s ``auto`` step checks on
every step that the processes' gradient norms agree, and raises on all
of them if not.

Every process enters the same Functions in the same order, so their
backward collectives line up (a recompute under ``torch.utils.checkpoint``
issues its forward collectives again, in every process alike): autograd
runs the nodes it reaches from the loss latest first. Where the processes
of a group could differ in what records or in what the loss reaches (a
pipeline stage that reads neither ``x`` nor its hops' output), the caller
agrees on recording (``record_together``, a flag max-reduced over the
group) and joins every recorded output to the result (``reach``).

Where every process of a ``ProcessGroupMesh`` must hold the same thing
that no collective carries (the batch each draws from its own copy of
the input, the parameters each draws from the same seed),
``digest64`` hashes its bytes and ``check_same`` compares the processes'
digests in one all-gather over the mesh, raising on every process if
any differs.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh, ProcessGroupMesh, StackedMesh


def _permuted(v: torch.Tensor, src: tuple, dst: tuple) -> torch.Tensor:
    """Permute v's leading dims, one per axis of ``src``, into ``dst``
    order."""
    return v.permute(*[src.index(a) for a in dst], *range(len(src), v.dim()))


def for_mesh(mesh):
    """The exchange back end of ``mesh``."""
    if isinstance(mesh, StackedMesh):
        return Stacked(mesh)
    if isinstance(mesh, ProcessGroupMesh):
        return ProcessGroups(mesh)
    raise TypeError(f"no exchange for a mesh of type {type(mesh).__name__}; "
                    f"the port runs StackedMesh and ProcessGroupMesh "
                    f"(repro_torch.launch.mesh)")


def digest64(arrays) -> int:
    """A signed 64-bit digest (blake2b) of ``arrays`` in order, numpy
    arrays or tensors (copied to the host), each with its shape and
    dtype."""
    h = hashlib.blake2b(digest_size=8)
    for a in arrays:
        if isinstance(a, torch.Tensor):
            h.update(f"{tuple(a.shape)} {a.dtype};".encode())
            a = a.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
        else:
            a = np.ascontiguousarray(a)
            h.update(f"{a.shape} {a.dtype};".encode())
        h.update(a.tobytes())
    return int.from_bytes(h.digest(), "little", signed=True)


def check_same(ex, digest: int, device, what: str) -> None:
    """Raise on every process of ``ex``'s mesh (a ``ProcessGroups``)
    unless all hold the same ``digest``: one all-gather over the mesh of
    an int64 on ``device``, the process group's device."""
    mine = torch.tensor([[digest]], dtype=torch.int64, device=device)
    every = ex.all_gather(mine, ex.mesh.axis_names)[0, :, 0].tolist()
    if any(d != every[0] for d in every):
        raise RuntimeError(f"{what} differ between the processes (digests by rank: "
                           f"{every})")


class _Exchange:
    ranks: int

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def axis_size(self, axes) -> int:
        shape = self.mesh.shape
        unknown = [a for a in axes if a not in shape]
        if unknown:
            raise ValueError(f"axes {unknown} are not in the mesh's "
                             f"{self.mesh.axis_names}")
        return math.prod(shape[a] for a in axes)

    def _reorder(self, t: torch.Tensor, src: tuple, dst: tuple) -> torch.Tensor:
        """t's first dim indexes the points of ``src`` (linear, major to
        minor); return it indexed over the same axes in ``dst`` order."""
        if src == dst:
            return t
        v = t.reshape(*[self.mesh.shape[a] for a in src], *t.shape[1:])
        return _permuted(v, src, dst).reshape(t.shape)

    def _in_mesh_order(self, axes) -> tuple:
        return tuple(a for a in self.mesh.axis_names if a in axes)

    def _check_split(self, x: torch.Tensor, axes) -> None:
        n = self.axis_size(axes)
        if x.dim() < 2 or x.shape[0] != self.ranks or x.shape[1] != n:
            raise ValueError(f"an all-to-all over {tuple(axes)} takes "
                             f"({self.ranks}, {n}, ...), got {tuple(x.shape)}")


class Stacked(_Exchange):
    """Every rank in this process: ``ranks`` is the mesh's size."""

    def __init__(self, mesh: StackedMesh):
        super().__init__(mesh)
        self.ranks = mesh.size

    def all_to_all(self, x: torch.Tensor, axes) -> torch.Tensor:
        axes = tuple(axes)
        self._check_split(x, axes)
        names, n = self.mesh.axis_names, len(self.mesh.axis_names)
        v = x.reshape(*self.mesh.sizes, *[self.mesh.shape[a] for a in axes],
                      *x.shape[2:])
        # swap each named rank axis with the chunk axis of the same name
        perm = list(range(v.dim()))
        for j, a in enumerate(axes):
            i = names.index(a)
            perm[i], perm[n + j] = n + j, i
        return v.permute(perm).reshape(x.shape)

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        dims = [self.mesh.axis_names.index(a) for a in axes]
        if not dims:
            return x
        v = x.reshape(*self.mesh.sizes, *x.shape[1:])
        total = v.sum(dim=dims, keepdim=True, dtype=x.dtype)
        return total.expand(v.shape).reshape(x.shape)

    def shard(self, x: torch.Tensor, axes) -> torch.Tensor:
        axes = tuple(axes)
        n = self.axis_size(axes)
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not split over {axes} "
                             f"({n} blocks)")
        v = x.reshape(*[self.mesh.shape[a] for a in axes], x.shape[0] // n,
                      *x.shape[1:])
        v = _permuted(v, axes, self._in_mesh_order(axes))
        rest = v.shape[len(axes):]
        v = v.reshape(*[self.mesh.shape[a] if a in axes else 1
                        for a in self.mesh.axis_names], *rest)
        return v.expand(*self.mesh.sizes, *rest).reshape(self.ranks, *rest)

    def unshard(self, x: torch.Tensor, axes) -> torch.Tensor:
        axes = tuple(axes)
        v = x.reshape(*self.mesh.sizes, *x.shape[1:])
        v = v[tuple(slice(None) if a in axes else 0 for a in self.mesh.axis_names)]
        v = _permuted(v, self._in_mesh_order(axes), axes)
        return v.reshape(-1, *x.shape[2:])

    def all_gather(self, x: torch.Tensor, axes) -> torch.Tensor:
        axes = tuple(axes)
        names, n = self.mesh.axis_names, len(self.mesh.axis_names)
        inner = [names.index(a) for a in axes]
        outer = [i for i in range(n) if i not in inner]
        v = x.reshape(*self.mesh.sizes, *x.shape[1:])
        # the gathered entries of each point of the other axes, in the
        # order of ``axes``; then the same entries on every rank of it
        v = v.permute(*outer, *inner, *range(n, v.dim()))
        v = v.reshape(*[self.mesh.sizes[i] if i in outer else 1 for i in range(n)],
                      self.axis_size(axes), *x.shape[1:])
        return v.expand(*self.mesh.sizes, *v.shape[n:]).reshape(
            self.ranks, -1, *x.shape[1:])

    def ppermute(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        self.axis_size((axis,))
        v = x.reshape(*self.mesh.sizes, *x.shape[1:])
        return torch.roll(v, 1, dims=self.mesh.axis_names.index(axis)).reshape(x.shape)

    def record_together(self, axes, *tensors: torch.Tensor) -> list:
        """Every rank is in this process: the tensors as they are."""
        return list(tensors)

    def reach(self, out: torch.Tensor, *tensors: torch.Tensor) -> torch.Tensor:
        """No backward collective waits on a node autograd does not reach:
        out as it is."""
        return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ex, axes):
        ctx.ex, ctx.axes = ex, axes
        return ex._all_to_all(x, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.ex._all_to_all(g, ctx.axes), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ex, axes):
        return ex._psum(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ex, axes):
        ctx.j = ex._block(axes)
        return ex._all_gather(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.j], None, None


class _Unshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ex, axes):
        ctx.n, ctx.b = ex.axis_size(axes), ex._block(axes)
        ctx.read = all(c == 0 for a, c in ex.coords.items() if a not in axes)
        out = ex._all_gather(x, axes)[0] if axes else x
        return out.reshape(-1, *x.shape[2:])

    @staticmethod
    def backward(ctx, g):
        block = g.reshape(ctx.n, -1, *g.shape[1:])[ctx.b:ctx.b + 1]
        return (block if ctx.read else torch.zeros_like(block)), None, None


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ex, axes, manual):
        ctx.ex, ctx.axes, ctx.manual = ex, axes, manual
        n, b = ex.axis_size(axes), ex._block(axes)
        return x.reshape(n, -1, *x.shape[1:])[b:b + 1]

    @staticmethod
    def backward(ctx, g):
        # the block's cotangents summed over the processes that hold the
        # same block, then the blocks gathered: every process the whole sum
        ex, axes = ctx.ex, ctx.axes
        rest = tuple(a for a in ctx.manual if a not in axes)
        if rest:
            g = ex._psum(g, rest)
        if axes:
            g = ex._all_gather(g, axes)[0]
        return g.reshape(-1, *g.shape[2:]), None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ex, axis):
        ctx.ex, ctx.axis = ex, axis
        return ex._ppermute(x, axis, 1)

    @staticmethod
    def backward(ctx, g):
        # the inverse permutation: each cotangent one hop back
        return ctx.ex._ppermute(g, ctx.axis, -1), None, None


class _Reach(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, *tensors):
        ctx.n = len(tensors)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        # nothing flows to ``tensors``; their nodes run all the same,
        # on a cotangent of zeros
        return (g,) + (None,) * ctx.n


class ProcessGroups(_Exchange):
    """One rank a process over ``torch.distributed``: ``ranks`` is 1."""
    ranks = 1

    def __init__(self, mesh: ProcessGroupMesh):
        super().__init__(mesh)
        self.coords = mesh.coords

    def _group(self, axes):
        """This process's group over ``axes``: the ranks that share its
        coordinates along the other axes, in mesh order. Every process
        makes every group of a tuple of axes the first time any uses it,
        as ``torch.distributed`` requires."""
        import torch.distributed as dist

        key = self._in_mesh_order(axes)
        group = self.mesh.groups.get(key)
        if group is None:
            names = self.mesh.axis_names
            ranks = np.arange(self.mesh.size).reshape(self.mesh.sizes)
            inner = [names.index(a) for a in key]
            outer = [i for i in range(len(names)) if i not in inner]
            lists = np.transpose(ranks, outer + inner).reshape(
                -1, self.axis_size(key)).tolist()
            group, _ = dist.new_subgroups_by_enumeration(lists)
            self.mesh.groups[key] = group
        return group

    def all_to_all(self, x: torch.Tensor, axes) -> torch.Tensor:
        axes = tuple(axes)
        self._check_split(x, axes)
        return _AllToAll.apply(x, self, axes)

    def _all_to_all(self, x: torch.Tensor, axes: tuple) -> torch.Tensor:
        import torch.distributed as dist

        key = self._in_mesh_order(axes)
        send = self._reorder(x[0], axes, key).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self._group(axes))
        return self._reorder(recv, key, axes)[None]

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        axes = tuple(axes)
        if not axes:
            return x
        return _Psum.apply(x, self, axes)

    def _psum(self, x: torch.Tensor, axes: tuple) -> torch.Tensor:
        import torch.distributed as dist

        out = x.clone()
        dist.all_reduce(out, group=self._group(axes))
        return out

    def _block(self, axes) -> int:
        b = 0
        for a in axes:
            b = b * self.mesh.shape[a] + self.coords[a]
        return b

    def shard(self, x: torch.Tensor, axes, manual=None) -> torch.Tensor:
        """``manual`` (default every axis): the axes a ``shard_map`` would
        be manual over; the adjoint sums over those not in ``axes`` only."""
        axes = tuple(axes)
        manual = self.mesh.axis_names if manual is None else tuple(manual)
        self.axis_size(manual)
        if not set(axes) <= set(manual):
            raise ValueError(f"the sharded axes {axes} are not all in the "
                             f"manual axes {manual}")
        n = self.axis_size(axes)
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not split over {axes} "
                             f"({n} blocks)")
        return _Shard.apply(x, self, axes, manual)

    def unshard(self, x: torch.Tensor, axes) -> torch.Tensor:
        return _Unshard.apply(x, self, tuple(axes))

    def all_gather(self, x: torch.Tensor, axes) -> torch.Tensor:
        return _AllGather.apply(x, self, tuple(axes))

    def _all_gather(self, x: torch.Tensor, axes: tuple) -> torch.Tensor:
        import torch.distributed as dist

        key = self._in_mesh_order(axes)
        parts = [torch.empty_like(x[0]) for _ in range(self.axis_size(axes))]
        dist.all_gather(parts, x[0].contiguous(), group=self._group(axes))
        return self._reorder(torch.stack(parts), key, axes)[None]

    def ppermute(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        n = self.axis_size((axis,))
        return x if n == 1 else _PPermute.apply(x, self, axis)

    def _ppermute(self, x: torch.Tensor, axis: str, step: int) -> torch.Tensor:
        """Sends to the rank ``step`` further along ``axis`` and receives
        from the one ``step`` before, posted as one batch before either is
        waited on (a blocking send around the ring would deadlock, and NCCL
        needs the pair in one group); peers are the global ranks of this
        process's coordinates with ``axis`` moved ``step``."""
        import torch.distributed as dist

        n = self.axis_size((axis,))
        at = [self.coords[a] for a in self.mesh.axis_names]
        i = self.mesh.axis_names.index(axis)

        def peer(k: int) -> int:
            return int(np.ravel_multi_index(at[:i] + [(at[i] + k) % n] + at[i + 1:],
                                            self.mesh.sizes))

        send = x[0].contiguous()
        recv = torch.empty_like(send)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, peer(step)),
                                           dist.P2POp(dist.irecv, recv, peer(-step))]):
            req.wait()
        return recv[None]

    def record_together(self, axes, *tensors: torch.Tensor) -> list:
        """The tensors, each made to require grad (a detached copy that
        does) where it requires grad in any process of the group of
        ``axes``: one flag a tensor, max-reduced over the group, so that
        the collectives it enters record in every process of the group
        alike. One that recorded in some processes only would leave their
        backward pass waiting on the others."""
        import torch.distributed as dist

        grad = torch.is_grad_enabled()
        flags = torch.tensor([int(grad and t.requires_grad) for t in tensors],
                             device=tensors[0].device)
        dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=self._group(axes))
        return [t.detach().requires_grad_() if f and not t.requires_grad else t
                for t, f in zip(tensors, flags.tolist())]

    def reach(self, out: torch.Tensor, *tensors: torch.Tensor) -> torch.Tensor:
        """out, joined to ``tensors`` so that a backward pass from it runs
        theirs too (on zeros where nothing else reads them): each
        collective recorded in every process of a group then runs in every
        one, also where this process's result does not read its output."""
        return _Reach.apply(out, *tensors)
