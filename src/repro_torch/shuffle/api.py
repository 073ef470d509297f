"""Public entry points of the shuffle, the port of ``repro.shuffle.api``:
the device blob data plane and the MoE FFN.

Data plane:

  blob_pack_fused          Batcher: (rows, keys) -> blob layout
  unpack_from_keys         Debatcher: blob layout + keys -> rows
  compress_pack_fused      Batcher with the int8 codec
  unpack_decompress_fused  Debatcher with the int8 codec

Each runs where its tensors lie: on CUDA through the Hopper kernels, on
the CPU through their plain versions.

MoE FFN (``ShuffleConfig.mode``):
  * ``dense``  the single-device capacity-based dispatch
               (``dense_moe_ffn``, the oracle of the other modes);
  * ``direct`` flat all-to-all over the whole EP domain (the "native
               Kafka shuffling" baseline analogue);
  * ``blob``   BlobShuffle: the hierarchical two-stage exchange with
               pooled per-pod blob capacity and optional int8 on the
               inter-pod leg.
Units are the records and experts the destinations, so every scatter
and gather is the Batcher's pack and the Debatcher's unpack
(``blob_pack``, ``blob_unpack``): the kernels on CUDA tensors, the plain
versions on CPU tensors, bit for bit the index-based
``binning.scatter_to_bins``/``gather_from_bins`` of the JAX package.
``ep_moe_ffn`` takes the dense dispatch without a mesh, whatever the
mode, as the JAX package does when it finds no mesh axes; with a mesh
(``repro_torch.launch.mesh``) it runs ``direct`` and ``blob`` over the
mesh's ranks (``shuffle.dispatch``, ``shuffle.exchange``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.blob_codec.ops import (compress_pack_fused,
                                                unpack_decompress_fused)
from repro_torch.kernels.blob_pack.ops import blob_pack, blob_pack_fused
from repro_torch.kernels.blob_unpack.ops import blob_unpack, unpack_from_keys
from repro_torch.shuffle import dispatch as D
from repro_torch.shuffle.binning import pack_sorted, sorted_order
from repro_torch.shuffle.exchange import for_mesh

__all__ = ["ShuffleConfig", "blob_pack_fused", "unpack_from_keys",
           "compress_pack_fused", "unpack_decompress_fused",
           "dense_moe_ffn", "ep_moe_ffn"]


@dataclasses.dataclass(frozen=True)
class ShuffleConfig:
    """Fields and defaults of ``repro.shuffle.api.ShuffleConfig``. As in
    the JAX package, ``moe_apply``'s dense path reads ``mode`` and
    ``norm_topk`` and takes the capacity factor from the model's
    ``MoEConfig``; with a mesh ``ep_moe_ffn`` reads every field,
    ``capacity_factor`` included. ``use_context_mesh`` (set by
    ``pod_local``) marks a pod-local region: in the JAX package the
    dispatch then runs inside a ``shard_map`` manual over the pod axis,
    over the ambient mesh's other axes. The port has no ambient mesh, so
    the caller passes the pod's own mesh (``launch.mesh.pod_submesh``)
    and ``ep_moe_ffn`` runs the expert-parallel dispatch over its ranks;
    a mesh that still has the pod axis is refused. On a pod's mesh the
    aux loss and the diagnostics are the pod's own, where JAX's nested
    ``shard_map`` sums them over the manual pod axis too. The train
    step's gradient-sync modes set the flag, but pass no mesh to the
    pod's loss (neither package does), so their MoE layers take the
    dense dispatch."""
    mode: str = "dense"                  # dense | direct | blob
    token_axes: tuple = ("pod", "data", "model")
    expert_axes: tuple = ("pod", "model")  # EP domain, major -> minor
    pod_axis: str = "pod"
    capacity_factor: float = 1.25
    compress_dcn: bool = False
    norm_topk: bool = True
    use_context_mesh: bool = False

    def resolve(self, mesh) -> "ShuffleConfig":
        """Drop axes that are absent from the mesh."""
        names = set(_mesh_axis_names(mesh))
        tok = tuple(a for a in self.token_axes if a in names)
        exp = tuple(a for a in self.expert_axes if a in names)
        return dataclasses.replace(self, token_axes=tok, expert_axes=exp)

    def pod_local(self) -> "ShuffleConfig":
        """EP restricted to intra-pod axes (for pod-manual DP regions)."""
        return dataclasses.replace(
            self,
            token_axes=tuple(a for a in self.token_axes if a != self.pod_axis),
            expert_axes=tuple(a for a in self.expert_axes
                              if a != self.pod_axis),
            use_context_mesh=True)


def _mesh_axis_names(mesh) -> tuple:
    """The mesh's axis names; none without a mesh (the port has no
    context mesh)."""
    return mesh.axis_names if mesh is not None else ()


def _expert_ffn(we_gate, we_up, we_down, compute_dtype):
    """Batched SwiGLU over (E, C, d) token buffers."""
    def fn(t):
        t = t.to(compute_dtype)
        g = F.silu(torch.bmm(t, we_gate.to(compute_dtype)))
        u = torch.bmm(t, we_up.to(compute_dtype))
        return torch.bmm(g * u, we_down.to(compute_dtype))
    return fn


def _route(x, w_router, top_k: int, norm_topk: bool,
           num_real: Optional[int] = None):
    """Router in f32. Returns (sel_w (T, k) f32, sel_idx (T, k) int32,
    probs (T, E) f32).

    ``num_real``: if the expert set was padded up to the EP-domain size,
    the pad columns are masked so they are never selected."""
    logits = x.float() @ w_router.float()
    if num_real is not None and num_real < logits.shape[-1]:
        mask = torch.arange(logits.shape[-1], device=x.device) < num_real
        logits = torch.where(mask, logits, logits.new_tensor(-1e30))
    probs = torch.softmax(logits, dim=-1)
    sel_w, sel_idx = torch.topk(probs, top_k, dim=-1)
    if norm_topk:
        sel_w = sel_w / torch.clamp(sel_w.sum(dim=-1, keepdim=True), min=1e-9)
    return sel_w, sel_idx.to(torch.int32), probs


def dense_moe_ffn(x, w_router, we_gate, we_up, we_down, *, top_k: int,
                  capacity_factor: float, norm_topk: bool = True,
                  compute_dtype=torch.bfloat16):
    """Single-device capacity-based dispatch (the correctness oracle).

    x: (T, d). Returns (y (T, d), aux_loss scalar, expert_load (E,) int32).
    Units past an expert's capacity are dropped: they read 0.
    """
    T, d = x.shape
    E = w_router.shape[1]
    sel_w, sel_idx, probs = _route(x, w_router, top_k, norm_topk)
    U = T * top_k
    cap = D._cap(U / E, capacity_factor)
    unit_expert = sel_idx.reshape(-1)
    unit_tok = torch.arange(T, dtype=torch.int32,
                            device=x.device).repeat_interleave(top_k)
    order, starts, counts = sorted_order(unit_expert, E)
    pack = pack_sorted(unit_expert, order, starts, counts, cap)
    # the pack gathers each bin's rows straight from the (T, d) tokens
    ebuf = blob_pack(x, unit_tok[order], starts, counts, capacity=cap)
    eout = _expert_ffn(we_gate, we_up, we_down, compute_dtype)(ebuf)
    y_units = blob_unpack(eout, pack.slot, pack.valid)         # (U, d)
    y = torch.einsum("tk,tkd->td", sel_w,
                     y_units.reshape(T, top_k, d).float())
    aux = _aux_loss(probs, counts, U, E)
    return y.to(x.dtype), aux, counts


def _aux_loss(probs, load, total_units: int, E: int):
    """Switch-style load-balance loss: E * sum_e f_e * pbar_e."""
    f = load.float() / max(total_units, 1)
    pbar = probs.mean(dim=0)
    return E * torch.sum(f * pbar)


def _pad_experts(w_router, we_gate, we_up, we_down, ep: int):
    """Pad the expert dimension up to a multiple of the EP-domain size.
    Returns the four padded weights and the real expert count."""
    E = we_gate.shape[0]
    pad = -(-E // ep) * ep - E
    if pad == 0:
        return w_router, we_gate, we_up, we_down, E
    return (F.pad(w_router, (0, pad)),
            F.pad(we_gate, (0, 0, 0, 0, 0, pad)),
            F.pad(we_up, (0, 0, 0, 0, 0, pad)),
            F.pad(we_down, (0, 0, 0, 0, 0, pad)),
            E)


def ep_moe_ffn(x, w_router, we_gate, we_up, we_down, *, top_k: int,
               cfg: ShuffleConfig, mesh=None, compute_dtype=torch.bfloat16,
               token_mask: Optional[torch.Tensor] = None):
    """Expert-parallel MoE FFN over the ranks of ``mesh``.

    x: (T, d) global flat token array; T must divide over the token axes
    (callers pad; ``token_mask`` zeroes the combine weights of pad
    tokens). Expert weights: (E, d, d_e) / (E, d_e, d), split over
    ``expert_axes``. Returns (y (T, d), aux_loss, DispatchDiagnostics),
    the diagnostics summed over the whole mesh. With
    ``cfg.use_context_mesh`` the mesh is one pod's (``ShuffleConfig``).

    Without a mesh, or with no expert axis in it, every mode takes
    ``dense_moe_ffn``, and ``token_mask`` is not read (as in the JAX
    package). ``blob`` runs ``direct`` unless the pod axis is in the EP
    domain with a size above 1. A mesh of a type that no exchange runs
    is refused by name."""
    ex = for_mesh(mesh) if mesh is not None else None
    if cfg.use_context_mesh and cfg.pod_axis in _mesh_axis_names(mesh):
        raise ValueError(
            f"a pod-local region runs on one pod's mesh "
            f"(launch.mesh.pod_submesh), not on {mesh.axis_names}")
    cfg = cfg.resolve(mesh)
    if cfg.mode == "dense" or not cfg.expert_axes:
        y, aux, load = dense_moe_ffn(
            x, w_router, we_gate, we_up, we_down, top_k=top_k,
            capacity_factor=cfg.capacity_factor, norm_topk=cfg.norm_topk,
            compute_dtype=compute_dtype)
        return y, aux, D.DispatchDiagnostics(
            torch.zeros((), dtype=torch.int32, device=x.device), load,
            torch.zeros((), dtype=torch.float32, device=x.device))

    w_router, we_gate, we_up, we_down, E_real = _pad_experts(
        w_router, we_gate, we_up, we_down, ex.axis_size(cfg.expert_axes))
    E = w_router.shape[1]
    all_axes = mesh.axis_names
    # the dispatch sums its diagnostics over the EP axes; the other axes
    # are folded in here, so that every rank holds the global values
    spectators = tuple(a for a in all_axes if a not in cfg.expert_axes)
    has_pod = cfg.pod_axis in cfg.expert_axes and mesh.shape[cfg.pod_axis] > 1
    mode = cfg.mode if (cfg.mode != "blob" or has_pod) else "direct"
    inner_axes = tuple(a for a in cfg.expert_axes if a != cfg.pod_axis)

    if token_mask is None:
        token_mask = torch.ones((x.shape[0],), dtype=torch.float32,
                                device=x.device)
    x_loc = ex.shard(x, cfg.token_axes)                  # (R, T_loc, d)
    mask_loc = ex.shard(token_mask, cfg.token_axes)      # (R, T_loc)
    R, T_loc, d = x_loc.shape
    # the router's weight is every rank's (``PartitionSpec()``), so that on
    # process groups its gradient is summed over the mesh's ranks
    w_router = ex.shard(w_router, ())[0]
    # every rank's tokens in one product, as the dense path routes them
    sel_w, sel_idx, probs = _route(x_loc.reshape(R * T_loc, d), w_router,
                                   top_k, cfg.norm_topk, num_real=E_real)
    sel_w = sel_w.view(R, T_loc, top_k) * mask_loc[..., None]
    sel_idx, probs = sel_idx.view(R, T_loc, top_k), probs.view(R, T_loc, E)
    weights = [ex.shard(w, cfg.expert_axes) for w in (we_gate, we_up, we_down)]
    ffn = _expert_ffn(*(w.reshape(-1, *w.shape[2:]) for w in weights),
                      compute_dtype)

    def expert_fn(t):                       # (R, E_loc, C, d) in one product
        return ffn(t.reshape(-1, *t.shape[2:])).view(*t.shape[:3], -1)

    common = dict(exchange=ex, num_experts=E, capacity_factor=cfg.capacity_factor,
                  d_out=d)
    if mode == "blob":
        y, diag = D.blob_dispatch_combine(
            x_loc, sel_idx, sel_w, expert_fn, pod_axis=cfg.pod_axis,
            inner_axes=inner_axes, compress_dcn=cfg.compress_dcn, **common)
    else:
        y, diag = D.flat_dispatch_combine(
            x_loc, sel_idx, sel_w, expert_fn, ep_axes=cfg.expert_axes,
            **common)
    # fold the spectator axes into the global diagnostics and aux loss
    n_tok = ex.psum(mask_loc.sum(dim=1), all_axes)[:, None]
    psum_probs = ex.psum((probs * mask_loc[..., None]).sum(dim=1), all_axes)
    load = ex.psum(diag.expert_load, spectators)
    dropped = ex.psum(diag.dropped, spectators)
    dcn = ex.psum(diag.dcn_bytes, spectators)
    f = load.float() / torch.clamp(n_tok * top_k, min=1)
    pbar = psum_probs / torch.clamp(n_tok, min=1)
    aux = E_real * torch.sum(f[:, :E_real] * pbar[:, :E_real], dim=1)
    # every rank holds the same diagnostics: this process's first rank's
    return (ex.unshard(y, cfg.token_axes), aux[0],
            D.DispatchDiagnostics(dropped[0], load[0, :E_real], dcn[0]))
