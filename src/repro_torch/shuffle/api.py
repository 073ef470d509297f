"""Public entry points of the shuffle, the port of ``repro.shuffle.api``:
the device blob data plane and the MoE FFN.

Data plane:

  blob_pack_fused          Batcher: (rows, keys) -> blob layout
  unpack_from_keys         Debatcher: blob layout + keys -> rows
  compress_pack_fused      Batcher with the int8 codec
  unpack_decompress_fused  Debatcher with the int8 codec

Each runs where its tensors lie: on CUDA through the Hopper kernels, on
the CPU through their plain versions.

MoE FFN: ``dense_moe_ffn`` is the single-device capacity-based dispatch
(the oracle of the dispatch modes). Its units are the records and its
experts the destinations, so its scatter and gather are the Batcher's
pack and the Debatcher's unpack (``blob_pack``, ``blob_unpack``): the
kernels on CUDA tensors, the plain versions on CPU tensors, bit for bit
the index-based ``binning.scatter_to_bins``/``gather_from_bins`` of the
JAX package. ``ep_moe_ffn`` without a mesh takes it whatever the mode,
as the JAX package does when it finds no mesh axes; the flat and blob
dispatch over ``torch.distributed`` come with the dispatch slice.
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

__all__ = ["ShuffleConfig", "blob_pack_fused", "unpack_from_keys",
           "compress_pack_fused", "unpack_decompress_fused",
           "dense_moe_ffn", "ep_moe_ffn"]


@dataclasses.dataclass(frozen=True)
class ShuffleConfig:
    """Fields and defaults of ``repro.shuffle.api.ShuffleConfig``. As in
    the JAX package, ``moe_apply`` reads ``mode`` and ``norm_topk`` and
    takes the capacity factor from the model's ``MoEConfig``;
    ``ep_moe_ffn`` reads ``capacity_factor`` and ``norm_topk``. On one
    device every mode takes the dense dispatch; the axes and
    ``compress_dcn`` wait for the dispatch slice."""
    mode: str = "dense"                  # dense | direct | blob
    token_axes: tuple = ("pod", "data", "model")
    expert_axes: tuple = ("pod", "model")  # EP domain, major -> minor
    pod_axis: str = "pod"
    capacity_factor: float = 1.25
    compress_dcn: bool = False
    norm_topk: bool = True
    use_context_mesh: bool = False

    def pod_local(self) -> "ShuffleConfig":
        """EP restricted to intra-pod axes (for pod-manual DP regions)."""
        return dataclasses.replace(
            self,
            token_axes=tuple(a for a in self.token_axes if a != self.pod_axis),
            expert_axes=tuple(a for a in self.expert_axes
                              if a != self.pod_axis),
            use_context_mesh=True)


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
    """Expert-parallel MoE FFN. x: (T, d); expert weights (E, d, d_e) /
    (E, d_e, d). Returns (y (T, d), aux_loss, DispatchDiagnostics).

    Without a mesh there are no expert axes, so every mode takes
    ``dense_moe_ffn``, and ``token_mask`` is not read (as in the JAX
    package). A mesh or process group raises ``NotImplementedError``: the
    flat and blob dispatch over ``torch.distributed`` are the dispatch
    slice's."""
    if mesh is not None:
        raise NotImplementedError(
            f"ep_moe_ffn over a mesh or process group ({type(mesh).__name__}) "
            f"is the dispatch slice's (flat_dispatch_combine, "
            f"blob_dispatch_combine over torch.distributed); the port runs "
            f"mesh=None, the single-device dense dispatch")
    y, aux, load = dense_moe_ffn(
        x, w_router, we_gate, we_up, we_down, top_k=top_k,
        capacity_factor=cfg.capacity_factor, norm_topk=cfg.norm_topk,
        compute_dtype=compute_dtype)
    return y, aux, D.DispatchDiagnostics(
        torch.zeros((), dtype=torch.int32, device=x.device), load,
        torch.zeros((), dtype=torch.float32, device=x.device))
