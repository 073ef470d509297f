"""Model assembly for the ``decoder``, ``encoder``, ``ssm`` (Mamba2) and
``hybrid`` (Zamba2) kinds, the port of ``repro.models.lm``.

Where the JAX package stacks every layer's parameters on a leading
``layers`` axis and scans over it, the port holds one module per layer in
an ``nn.ModuleList`` and loops. A decoder block's attention is MLA
(``models.mla``) when ``cfg.mla`` is set, else GQA/MQA/MHA; its FFN is
the MoE layer when the config has one, else the MLP of ``cfg.mlp``
(SwiGLU, GeGLU or GELU). A MoE model's ``moe.first_dense_layers``
leading layers are ``dense_blocks``, whose MLP has width
``moe.dense_d_ff``; they run before ``blocks``, the MoE layers, and have
a decode cache of their own. The hybrid model runs
groups of ``shared_block_every`` Mamba2 layers, each followed by the
shared attention block on ``concat(x, x0) @ shared_in[g]``, with the
residual ``x + y - z``. The encoder kind runs the decoder's blocks, MLA,
MoE and leading dense layers included, with attention causal as
``cfg.causal`` (False for hubert), and has no decode step:
``cache_defs``, ``init_cache`` and ``decode_step`` raise for it.

The stub frontends (``cfg.multimodal``) take precomputed embeddings, as
in the JAX package (``_embed_inputs``): ``audio`` reads ``batch["frames"]``
(B, S, d), cast to the compute dtype, plus sinusoidal positions;
``vision`` puts ``batch["patches"]`` (B, P, d) before the embeddings of
``batch["tokens"]``. As in the JAX package, RoPE still runs inside the
encoder's attention on top of the sinusoidal positions, over the patch
positions too, and the causal mask covers the patches; an audio model
still holds an embedding table of ``vocab_size`` rows that it never reads
for input. A vision model's decode step takes tokens only.

Public surface:
  * ``LM(cfg, device="cuda")``                 - the parameters
  * ``param_defs(cfg)``                        - the JAX package's spec tree
  * ``forward(cfg, params, batch, mesh=None, shuffle=DENSE, remat="none")``
                                               - (logits, aux) for training and prefill
  * ``cache_defs(cfg, batch, max_seq)``        - decode cache specs
  * ``init_cache(cfg, batch, max_seq, device="cuda")`` - a zero cache
  * ``decode_step(cfg, params, cache, batch, mesh=None, shuffle=DENSE)``
                                               - one-token serve step

``shuffle`` selects the MoE dispatch and ``mesh``
(``repro_torch.launch.mesh``) the ranks it runs over; without a mesh
every mode takes the dense dispatch. Only the MoE layer reads the mesh:
everything else runs whole on the device. ``remat`` recomputes each
remat unit of the JAX package in the backward pass instead of keeping its
activations: each decoder block (the leading dense ones too), each Mamba2
block, and each hybrid group of ``shared_block_every`` Mamba2 layers with
its shared block. ``full`` keeps only the units' inputs
(``torch.utils.checkpoint``, the twin of ``jax.checkpoint``); ``dots``
keeps the outputs of the matrix products as well (a selective checkpoint
of ``aten.mm`` and ``aten.bmm``, the twin of ``checkpoint_dots``).
What the port does not run
raises ``ValueError`` naming it: a MoE layer or MLA outside the
``decoder`` and ``encoder`` kinds, which the JAX package's ``ssm`` and
``hybrid`` kinds have no cache or layer for; and a multimodal kind other
than ``audio`` and ``vision``, which have no frontend. ``ssm.intra_bf16``
runs: the SSD chunk then holds its intra-chunk tensors in bf16, as the
JAX package's ``ssd_chunked`` does.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.common import (ArraySpec, ModelConfig, ParamModule,
                                       zeros_tree)
from repro_torch.shuffle.api import ShuffleConfig

KINDS = ("decoder", "encoder", "ssm", "hybrid")
#: the kinds whose layers are transformer blocks
BLOCK_KINDS = ("decoder", "encoder")
#: the stub frontends' modality kinds
FRONTENDS = ("audio", "vision")
DENSE = ShuffleConfig(mode="dense")
REMAT = ("none", "dots", "full")
#: the matrix products that remat "dots" keeps
_save_dots = functools.partial(create_selective_checkpoint_contexts,
                               [torch.ops.aten.mm.default, torch.ops.aten.bmm.default])


def _check_kind(cfg: ModelConfig) -> None:
    if cfg.kind not in KINDS:
        raise ValueError(f"the port has no {cfg.kind!r} kind "
                         f"({cfg.name}); it runs {KINDS}")
    mm = cfg.multimodal
    unsupported = [name for name, on in (
        ("moe outside the decoder and encoder kinds",
         cfg.moe is not None and cfg.kind not in BLOCK_KINDS),
        ("mla outside the decoder and encoder kinds",
         cfg.mla is not None and cfg.kind not in BLOCK_KINDS),
        (f"multimodal kind {getattr(mm, 'kind', None)!r}",
         mm is not None and mm.kind not in FRONTENDS)) if on]
    if unsupported:
        raise ValueError(f"{cfg.name}: the port does not run {unsupported}")


def _check_decode(cfg: ModelConfig) -> None:
    _check_kind(cfg)
    if not cfg.has_decode:
        raise ValueError(f"{cfg.name}: the {cfg.kind} kind has no decode step")


def _dense_layers(cfg: ModelConfig) -> int:
    """The leading dense layers of a MoE decoder (``dense_blocks``)."""
    return cfg.moe.first_dense_layers if cfg.moe is not None else 0


class SSMBlock(ParamModule):
    """Pre-norm Mamba2 layer: ``x + mamba2(rms_norm(x, ln))``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.declare("ln", L.norm_spec(cfg.d_model), device)
        self.mamba = SSM.Mamba2(cfg, device)


class Block(ParamModule):
    """Pre-norm transformer block: attention (MLA when ``cfg.mla`` is
    set), then the FFN, the MoE layer (``moe=True``) or the MLP of width
    ``d_ff`` (``cfg.d_ff`` unless given)."""

    def __init__(self, cfg: ModelConfig, device, *, moe: bool = False,
                 d_ff: int | None = None):
        super().__init__()
        self.declare("ln1", L.norm_spec(cfg.d_model), device)
        self.attn = (MLA.MLA(cfg, device) if cfg.mla is not None
                     else A.Attention(cfg, device))
        self.declare("ln2", L.norm_spec(cfg.d_model), device)
        self.ffn = (MOE.MoE(cfg, device) if moe
                    else L.MLP(cfg, d_ff or cfg.d_ff, device))


class LM(ParamModule):
    """The parameters of a ``decoder``, ``encoder``, ``ssm`` or ``hybrid``
    model, on ``device`` (uninitialised: draw them with
    ``common.init_params``). A decoder or encoder holds ``dense_blocks``
    (empty unless the MoE config has leading dense layers) and
    ``blocks``."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        _check_kind(cfg)
        self.embed = L.Embedding(cfg, device)
        if cfg.kind in BLOCK_KINDS:
            n_dense = _dense_layers(cfg)
            self.dense_blocks = nn.ModuleList(
                Block(cfg, device, d_ff=cfg.moe.dense_d_ff) for _ in range(n_dense))
            self.blocks = nn.ModuleList(Block(cfg, device, moe=cfg.moe is not None)
                                        for _ in range(cfg.num_layers - n_dense))
        else:
            self.blocks = nn.ModuleList(SSMBlock(cfg, device)
                                        for _ in range(cfg.num_layers))
        if cfg.kind == "hybrid":
            h = cfg.hybrid
            if cfg.num_layers % h.shared_block_every:
                raise ValueError(f"{cfg.num_layers} layers are not a multiple "
                                 f"of shared_block_every {h.shared_block_every}")
            n_inv = cfg.num_layers // h.shared_block_every
            self.shared_block = Block(cfg, device)
            concat_dim = 2 * cfg.d_model if h.concat_embed else cfg.d_model
            self.declare("shared_in", ArraySpec(
                (n_inv, concat_dim, cfg.d_model), cfg.param_dtype,
                ("stack", "embed", None)), device)
        self.declare("final_norm", L.norm_spec(cfg.d_model), device)


def _insert(tree: dict, path, leaf) -> None:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = leaf


def jax_layout(leaves: dict, stack) -> dict:
    """Leaves keyed by ``LM``'s parameter names -> the JAX package's
    nested tree of them, the leaves of each ``blocks.<i>.<path>``
    (``dense_blocks``) stacked by ``stack`` (called on the layers' leaves
    in order) into the leaf at ``blocks/<path>``. Specs stack into one
    spec (``param_defs``), tensors into ``interop.StackedRows`` (the train
    state's tree)."""
    groups: dict = {}
    for name, t in leaves.items():
        parts = name.split(".")
        layer = None
        if parts[0] in ("blocks", "dense_blocks"):
            layer = int(parts.pop(1))
        groups.setdefault(tuple(parts), []).append((layer, t))
    tree: dict = {}
    for path, rows in groups.items():
        if rows[0][0] is None:
            (_, leaf), = rows
        else:
            layers = [layer for layer, _ in rows]
            if layers != list(range(len(rows))):
                raise ValueError(f"{'.'.join(path)}: layers {layers} are not 0..{len(rows) - 1}")
            leaf = stack([t for _, t in rows])
        _insert(tree, path, leaf)
    return tree


def _stack_specs(rows: list) -> ArraySpec:
    """The layers' equal specs -> one spec on a leading ``layers`` axis."""
    first = rows[0]
    if any(r != first for r in rows):
        raise ValueError(f"the layers' specs differ: {sorted(set(rows), key=repr)}")
    axes = first.axes or (None,) * len(first.shape)
    return dataclasses.replace(first, shape=(len(rows), *first.shape),
                               axes=("layers", *axes))


def param_defs(cfg: ModelConfig) -> dict:
    """The JAX package's ``ArraySpec`` tree (``repro.models.lm.param_defs``),
    read off the specs of ``LM(cfg)`` built on the meta device (no memory):
    each spec keyed by its parameter's path, the ``blocks.<i>`` and
    ``dense_blocks.<i>`` rows stacked on a leading ``layers`` axis by
    ``jax_layout``, the grouping of the train state's tree; the
    hybrid ``shared_block`` and ``shared_in`` stay unstacked."""
    model = LM(cfg, device="meta")
    specs = {f"{path}.{name}" if path else name: spec
             for path, m in model.named_modules() if isinstance(m, ParamModule)
             for name, spec in m.specs.items()}
    return jax_layout(specs, _stack_specs)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _angles(S: int, d: int, device) -> torch.Tensor:
    """(S, ceil(d / 2)) f32 angles ``pos / 10000 ** (2i / d)``. The power
    is taken in f64 and rounded once to f32, so the angles have the JAX
    package's bits (its f32 ``power`` is correctly rounded; torch's f32
    ``pow`` is not)."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    return pos / torch.pow(10000.0, (dim / d).double()).float()


def _sinusoidal(S: int, d: int, dtype, device) -> torch.Tensor:
    """(S, d) sinusoidal positions: sin of the angles in the even
    columns, cos of the first ``d // 2`` in the odd ones, in f32, cast to
    ``dtype``. sin and cos are taken in f64 and rounded once to f32; the
    JAX package's f32 sin and cos (the C library's) agree with that to
    one f32 ulp."""
    ang = _angles(S, d, device).double()
    out = torch.zeros((S, d), dtype=torch.float32, device=device)
    out[:, 0::2] = torch.sin(ang).float()
    out[:, 1::2] = torch.cos(ang[:, :d // 2]).float()
    return out.to(dtype)


def _embed_inputs(cfg: ModelConfig, params: LM, batch: dict) -> torch.Tensor:
    """The input embeddings (B, S, d): the audio frontend's frames plus
    sinusoidal positions, the vision frontend's patches before the
    tokens' embeddings, or the tokens' embeddings."""
    mm = cfg.multimodal
    if mm is not None and mm.kind == "audio":
        x = batch["frames"].to(cfg.compute_dtype)
        return x + _sinusoidal(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
    tok = L.embed_apply(cfg, params.embed, batch["tokens"])
    if mm is not None and mm.kind == "vision":
        return torch.cat([batch["patches"].to(cfg.compute_dtype), tok], dim=1)
    return tok


def _ffn_apply(cfg: ModelConfig, p: Block, z: torch.Tensor, shuffle: ShuffleConfig,
               mesh=None):
    """The block's FFN on the normed residual z: (y, aux), the aux loss
    being the MoE layer's, or 0 for the MLP."""
    if isinstance(p.ffn, MOE.MoE):
        y, aux, _ = MOE.moe_apply(cfg, p.ffn, z, shuffle=shuffle, mesh=mesh)
        return y, aux
    return L.mlp_apply(cfg, p.ffn, z), torch.zeros((), dtype=torch.float32,
                                                   device=z.device)


def _block_apply(cfg: ModelConfig, p: Block, x: torch.Tensor,
                 positions: torch.Tensor, *, mesh=None, shuffle: ShuffleConfig = DENSE):
    """Pre-norm transformer block. Returns (x, aux)."""
    attn = MLA.mla_apply if cfg.mla is not None else A.attention_apply
    h = attn(cfg, p.attn, L.rms_norm(x, p.ln1, cfg.norm_eps), positions=positions)
    x = x + h
    y, aux = _ffn_apply(cfg, p, L.rms_norm(x, p.ln2, cfg.norm_eps), shuffle, mesh)
    return x + y, aux


def _ssm_block_apply(cfg: ModelConfig, p: SSMBlock,
                     x: torch.Tensor) -> torch.Tensor:
    return x + SSM.mamba2_apply(cfg, p.mamba, L.rms_norm(x, p.ln, cfg.norm_eps))


def _shared_input(cfg: ModelConfig, params: LM, g: int, x, x0):
    inp = torch.cat([x, x0], dim=-1) if cfg.hybrid.concat_embed else x
    cd = cfg.compute_dtype
    return inp.to(cd) @ params.shared_in[g].to(cd)


def _remat(fn, policy: str):
    """``fn`` run as one remat unit under ``policy`` (module docstring)."""
    if policy == "none":
        return fn
    kwargs = {"use_reentrant": False}
    if policy == "dots":
        kwargs["context_fn"] = _save_dots
    return functools.partial(checkpoint, fn, **kwargs)


def forward(cfg: ModelConfig, params: LM, batch: dict, *, mesh=None,
            shuffle: ShuffleConfig = DENSE, remat: str = "none"):
    """Full-sequence forward. batch {"tokens": (B, S)}; with the audio
    frontend {"frames": (B, S, d)}, with the vision frontend {"patches":
    (B, P, d), "tokens": (B, S - P)}. Returns (logits (B, S, V),
    aux_loss): the sum of the MoE layers' aux losses, 0 for the other
    kinds. ``remat``: none | dots | full."""
    _check_kind(cfg)
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    x = _embed_inputs(cfg, params, batch)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.kind in BLOCK_KINDS:
        auxes = []
        for blk in (*params.dense_blocks, *params.blocks):
            x, a = _remat(functools.partial(_block_apply, cfg, blk, positions=positions,
                                            mesh=mesh, shuffle=shuffle), remat)(x)
            auxes.append(a)
        aux = torch.stack(auxes).sum()
    elif cfg.kind == "ssm":
        for blk in params.blocks:
            x = _remat(functools.partial(_ssm_block_apply, cfg, blk), remat)(x)
    else:
        k = cfg.hybrid.shared_block_every
        x0 = x  # the initial embedding, fed to every shared-block call

        def group(x, g):
            for blk in params.blocks[g * k:(g + 1) * k]:
                x = _ssm_block_apply(cfg, blk, x)
            z = _shared_input(cfg, params, g, x, x0)
            y, _ = _block_apply(cfg, params.shared_block, z, positions,
                                mesh=mesh, shuffle=shuffle)
            return x + y - z

        for g in range(cfg.num_layers // k):
            x = _remat(functools.partial(group, g=g), remat)(x)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = L.unembed_apply(cfg, params.embed, x)
    return logits, aux


# ---------------------------------------------------------------------------
# Decode (one token with a cache)
# ---------------------------------------------------------------------------

def cache_defs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """Decode-cache specs, stacked per layer as in the JAX package."""
    _check_decode(cfg)
    if cfg.kind == "decoder":
        n_dense = _dense_layers(cfg)
        mk = MLA.mla_cache_defs if cfg.mla is not None else A.attention_cache_defs
        out = {"blocks": mk(cfg, batch, max_seq, stacked=cfg.num_layers - n_dense)}
        if n_dense:
            out["dense_blocks"] = mk(cfg, batch, max_seq, stacked=n_dense)
        return out
    out = {"blocks": SSM.mamba2_cache_defs(cfg, batch, stacked=cfg.num_layers)}
    if cfg.kind == "hybrid":
        n_inv = cfg.num_layers // cfg.hybrid.shared_block_every
        out["shared"] = A.attention_cache_defs(cfg, batch, max_seq, stacked=n_inv)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda") -> dict:
    return zeros_tree(cache_defs(cfg, batch, max_seq), device)


def _block_decode(cfg: ModelConfig, p: Block, x, cache: dict, pos: int, *,
                  mesh=None, shuffle: ShuffleConfig = DENSE):
    attn = MLA.mla_decode if cfg.mla is not None else A.attention_decode
    h, cache = attn(cfg, p.attn, L.rms_norm(x, p.ln1, cfg.norm_eps), cache, pos)
    x = x + h
    y, _ = _ffn_apply(cfg, p, L.rms_norm(x, p.ln2, cfg.norm_eps), shuffle, mesh)
    return x + y, cache


def _ssm_block_decode(cfg: ModelConfig, p: SSMBlock, x, cache: dict, layer: int,
                      pos: int):
    c = {name: t[layer] for name, t in cache["blocks"].items()}
    h, new = SSM.mamba2_decode(cfg, p.mamba, L.rms_norm(x, p.ln, cfg.norm_eps),
                               c, pos)
    for name, t in new.items():
        c[name].copy_(t)
    return x + h


def decode_step(cfg: ModelConfig, params: LM, cache: dict, batch: dict, *,
                mesh=None, shuffle: ShuffleConfig = DENSE):
    """One-token decode. batch {"tokens": (B, 1), "pos": int}: tokens
    only, with the vision frontend too.

    Writes the new state of every layer into ``cache`` in place and
    returns (logits (B, 1, V), cache).
    """
    _check_decode(cfg)
    pos = int(batch["pos"])
    x = L.embed_apply(cfg, params.embed, batch["tokens"])
    if cfg.kind == "decoder":
        for stack in ("dense_blocks", "blocks"):
            for layer, blk in enumerate(getattr(params, stack)):
                c = {name: t[layer] for name, t in cache[stack].items()}
                x, _ = _block_decode(cfg, blk, x, c, pos, mesh=mesh, shuffle=shuffle)
    elif cfg.kind == "ssm":
        for layer, blk in enumerate(params.blocks):
            x = _ssm_block_decode(cfg, blk, x, cache, layer, pos)
    else:
        k = cfg.hybrid.shared_block_every
        x0 = x
        for g in range(cfg.num_layers // k):
            for layer in range(g * k, (g + 1) * k):
                x = _ssm_block_decode(cfg, params.blocks[layer], x, cache, layer, pos)
            z = _shared_input(cfg, params, g, x, x0)
            attn_cache = {name: t[g] for name, t in cache["shared"].items()}
            y, _ = _block_decode(cfg, params.shared_block, z, attn_cache, pos,
                                 mesh=mesh, shuffle=shuffle)
            x = x + y - z
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return L.unembed_apply(cfg, params.embed, x), cache
