"""starcoder2-3b [dense]: 30L d=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.

GQA + RoPE [arXiv:2402.19173; hf]. GELU MLP with bias; full attention here
(the real model's sliding window is orthogonal to the shuffle technique),
as in the JAX package's config."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    kind="decoder",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    mlp="gelu",
    qkv_bias=True,
    rope_theta=100000.0,
    source="arXiv:2402.19173",
)

SMOKE = ModelConfig(
    name="starcoder2-3b-smoke",
    kind="decoder",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=128,
    mlp="gelu",
    qkv_bias=True,
)
