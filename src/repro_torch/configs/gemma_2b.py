"""gemma-2b [dense]: 18L d=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.

GeGLU, head_dim=256, tied + sqrt(d)-scaled embeddings [arXiv:2403.08295]."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    kind="decoder",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp="geglu",
    tie_embeddings=True,
    embed_scale=True,
    source="arXiv:2403.08295",
)

SMOKE = ModelConfig(
    name="gemma-2b-smoke",
    kind="decoder",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=32,
    d_ff=128,
    vocab_size=256,
    mlp="geglu",
    tie_embeddings=True,
    embed_scale=True,
)
