"""granite-3-2b [dense]: 40L d=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.

GQA [hf:ibm-granite/granite-3.0-2b-base]."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    kind="decoder",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base",
)

SMOKE = ModelConfig(
    name="granite-3-2b-smoke",
    kind="decoder",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=128,
    tie_embeddings=True,
)
