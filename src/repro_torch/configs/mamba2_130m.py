"""mamba2-130m [ssm]: 24L d=768, attention-free, vocab=50280, ssm_state=128.

SSD (state-space duality) [arXiv:2405.21060]. d_inner = 2*768 = 1536,
headdim 64 -> 24 SSD heads.
"""

from repro_torch.models.common import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    kind="ssm",
    num_layers=24,
    d_model=768,
    num_heads=24,
    num_kv_heads=24,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, headdim=64, ngroups=1,
                  chunk=256),
    source="arXiv:2405.21060",
)

SMOKE = ModelConfig(
    name="mamba2-130m-smoke",
    kind="ssm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=128,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, headdim=32, ngroups=1,
                  chunk=32),
)
