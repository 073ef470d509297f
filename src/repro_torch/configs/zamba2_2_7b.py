"""zamba2-2.7b [hybrid]: 54L d=2560 32H (kv=32) d_ff=10240 vocab=32000.

Mamba2 backbone (ssm_state=64) + shared attention block invoked every 6
layers, fed concat(hidden, initial-embedding) [arXiv:2411.15242]."""

from repro_torch.models.common import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    kind="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, headdim=64, ngroups=1,
                  chunk=256),
    hybrid=HybridConfig(shared_block_every=6, concat_embed=True),
    source="arXiv:2411.15242",
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    kind="hybrid",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=128,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, headdim=32, ngroups=1,
                  chunk=32),
    hybrid=HybridConfig(shared_block_every=2, concat_embed=True),
)
