"""qwen2-moe-a2.7b [moe]: 24L d=2048 16H (kv=16) d_ff=1408 vocab=151936.

4 shared + 60 routed experts, top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B]. Second
primary arch for the BlobShuffle EP dispatch."""

from repro_torch.models.common import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    kind="decoder",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    qkv_bias=True,
    moe=MoEConfig(num_experts=60, top_k=4, d_expert=1408, num_shared=4),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)

SMOKE = ModelConfig(
    name="qwen2-moe-smoke",
    kind="decoder",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=96,
    vocab_size=128,
    qkv_bias=True,
    moe=MoEConfig(num_experts=6, top_k=2, d_expert=96, num_shared=2),
)
