"""deepseek-v2-lite-16b [moe]: 27L d=2048 16H d_ff(expert)=1408 vocab=102400.

MLA (kv_lora=512, qk_nope=128, qk_rope=64, v=128); MoE with 2 shared +
64 routed experts, top-6, first layer dense (d_ff 10944) [arXiv:2405.04434].

64 routed experts, as in the published v2-lite (DeepSeek-V2-236B has
160). This is the BlobShuffle technique's primary arch: the EP token
dispatch is the repartitioning that BlobShuffle optimizes.
"""

from repro_torch.models.common import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    kind="decoder",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=2,
                  first_dense_layers=1, dense_d_ff=10944),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    source="arXiv:2405.04434",
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-smoke",
    kind="decoder",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=96,
    vocab_size=128,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=96, num_shared=2,
                  first_dense_layers=1, dense_d_ff=128),
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
)
