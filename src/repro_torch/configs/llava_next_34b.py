"""llava-next-34b [vlm]: 60L d=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

Anyres tiling [hf:llava-hf/llava-v1.6-*]. The transformer backbone only;
the vision frontend is a stub: the batch brings precomputed patch
embeddings (``patches``; anyres: 2880 patches an example), already
projected to d_model, which are prepended to the token embeddings.
Decode takes tokens only.
"""

from repro_torch.models.common import ModelConfig, MultimodalConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    kind="decoder",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5000000.0,
    multimodal=MultimodalConfig(kind="vision", num_patches=2880),
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (34b variant)",
)

SMOKE = ModelConfig(
    name="llava-next-smoke",
    kind="decoder",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=128,
    multimodal=MultimodalConfig(kind="vision", num_patches=16),
)
