"""hubert-xlarge [audio]: 48L d=1280 16H (kv=16) d_ff=5120 vocab=504.

Encoder-only, same arch as wav2vec2 [arXiv:2106.07447]. The audio frontend
(conv feature extractor) is a stub: the batch brings precomputed frame
embeddings of size d_model (``frames``), to which the model adds
sinusoidal positions. No decode step.
"""

from repro_torch.models.common import ModelConfig, MultimodalConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    kind="encoder",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    mlp="gelu",
    qkv_bias=True,
    causal=False,
    multimodal=MultimodalConfig(kind="audio"),
    source="arXiv:2106.07447",
)

SMOKE = ModelConfig(
    name="hubert-xlarge-smoke",
    kind="encoder",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=64,
    mlp="gelu",
    qkv_bias=True,
    causal=False,
    multimodal=MultimodalConfig(kind="audio"),
)
