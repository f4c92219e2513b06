"""RecurrentGemma-9B [hybrid] — RG-LRU + local attention, 1:2 pattern.

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000  [arXiv:2402.19427]
Griffin block pattern: two recurrent (RG-LRU) blocks followed by one local
(sliding-window 2048) attention block.
"""

from repro_torch.configs.base import (
    AttentionConfig,
    ModalityConfig,
    ModelConfig,
    RGLRUConfig,
)


CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    source="arXiv:2402.19427",
    num_layers=38,
    d_model=4096,
    d_ff=12288,
    vocab_size=256_000,
    attention=AttentionConfig(
        kind="gqa", num_heads=16, num_kv_heads=1, head_dim=256,
        rope_theta=10_000.0, sliding_window=2048,
    ),
    rglru=RGLRUConfig(lru_width=4096, conv_width=4),
    block_pattern=("rglru", "rglru", "local_attn"),
    activation="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
    embedding_scale=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke",
        family="hybrid",
        source=CONFIG.source,
        num_layers=3,
        d_model=128,
        d_ff=256,
        vocab_size=512,
        attention=AttentionConfig(
            kind="gqa", num_heads=4, num_kv_heads=1, head_dim=32,
            sliding_window=16,
        ),
        rglru=RGLRUConfig(lru_width=128, conv_width=4),
        block_pattern=("rglru", "rglru", "local_attn"),
        activation="geglu",
        norm="rmsnorm",
        tie_embeddings=True,
        embedding_scale=True,
        remat=False,
    )
