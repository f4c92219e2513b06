"""DeepSeek-67B [dense] — llama-architecture.

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400  [arXiv:2401.02954]
"""

from repro_torch.configs.base import AttentionConfig, ModelConfig


CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    source="arXiv:2401.02954",
    num_layers=95,
    d_model=8192,
    d_ff=22016,
    vocab_size=102_400,
    attention=AttentionConfig(
        kind="gqa", num_heads=64, num_kv_heads=8, head_dim=128,
        rope_theta=10_000.0,
    ),
    block_pattern=("attn",),
    activation="swiglu",
    norm="rmsnorm",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b-smoke",
        family="dense",
        source=CONFIG.source,
        num_layers=2,
        d_model=128,
        d_ff=352,
        vocab_size=512,
        attention=AttentionConfig(kind="gqa", num_heads=8, num_kv_heads=2,
                                  head_dim=16),
        block_pattern=("attn",),
        activation="swiglu",
        norm="rmsnorm",
        remat=False,
    )
