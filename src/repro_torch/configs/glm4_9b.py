"""GLM4-9B [dense] — RoPE + GQA.

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552  [hf:THUDM/glm-4-9b]
"""

from repro_torch.configs.base import AttentionConfig, ModelConfig


CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    source="hf:THUDM/glm-4-9b",
    num_layers=40,
    d_model=4096,
    d_ff=13696,
    vocab_size=151_552,
    attention=AttentionConfig(
        kind="gqa", num_heads=32, num_kv_heads=2, head_dim=128,
        rope_theta=10_000.0,
    ),
    block_pattern=("attn",),
    activation="swiglu",
    norm="rmsnorm",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="glm4-smoke",
        family="dense",
        source=CONFIG.source,
        num_layers=2,
        d_model=128,
        d_ff=448,
        vocab_size=512,
        attention=AttentionConfig(kind="gqa", num_heads=8, num_kv_heads=2,
                                  head_dim=16),
        block_pattern=("attn",),
        activation="swiglu",
        norm="rmsnorm",
        remat=False,
    )
