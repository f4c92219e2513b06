"""SmolLM-360M [dense] — llama-architecture small model.

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152
[hf:HuggingFaceTB/SmolLM-135M family]
"""

from repro_torch.configs.base import AttentionConfig, ModelConfig


CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    source="hf:HuggingFaceTB/SmolLM-360M",
    num_layers=32,
    d_model=960,
    d_ff=2560,
    vocab_size=49_152,
    attention=AttentionConfig(
        kind="gqa", num_heads=15, num_kv_heads=5, head_dim=64,
        rope_theta=10_000.0,
    ),
    block_pattern=("attn",),
    activation="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="smollm-smoke",
        family="dense",
        source=CONFIG.source,
        num_layers=2,
        d_model=120,
        d_ff=320,
        vocab_size=512,
        attention=AttentionConfig(kind="gqa", num_heads=6, num_kv_heads=2,
                                  head_dim=20),
        block_pattern=("attn",),
        activation="swiglu",
        norm="rmsnorm",
        tie_embeddings=True,
        remat=False,
    )
