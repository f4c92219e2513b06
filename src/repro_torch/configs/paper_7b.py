"""The paper's simulated 7B training model (Fig. 8) — llama-architecture.

Used by the training-resilience benchmarks: 32L d_model=4096 32H
d_ff=11008 vocab=32000, global batch 512, on 4-64 8xA100 servers.
"""

from repro_torch.configs.base import AttentionConfig, ModelConfig


CONFIG = ModelConfig(
    name="paper-7b",
    family="dense",
    source="R2CCL paper Section 8.2 (SimAI 7B)",
    num_layers=32,
    d_model=4096,
    d_ff=11008,
    vocab_size=32_000,
    attention=AttentionConfig(
        kind="gqa", num_heads=32, num_kv_heads=32, head_dim=128,
    ),
    block_pattern=("attn",),
    activation="swiglu",
    norm="rmsnorm",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="paper-7b-smoke",
        family="dense",
        source=CONFIG.source,
        num_layers=2,
        d_model=128,
        d_ff=256,
        vocab_size=512,
        attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=4,
                                  head_dim=32),
        block_pattern=("attn",),
        activation="swiglu",
        norm="rmsnorm",
        remat=False,
    )
