"""DBRX-132B [moe] — 16 experts, top-4, fine-grained.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 (per expert) vocab=100352
[hf:databricks/dbrx-base]
"""

from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig


CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    source="hf:databricks/dbrx-base",
    num_layers=40,
    d_model=6144,
    d_ff=10752,
    vocab_size=100_352,
    attention=AttentionConfig(
        kind="gqa", num_heads=48, num_kv_heads=8, head_dim=128,
        rope_theta=500_000.0,
    ),
    moe=MoEConfig(num_experts=16, top_k=4, expert_d_ff=10752,
                  capacity_factor=1.25),
    block_pattern=("attn",),
    activation="swiglu",
    norm="layernorm",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-smoke",
        family="moe",
        source=CONFIG.source,
        num_layers=2,
        d_model=128,
        d_ff=192,
        vocab_size=512,
        attention=AttentionConfig(kind="gqa", num_heads=8, num_kv_heads=2,
                                  head_dim=16, rope_theta=500_000.0),
        moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=192,
                      capacity_factor=2.0),
        block_pattern=("attn",),
        activation="swiglu",
        norm="layernorm",
        remat=False,
    )
