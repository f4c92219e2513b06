"""Gemma2-27B [dense] — local/global alternating attention + logit softcap.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000  [arXiv:2408.00118]
Sliding window 4096 on local layers; attention logit softcap 50, final
logit softcap 30.  (Gemma2's extra post-norms are folded into the pre-norm
formulation — noted in DESIGN.md.)
"""

from repro_torch.configs.base import AttentionConfig, ModelConfig


CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    source="arXiv:2408.00118",
    num_layers=46,
    d_model=4608,
    d_ff=36864,
    vocab_size=256_000,
    attention=AttentionConfig(
        kind="gqa", num_heads=32, num_kv_heads=16, head_dim=128,
        rope_theta=10_000.0, sliding_window=4096, logit_softcap=50.0,
    ),
    block_pattern=("local_attn", "global_attn"),
    activation="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
    embedding_scale=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-smoke",
        family="dense",
        source=CONFIG.source,
        num_layers=2,
        d_model=128,
        d_ff=384,
        vocab_size=512,
        attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=2,
                                  head_dim=32, sliding_window=16,
                                  logit_softcap=50.0),
        block_pattern=("local_attn", "global_attn"),
        activation="geglu",
        norm="rmsnorm",
        tie_embeddings=True,
        embedding_scale=True,
        remat=False,
    )
