"""PaliGemma-3B [vlm] — SigLIP patch embeddings + Gemma decoder.

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216  [arXiv:2407.07726]
The SigLIP So400m vision tower is a STUB per the task carve-out:
``input_specs()`` supplies 256 precomputed patch embeddings (dim 1152);
the linear projector + Gemma-style decoder (prefix-LM over the image
prefix) are implemented.
"""

from repro_torch.configs.base import AttentionConfig, ModalityConfig, ModelConfig


CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    source="arXiv:2407.07726",
    num_layers=18,
    d_model=2048,
    d_ff=16384,
    vocab_size=257_216,
    attention=AttentionConfig(
        kind="gqa", num_heads=8, num_kv_heads=1, head_dim=256,
        rope_theta=10_000.0,
    ),
    modality=ModalityConfig(kind="vision_text", frontend_dim=1152,
                            num_prefix_tokens=256),
    block_pattern=("attn",),
    activation="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
    embedding_scale=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-smoke",
        family="vlm",
        source=CONFIG.source,
        num_layers=2,
        d_model=128,
        d_ff=256,
        vocab_size=512,
        attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=1,
                                  head_dim=32),
        modality=ModalityConfig(kind="vision_text", frontend_dim=48,
                                num_prefix_tokens=8),
        block_pattern=("attn",),
        activation="geglu",
        norm="rmsnorm",
        tie_embeddings=True,
        embedding_scale=True,
        remat=False,
    )
