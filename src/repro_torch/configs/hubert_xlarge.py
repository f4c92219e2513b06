"""HuBERT-XLarge [audio] — encoder-only masked-unit prediction.

48L d_model=1280 16H (MHA kv=16) d_ff=5120 vocab=504 (cluster units)
[arXiv:2106.07447]  Encoder-only: no decode step (decode_32k / long_500k
are skipped for this arch — see DESIGN.md).  The mel-spectrogram + conv
feature extractor is a STUB: ``input_specs()`` supplies precomputed frame
embeddings (dim 512).
"""

from repro_torch.configs.base import AttentionConfig, ModalityConfig, ModelConfig


CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    source="arXiv:2106.07447",
    num_layers=48,
    d_model=1280,
    d_ff=5120,
    vocab_size=504,
    attention=AttentionConfig(
        kind="gqa", num_heads=16, num_kv_heads=16, head_dim=80,
        use_rope=False, causal=False,
    ),
    modality=ModalityConfig(kind="audio_frames", frontend_dim=512),
    block_pattern=("attn",),
    activation="gelu",
    norm="layernorm",
    encoder_only=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-smoke",
        family="audio",
        source=CONFIG.source,
        num_layers=2,
        d_model=128,
        d_ff=256,
        vocab_size=104,
        attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=4,
                                  head_dim=32, use_rope=False, causal=False),
        modality=ModalityConfig(kind="audio_frames", frontend_dim=48),
        block_pattern=("attn",),
        activation="gelu",
        norm="layernorm",
        encoder_only=True,
        remat=False,
    )
