"""RWKV6-1.6B [ssm] — Finch, data-dependent decay; attention-free.

24L d_model=2048 d_ff=7168 (channel-mix 3.5x) vocab=65536  [arXiv:2404.05892]
"""

from repro_torch.configs.base import ModelConfig, RWKVConfig


CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    source="arXiv:2404.05892",
    num_layers=24,
    d_model=2048,
    d_ff=7168,
    vocab_size=65_536,
    attention=None,
    rwkv=RWKVConfig(head_size=64, decay_lora=64, tokenshift_lora=32),
    block_pattern=("rwkv",),
    activation="swiglu",           # unused by rwkv blocks (channel-mix inside)
    norm="layernorm",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke",
        family="ssm",
        source=CONFIG.source,
        num_layers=2,
        d_model=128,
        d_ff=448,
        vocab_size=512,
        attention=None,
        rwkv=RWKVConfig(head_size=32, decay_lora=16, tokenshift_lora=8),
        block_pattern=("rwkv",),
        activation="swiglu",
        norm="layernorm",
        remat=False,
    )
