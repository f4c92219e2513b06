"""DeepSeek-V3-671B [moe] — MLA + 1 shared + 256 routed experts, top-8.

61L d_model=7168 128H (MLA) expert_d_ff=2048 vocab=129280  [arXiv:2412.19437]
First 3 layers use a dense FFN (d_ff=18432); the remaining 58 are MoE.
MLA: q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v=128.
MTP (multi-token prediction) is implemented as the auxiliary head of the
paper: one extra block over [h_t ; emb(t_{t+1})] predicting token t+2,
weighted 0.3 in the training loss (cfg.mtp / cfg.mtp_loss_weight).
"""

import dataclasses

from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig, YaRNConfig


CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    source="arXiv:2412.19437",
    num_layers=61,
    d_model=7168,
    d_ff=18432,                     # dense FFN width (first_k_dense layers)
    vocab_size=129_280,
    attention=AttentionConfig(
        kind="mla", num_heads=128, num_kv_heads=128, head_dim=128,
        rope_theta=10_000.0,
        q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    ),
    moe=MoEConfig(num_experts=256, top_k=8, num_shared_experts=1,
                  expert_d_ff=2048, capacity_factor=1.25, first_k_dense=3),
    block_pattern=("attn",),
    activation="swiglu",
    norm="rmsnorm",
    mtp=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-smoke",
        family="moe",
        source=CONFIG.source,
        num_layers=3,               # 1 dense + 2 moe
        d_model=128,
        d_ff=256,
        vocab_size=512,
        attention=AttentionConfig(
            kind="mla", num_heads=4, num_kv_heads=4, head_dim=32,
            q_lora_rank=48, kv_lora_rank=32,
            qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
        ),
        moe=MoEConfig(num_experts=4, top_k=2, num_shared_experts=1,
                      expert_d_ff=64, capacity_factor=2.0, first_k_dense=1),
        block_pattern=("attn",),
        activation="swiglu",
        norm="rmsnorm",
        remat=False,
        mtp=True,
    )


#: ``rope_scaling`` of the published config.json
YARN = YaRNConfig(factor=40.0, original_max_position_embeddings=4096, beta_fast=32.0,
                  beta_slow=1.0, mscale=1.0, mscale_all_dim=1.0)


def published(cfg: ModelConfig = CONFIG, *, held_experts: tuple[int, int] | None = None,
              n_group: int = 8, topk_group: int = 4, **changes) -> ModelConfig:
    """``cfg`` as DeepSeek-V3's config.json states the model, past what the
    JAX package runs: the latent norms, YaRN (``YARN``), the sigmoid router
    over ``n_group`` groups keeping ``topk_group``, routed weights times 2.5;
    served, so no MTP head.  The layer holds ``held_experts`` (first,
    count) of the experts (None: all of them).  ``changes`` replace other
    fields (``num_layers``)."""
    m = cfg.moe
    return dataclasses.replace(
        cfg, mtp=False,
        attention=dataclasses.replace(cfg.attention, latent_norms=True, yarn=YARN),
        moe=dataclasses.replace(m, scoring="sigmoid", n_group=n_group, topk_group=topk_group,
                                routed_scaling_factor=2.5,
                                held_experts=held_experts or (0, m.num_experts)),
        **changes)
