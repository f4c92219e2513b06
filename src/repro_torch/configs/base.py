"""Configuration system: model, communication and sharding configs.

The port's own copy of the JAX package's ``configs/base.py`` dataclasses
(and of ``CommConfig`` from its ``core/planner.py``), so that the port
imports nothing of that package.  Every ported architecture gets a
``src/repro_torch/configs/<id>.py`` exporting ``CONFIG`` (the full published
configuration) and ``smoke_config()`` (a reduced variant of the same family
for CPU tests).  Sharding is expressed by logical-axis rules
(``ShardingConfig``, ``FSDP_TP_RULES``) mapped onto a mesh by
``launch/mesh.py`` and ``launch/sharding.py``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class CommConfig:
    """Framework-level communication configuration (first-class feature).

    Attached to every architecture config; consumed by ``training.train_step``
    and ``serving.engine``.
    """

    mode: str = "xla"                  # "xla" | "ring" | "r2ccl" | "recursive"
    degraded_rank: int | None = None   # data-parallel rank with lost bandwidth
    lost_fraction: float = 0.0         # X for that rank
    bandwidths: tuple[float, ...] = () # full spectrum for recursive mode
    devices_per_node: int = 8          # g in the Appendix-A coefficients
    #: wire dtype for the explicit gradient schedules; bf16 halves the ring
    #: bytes vs f32 gradients (EXPERIMENTS.md §Perf pair 3)
    comm_dtype: str = "bfloat16"

    def kwargs(self) -> dict:
        return dict(
            mode=self.mode,
            degraded=self.degraded_rank,
            lost_fraction=self.lost_fraction,
            bandwidths=self.bandwidths or None,
            g=self.devices_per_node,
        )


@dataclasses.dataclass(frozen=True)
class YaRNConfig:
    """YaRN scaling of the rotary frequencies (arXiv:2309.00071), as
    DeepSeek-V3's ``rope_scaling`` states it: frequencies blended between
    the plain ones and ``factor`` times slower across the band that
    ``beta_fast`` and ``beta_slow`` rotations bound at
    ``original_max_position_embeddings``; the softmax scale multiplied by
    ``(0.1 * mscale_all_dim * ln(factor) + 1) ** 2``."""

    factor: float = 1.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    kind: str = "gqa"                  # "gqa" | "mla" | "none"
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 64
    rope_theta: float = 10_000.0
    use_rope: bool = True
    sliding_window: int | None = None  # window for "local" layers
    logit_softcap: float | None = None # gemma2-style soft capping
    causal: bool = True                # False for encoder-only backbones
    # --- MLA (DeepSeek-V3) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # --- the port's own, past the JAX package (defaults: its behaviour) ---
    #: MLA's RMSNorms on the q and kv latents (``q_a_layernorm``,
    #: ``kv_a_layernorm``); the kv cache holds the normed latent
    latent_norms: bool = False
    #: YaRN scaling of MLA's rotary dims; None: plain rope
    yarn: YaRNConfig | None = None


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    num_shared_experts: int = 0
    expert_d_ff: int = 0               # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    first_k_dense: int = 0             # leading layers with dense FFN
    #: mesh axis for expert parallelism.  None = let GSPMD decide (it
    #: replicates the expert einsum because the dispatch scatter is
    #: data-dependent); "model" = force sharded dispatch buffers
    #: (see EXPERIMENTS.md §Perf, dbrx hillclimb).
    expert_axis: str | None = None
    # --- the port's own, past the JAX package (defaults: its behaviour) ---
    #: router scores: "softmax" (top-k of the softmax, renormalised) or
    #: "sigmoid" (DeepSeek-V3's ``noaux_tc``: top-k of sigmoid scores plus
    #: the ``router_bias`` parameter among the ``topk_group`` groups of
    #: ``n_group`` whose two best biased scores sum highest; the unbiased
    #: scores of the chosen experts renormalised)
    scoring: str = "softmax"
    n_group: int = 1
    topk_group: int = 1
    #: multiplies the routed experts' weights (DeepSeek-V3: 2.5)
    routed_scaling_factor: float = 1.0
    #: the experts held here, ``(first, count)``: the layer routes over all
    #: ``num_experts`` and computes only these experts' part of the result,
    #: dropless; None: all of them, through the capacity dispatch
    held_experts: tuple[int, int] | None = None


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma / Griffin recurrent block (arXiv:2402.19427)."""

    lru_width: int = 0                 # recurrence width (d_model if 0)
    conv_width: int = 4                # temporal conv1d window
    c_constant: float = 8.0            # 'c' in a = exp(-c * softplus(Lambda))


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    """RWKV-6 'Finch' (arXiv:2404.05892)."""

    head_size: int = 64
    decay_lora: int = 64               # low-rank dim of data-dependent decay
    tokenshift_lora: int = 32


@dataclasses.dataclass(frozen=True)
class ModalityConfig:
    """Frontend stub spec for [audio] / [vlm] architectures.

    Per the task carve-out, the conv/ViT frontend is not implemented; the
    model consumes precomputed frame/patch embeddings of this shape.
    """

    kind: str = "text"                 # "text" | "audio_frames" | "vision_text"
    frontend_dim: int = 0              # embedding dim produced by the stub
    num_prefix_tokens: int = 0         # e.g. image patches for VLM
    frame_rate_divisor: int = 1        # audio: frames per token position


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | vlm | audio
    source: str                        # citation for the configuration
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: AttentionConfig | None = None
    moe: MoEConfig | None = None
    rglru: RGLRUConfig | None = None
    rwkv: RWKVConfig | None = None
    modality: ModalityConfig = ModalityConfig()
    #: repeating block pattern; entries: "attn" | "local_attn" | "global_attn"
    #: | "rglru" | "rwkv".  Cycled over num_layers.
    block_pattern: tuple[str, ...] = ("attn",)
    activation: str = "swiglu"         # swiglu | geglu | gelu
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    encoder_only: bool = False
    embedding_scale: bool = False      # gemma multiplies embeddings by sqrt(d)
    dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: bool = True
    #: sliding-window size substituted for global attention in long-context
    #: decode configs (the framework's sub-quadratic variant for dense archs)
    long_context_window: int = 8192
    #: DeepSeek-V3 multi-token prediction: an auxiliary head predicting
    #: token t+2 from [h_t ; emb(token_{t+1})] through one extra block
    mtp: bool = False
    mtp_loss_weight: float = 0.3
    comm: CommConfig = dataclasses.field(default_factory=CommConfig)

    # -- derived -------------------------------------------------------------
    @property
    def pattern_layers(self) -> list[str]:
        p = self.block_pattern
        return [p[i % len(p)] for i in range(self.num_layers)]

    def param_count(self) -> float:
        """Approximate parameter count (embeddings + blocks)."""
        d, L, v = self.d_model, self.num_layers, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        for kind in self.pattern_layers:
            if kind in ("attn", "local_attn", "global_attn") and self.attention:
                a = self.attention
                if a.kind == "mla":
                    q = d * a.q_lora_rank + a.q_lora_rank * a.num_heads * (
                        a.qk_nope_head_dim + a.qk_rope_head_dim)
                    kv = d * (a.kv_lora_rank + a.qk_rope_head_dim) + \
                        a.kv_lora_rank * a.num_heads * (a.qk_nope_head_dim + a.v_head_dim)
                    o = a.num_heads * a.v_head_dim * d
                    total += q + kv + o
                elif a.kind == "gqa":
                    total += d * a.num_heads * a.head_dim        # Q
                    total += 2 * d * a.num_kv_heads * a.head_dim  # K,V
                    total += a.num_heads * a.head_dim * d        # O
            elif kind == "rglru" and self.rglru:
                w = self.rglru.lru_width or d
                total += 2 * d * w + w * d + 3 * w + self.rglru.conv_width * w
            elif kind == "rwkv" and self.rwkv:
                total += 5 * d * d + d * self.rwkv.decay_lora * 2
            # FFN / MoE for every block
            if self.moe and self.moe.num_experts > 0:
                e = self.moe
                ff = e.expert_d_ff or self.d_ff
                gates = 3 if self.activation in ("swiglu", "geglu") else 2
                total += e.num_experts * gates * d * ff + d * e.num_experts
                total += e.num_shared_experts * gates * d * ff
            else:
                gates = 3 if self.activation in ("swiglu", "geglu") else 2
                total += gates * d * self.d_ff
        return float(total)

    def active_param_count(self) -> float:
        """Params touched per token (MoE: top-k + shared experts only)."""
        if not self.moe or self.moe.num_experts == 0:
            return self.param_count()
        e = self.moe
        ff = e.expert_d_ff or self.d_ff
        gates = 3 if self.activation in ("swiglu", "geglu") else 2
        per_layer_all = e.num_experts * gates * self.d_model * ff
        per_layer_active = (e.top_k + e.num_shared_experts) * gates * self.d_model * ff
        n_moe_layers = self.num_layers - e.first_k_dense
        return self.param_count() - n_moe_layers * (per_layer_all - per_layer_active)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                          # "train" | "prefill" | "decode"


#: The four assigned global input shapes.
INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Logical-axis -> mesh-axis rules (MaxText-style)."""

    mode: str = "tp"                   # "tp" | "fsdp_tp"
    rules: tuple[tuple[str, tuple[str, ...] | str | None], ...] = (
        ("batch", ("pod", "data")),
        ("seq", None),
        ("embed", None),
        ("heads", "model"),
        ("kv_heads", "model"),
        ("mlp", "model"),
        ("vocab", "model"),
        ("experts", "model"),
        ("expert_embed", None),
        ("expert_mlp", None),
        ("lru", "model"),
        ("cache_seq", None),
    )

    def lookup(self) -> dict[str, tuple[str, ...] | str | None]:
        return dict(self.rules)


FSDP_TP_RULES: tuple[tuple[str, tuple[str, ...] | str | None], ...] = (
    ("batch", ("pod", "data")),
    ("seq", None),
    ("embed", ("pod", "data")),       # ZeRO-3-style: shard params over data too
    ("heads", "model"),
    ("kv_heads", "model"),
    ("mlp", "model"),
    ("vocab", "model"),
    ("experts", "model"),
    # Expert weights shard only on the expert dim: the JAX package found that
    # sharding a second axis over data made GSPMD replicate all expert compute
    ("expert_embed", None),
    ("expert_mlp", None),
    ("lru", "model"),
    ("cache_seq", None),
)
