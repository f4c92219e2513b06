"""Model FLOPs of a DeepSeek-V3 configuration (``configs/deepseek-v3-*.json``),
counted from the configuration as ``formulas.py`` counts a llama's: the
matrix products (``2 * N`` a token forward) plus attention's two products
over the causal pairs.

Per token every layer's MLA products, the dense FFNs of the first
``first_k_dense_replace`` layers, and in each MoE layer the router (at the
published ``n_routed_experts_published`` outputs) and the shared expert.
The held experts are counted by the slots routed to them (``held_slots``,
the program's count of real (token, choice) slots: an expert's products
run only on the tokens that chose it).  Attention: ``QK^T`` at the query/key
width ``qk_nope_head_dim + qk_rope_head_dim`` (192) and ``PV`` at
``v_head_dim`` (128), ``2 * (192 + 128)`` a pair and head.  The head at each
prompt's last token.
"""

from __future__ import annotations


def mla_params(c: dict) -> int:
    """Weights of one MLA's products: W_dq, W_uq, W_dkv, W_kpe, W_uk, W_uv,
    W_o."""
    d, H, ql, R = (c["hidden_size"], c["num_attention_heads"], c["q_lora_rank"],
                   c["kv_lora_rank"])
    nope, rope, vd = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    return (d * ql + ql * H * (nope + rope) + d * R + d * rope + R * H * nope
            + R * H * vd + H * vd * d)


def expert_params(c: dict) -> int:
    """One routed expert's SwiGLU."""
    return 3 * c["hidden_size"] * c["moe_intermediate_size"]


def token_params(c: dict) -> int:
    """Weights every token's products read through the layers: MLA, the
    dense FFNs, and each MoE layer's router and shared experts."""
    d, L, k = c["hidden_size"], c["num_hidden_layers"], c["first_k_dense_replace"]
    moe = d * c["n_routed_experts_published"] + c["n_shared_experts"] * expert_params(c)
    return L * mla_params(c) + k * 3 * d * c["intermediate_size"] + (L - k) * moe


def attention_fwd_flops(c: dict, seq_len: int) -> int:
    """``QK^T`` and ``PV`` of one causal sequence through every layer."""
    pairs = seq_len * (seq_len + 1) // 2
    width = c["qk_nope_head_dim"] + c["qk_rope_head_dim"] + c["v_head_dim"]
    return c["num_hidden_layers"] * 2 * width * c["num_attention_heads"] * pairs


def prefill_flops(c: dict, prompt_lens, held_slots: float) -> float:
    """Prefill of prompts of ``prompt_lens`` real tokens whose (token, MoE
    layer) choices put ``held_slots`` slots on the held experts."""
    return (2.0 * token_params(c) * sum(prompt_lens)
            + 2.0 * expert_params(c) * held_slots
            + 2.0 * c["hidden_size"] * c["vocab_size"] * len(prompt_lens)
            + sum(attention_fwd_flops(c, t) for t in prompt_lens))
