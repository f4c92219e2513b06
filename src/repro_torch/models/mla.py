"""Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437).

The port of the JAX package's ``models/mla.py``, with its param names,
shapes and axis order (``w_uq`` ``(q_lora, H, nope + rope)``, ``w_uk``
``(kv_lora, H, nope)``, ``w_o`` ``(H, v, d)``), so weights convert without
a transpose.

KV activations are compressed into a low-rank latent ``c_kv`` plus a shared
RoPE key ``k_pe``; the cache stores only ``kv_lora_rank + qk_rope_head_dim``
floats per token.  Queries come through a low-rank projection too.

Train and prefill decompress K and V per head and run
``layers.blockwise_attention`` (the flash-attention kernel on the card) at
the query/key width ``nope + rope``, with V zero-padded to that width and
the output sliced back, and the scale ``1/sqrt(nope + rope)`` passed
explicitly.  Decode runs the absorbed form in plain PyTorch, as the JAX
package runs it in jnp: ``W_uk`` is folded into the query and ``W_uv``
into the output, so attention reads the cached latents directly.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .layers import (NEG_INF, _einsum, _mm, _project, apply_rope, blockwise_attention,
                     dense_init)


def init_mla(gen: torch.Generator, d_model: int, num_heads: int, *,
             q_lora_rank: int, kv_lora_rank: int, qk_nope_head_dim: int,
             qk_rope_head_dim: int, v_head_dim: int, lead=(),
             dtype=torch.float32) -> dict:
    """MLA params with the JAX package's distributions, drawn from ``gen``;
    ``lead`` prefixes every shape (the stacked ``n_groups`` axis)."""
    d, H, qk = d_model, num_heads, qk_nope_head_dim + qk_rope_head_dim
    return {
        # query path: d -> q_lora -> heads * (nope + rope)
        "w_dq": dense_init(gen, (*lead, d, q_lora_rank), d, dtype),
        "w_uq": dense_init(gen, (*lead, q_lora_rank, H, qk), q_lora_rank, dtype),
        # kv path: d -> kv_lora (+ the shared rope key)
        "w_dkv": dense_init(gen, (*lead, d, kv_lora_rank), d, dtype),
        "w_kpe": dense_init(gen, (*lead, d, qk_rope_head_dim), d, dtype),
        "w_uk": dense_init(gen, (*lead, kv_lora_rank, H, qk_nope_head_dim),
                           kv_lora_rank, dtype),
        "w_uv": dense_init(gen, (*lead, kv_lora_rank, H, v_head_dim), kv_lora_rank,
                           dtype),
        "w_o": dense_init(gen, (*lead, H, v_head_dim, d), H * v_head_dim, dtype),
    }


#: logical sharding axes of ``init_mla``'s params (the JAX package's)
MLA_AXES = {"w_dq": ("embed", None), "w_uq": (None, "heads", None),
            "w_dkv": ("embed", None), "w_kpe": ("embed", None),
            "w_uk": (None, "heads", None), "w_uv": (None, "heads", None),
            "w_o": ("heads", None, "embed")}


@dataclasses.dataclass
class MLACache:
    """Latent KV cache, written in place like ``layers.KVCache``; ``index``
    (the next absolute position) is a Python int."""

    c_kv: torch.Tensor           # (B, S, kv_lora_rank)
    k_pe: torch.Tensor           # (B, S, qk_rope_head_dim)
    index: int


def init_mla_cache(batch: int, size: int, kv_lora_rank: int, qk_rope_head_dim: int,
                   dtype=torch.bfloat16, device=None, lead=()) -> MLACache:
    return MLACache(
        c_kv=torch.zeros(*lead, batch, size, kv_lora_rank, dtype=dtype, device=device),
        k_pe=torch.zeros(*lead, batch, size, qk_rope_head_dim, dtype=dtype,
                         device=device),
        index=0,
    )


def _out_proj(out: torch.Tensor, w_o: torch.Tensor) -> torch.Tensor:
    """einsum("bthv,hvd->btd") as one matmul."""
    H, V, d = w_o.shape
    return _mm(out.reshape(*out.shape[:2], H * V), w_o.reshape(H * V, d))


def mla_attention(
    params,
    x: torch.Tensor,             # (B, T, d)
    *,
    num_heads: int,
    qk_nope_head_dim: int,
    qk_rope_head_dim: int,
    v_head_dim: int,
    rope_theta: float = 10_000.0,
    cache: MLACache | None = None,
    mode: str = "train",         # train | prefill | decode
    impl: str = "auto",
) -> tuple[torch.Tensor, MLACache | None]:
    """MLA over ``x``.  ``train`` keeps no cache; ``prefill`` writes the
    latents of the last ``min(S, T)`` tokens into slots ``[0, min(S, T))`` of
    ``cache`` (a new bf16 cache of T slots if none is given) and ``decode``
    writes one token at slot ``index % S``, both in place."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got {mode!r}")
    B, T, _ = x.shape
    H, nope, rope = num_heads, qk_nope_head_dim, qk_rope_head_dim
    qk = nope + rope
    scale = 1.0 / math.sqrt(qk)

    q = _project(_mm(x, params["w_dq"]), params["w_uq"])       # (B,T,H,nope+rope)
    q_nope, q_pe = q[..., :nope], q[..., nope:]

    if mode == "decode":
        if cache is None or T != 1:
            raise ValueError(f"decode takes one token and a cache, got T={T}")
        pos = cache.index
        p = torch.full((B, 1), pos, device=x.device)
        q_pe = apply_rope(q_pe, p, rope_theta)
        c_new = _mm(x, params["w_dkv"])                        # (B,1,R)
        kpe_new = apply_rope(_mm(x, params["w_kpe"])[:, :, None, :], p,
                             rope_theta)[:, :, 0]
        S = cache.c_kv.shape[1]
        slot = pos % S
        cache.c_kv[:, slot] = c_new[:, 0].to(cache.c_kv.dtype)
        cache.k_pe[:, slot] = kpe_new[:, 0].to(cache.k_pe.dtype)
        c_all, kpe_all = cache.c_kv, cache.k_pe
        # absorbed: score = (q_nope W_uk^T) c_kv^T + q_pe k_pe^T
        q_abs = _einsum("bthk,rhk->bthr", q_nope, params["w_uk"])    # (B,1,H,R)
        s_nope = torch.einsum("bthr,bsr->bhts", q_abs, c_all.to(q_abs.dtype))
        s_pe = torch.einsum("bthk,bsk->bhts", q_pe, kpe_all.to(q_pe.dtype))
        s = (s_nope + s_pe).float() * scale                    # (B,H,1,S)
        valid = torch.arange(S, device=x.device) < min(pos + 1, S)   # ring validity
        s = torch.where(valid, s, NEG_INF)
        prob = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhts,bsr->bthr", prob.to(c_all.dtype), c_all)  # (B,1,H,R)
        out = _einsum("bthr,rhv->bthv", ctx, params["w_uv"])   # (B,1,H,v)
        return _out_proj(out, params["w_o"]), MLACache(c_all, kpe_all, pos + 1)

    positions = torch.arange(T, device=x.device)[None, :]
    q_pe = apply_rope(q_pe, positions, rope_theta)
    c_kv = _mm(x, params["w_dkv"])                             # (B,T,R)
    k_pe = apply_rope(_mm(x, params["w_kpe"])[:, :, None, :], positions,
                      rope_theta)[:, :, 0]                     # (B,T,rope)
    k_nope = _project(c_kv, params["w_uk"])                    # (B,T,H,nope)
    v = _project(c_kv, params["w_uv"])                         # (B,T,H,v)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(B, T, H, rope)], dim=-1)
    q_full = torch.cat([q_nope, q_pe], dim=-1)
    # v padded to the query/key width for the one-width kernel, then sliced
    v_in = F.pad(v, (0, qk - v_head_dim)) if v_head_dim < qk else v
    out = blockwise_attention(q_full.reshape(B, T, H, 1, qk), k, v_in, causal=True,
                              scale=scale, impl=impl)
    y = _out_proj(out.reshape(B, T, H, qk)[..., :v_head_dim], params["w_o"])
    if mode == "train":
        return y, None

    if cache is None:
        cache = init_mla_cache(B, T, c_kv.shape[-1], rope, device=x.device)
    keep = min(cache.c_kv.shape[1], T)
    cache.c_kv.zero_()
    cache.k_pe.zero_()
    cache.c_kv[:, :keep] = c_kv[:, T - keep:].to(cache.c_kv.dtype)
    cache.k_pe[:, :keep] = k_pe[:, T - keep:].to(cache.k_pe.dtype)
    return y, MLACache(cache.c_kv, cache.k_pe, T)
