"""Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437).

The port of the JAX package's ``models/mla.py``, with its param names,
shapes and axis order (``w_uq`` ``(q_lora, H, nope + rope)``, ``w_uk``
``(kv_lora, H, nope)``, ``w_o`` ``(H, v, d)``), so weights convert without
a transpose.

KV activations are compressed into a low-rank latent ``c_kv`` plus a shared
RoPE key ``k_pe``; the cache stores only ``kv_lora_rank + qk_rope_head_dim``
floats per token.  Queries come through a low-rank projection too.

DeepSeek-V3 as published adds, past the JAX package (both off by
default): RMSNorms on the q latent and the kv latent (``q_norm``,
``kv_norm``; the cache holds the normed latent), and YaRN scaling of the
rotary dims (``yarn``): blended frequencies, and the softmax scale
multiplied by ``yarn_mscale(factor, mscale_all_dim) ** 2``.

Train and prefill decompress K and V per head and run
``layers.blockwise_attention`` (the flash-attention kernel on the card) at
the query/key width ``nope + rope``, with V zero-padded to that width and
the output sliced back, and the scale ``1/sqrt(nope + rope)`` passed
explicitly.  Decode runs the absorbed form, as the JAX package runs it in
jnp: ``W_uk`` is folded into the query and ``W_uv`` into the output, so
attention reads the cached latents directly, through ``ops.mla_decode``
(the MLA decode kernel on the card, its plain version elsewhere).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import YaRNConfig
from repro_torch.kernels import ops

from .layers import (_einsum, _mm, _project, apply_rope, blockwise_attention, dense_init,
                     rmsnorm)


def init_mla(gen: torch.Generator, d_model: int, num_heads: int, *,
             q_lora_rank: int, kv_lora_rank: int, qk_nope_head_dim: int,
             qk_rope_head_dim: int, v_head_dim: int, latent_norms: bool = False,
             lead=(), dtype=torch.float32) -> dict:
    """MLA params with the JAX package's distributions, drawn from ``gen``;
    ``lead`` prefixes every shape (the stacked ``n_groups`` axis).  With
    ``latent_norms`` also the latents' RMSNorm scales ``q_norm`` and
    ``kv_norm`` (zeros: a norm multiplies by ``1 + scale``)."""
    d, H, qk = d_model, num_heads, qk_nope_head_dim + qk_rope_head_dim
    params = {
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
    if latent_norms:
        params["q_norm"] = torch.zeros(*lead, q_lora_rank, device=gen.device)
        params["kv_norm"] = torch.zeros(*lead, kv_lora_rank, device=gen.device)
    return params


#: logical sharding axes of ``init_mla``'s params (the JAX package's)
MLA_AXES = {"w_dq": ("embed", None), "w_uq": (None, "heads", None),
            "w_dkv": ("embed", None), "w_kpe": ("embed", None),
            "w_uk": (None, "heads", None), "w_uv": (None, "heads", None),
            "w_o": ("heads", None, "embed")}
#: ... and of the latent norms' scales (replicated)
LATENT_NORM_AXES = {"q_norm": (None,), "kv_norm": (None,)}


@dataclasses.dataclass
class MLACache:
    """Latent KV cache, written in place like ``layers.KVCache``.  ``index``
    (the next absolute position) is a Python int, as the cache specs and
    the dry run count it, or, made with ``device_index``, an int64 tensor
    on the cache's device (one a group in a stacked cache) that prefill
    sets and decode reads and advances in place: a decode step then needs
    nothing from the host and replays as a CUDA graph."""

    c_kv: torch.Tensor           # (B, S, kv_lora_rank)
    k_pe: torch.Tensor           # (B, S, qk_rope_head_dim)
    index: int | torch.Tensor


def init_mla_cache(batch: int, size: int, kv_lora_rank: int, qk_rope_head_dim: int,
                   dtype=torch.bfloat16, device=None, lead=(),
                   device_index: bool = False) -> MLACache:
    return MLACache(
        c_kv=torch.zeros(*lead, batch, size, kv_lora_rank, dtype=dtype, device=device),
        k_pe=torch.zeros(*lead, batch, size, qk_rope_head_dim, dtype=dtype,
                         device=device),
        index=torch.zeros(lead, dtype=torch.int64, device=device) if device_index else 0,
    )


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature term, ``0.1 * mscale * ln(factor) + 1``
    (1 at ``factor`` <= 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def _correction_dim(rotations: float, dim: int, theta: float, max_pos: int) -> float:
    """The rotary dim whose wavelength makes ``rotations`` turns over
    ``max_pos`` positions."""
    return dim * math.log(max_pos / (rotations * 2 * math.pi)) / (2 * math.log(theta))


def yarn_frequencies(dim: int, theta: float, yarn: YaRNConfig, device=None) -> torch.Tensor:
    """YaRN's (dim/2,) rotary frequencies: the plain ones below the
    ``beta_fast`` correction dim, ``factor`` times slower above the
    ``beta_slow`` one, a linear ramp between."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    plain = 1.0 / (theta ** exps)
    slow = 1.0 / (yarn.factor * theta ** exps)
    n = yarn.original_max_position_embeddings
    low = max(math.floor(_correction_dim(yarn.beta_fast, dim, theta, n)), 0)
    high = min(math.ceil(_correction_dim(yarn.beta_slow, dim, theta, n)), dim - 1)
    keep = 1.0 - ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
                  / (high - low if high > low else 0.001)).clamp(0, 1)
    return slow * (1 - keep) + plain * keep


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
          yarn: YaRNConfig | None) -> torch.Tensor:
    """Split-half rope, YaRN's frequencies and rotary mscale where given."""
    if yarn is None:
        return apply_rope(x, positions, theta)
    out = apply_rope(x, positions, theta, yarn_frequencies(x.shape[-1], theta, yarn, x.device))
    m = yarn_mscale(yarn.factor, yarn.mscale) / yarn_mscale(yarn.factor, yarn.mscale_all_dim)
    return out if m == 1.0 else out * m


def softmax_scale(qk_head_dim: int, yarn: YaRNConfig | None = None) -> float:
    """``1/sqrt(nope + rope)``, times ``yarn_mscale(factor, mscale_all_dim)
    ** 2`` under YaRN with ``mscale_all_dim`` set."""
    scale = 1.0 / math.sqrt(qk_head_dim)
    if yarn is not None and yarn.mscale_all_dim:
        scale *= yarn_mscale(yarn.factor, yarn.mscale_all_dim) ** 2
    return scale


def _latent_norm(params, name: str, c: torch.Tensor) -> torch.Tensor:
    """The latent's RMSNorm where the params hold its scale."""
    return rmsnorm({"scale": params[name]}, c) if name in params else c


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
    yarn: YaRNConfig | None = None,
    cache: MLACache | None = None,
    mode: str = "train",         # train | prefill | decode
) -> tuple[torch.Tensor, MLACache | None]:
    """MLA over ``x``.  ``train`` keeps no cache; ``prefill`` writes the
    latents of the last ``min(S, T)`` tokens into slots ``[0, min(S, T))`` of
    ``cache`` (a new bf16 cache of T slots if none is given) and ``decode``
    writes one token at slot ``index % S``, both in place.  The latent
    norms run where ``params`` hold ``q_norm`` and ``kv_norm``."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got {mode!r}")
    B, T, _ = x.shape
    H, nope, rope = num_heads, qk_nope_head_dim, qk_rope_head_dim
    qk = nope + rope
    scale = softmax_scale(qk, yarn)

    q = _project(_latent_norm(params, "q_norm", _mm(x, params["w_dq"])),
                 params["w_uq"])                               # (B,T,H,nope+rope)
    q_nope, q_pe = q[..., :nope], q[..., nope:]

    if mode == "decode":
        if cache is None or T != 1:
            raise ValueError(f"decode takes one token and a cache, got T={T}")
        pos = cache.index
        S = cache.c_kv.shape[1]
        if isinstance(pos, torch.Tensor):          # on the device: no host read
            p = pos.expand(B, 1)
            slot = (pos % S).view(1)
        else:
            p = torch.full((B, 1), pos, device=x.device)
            slot = slice(pos % S, pos % S + 1)
        q_pe = _rope(q_pe, p, rope_theta, yarn)
        c_new = _latent_norm(params, "kv_norm", _mm(x, params["w_dkv"]))   # (B,1,R)
        kpe_new = _rope(_mm(x, params["w_kpe"])[:, :, None, :], p, rope_theta,
                        yarn)[:, :, 0]
        cache.c_kv[:, slot] = c_new.to(cache.c_kv.dtype)       # index_put_ at a tensor slot
        cache.k_pe[:, slot] = kpe_new.to(cache.k_pe.dtype)
        c_all, kpe_all = cache.c_kv, cache.k_pe
        # absorbed: score = (q_nope W_uk^T) c_kv^T + q_pe k_pe^T
        q_abs = _einsum("bthk,rhk->bthr", q_nope, params["w_uk"])    # (B,1,H,R)
        ctx = ops.mla_decode(q_abs, q_pe, c_all, kpe_all, pos, scale)  # (B,1,H,R)
        out = _einsum("bthr,rhv->bthv", ctx, params["w_uv"])   # (B,1,H,v)
        y = _out_proj(out, params["w_o"])
        if isinstance(pos, torch.Tensor):
            pos.add_(1)                            # after every read of it, in stream order
            return y, cache
        return y, MLACache(c_all, kpe_all, pos + 1)

    positions = torch.arange(T, device=x.device)[None, :]
    q_pe = _rope(q_pe, positions, rope_theta, yarn)
    c_kv = _latent_norm(params, "kv_norm", _mm(x, params["w_dkv"]))        # (B,T,R)
    k_pe = _rope(_mm(x, params["w_kpe"])[:, :, None, :], positions, rope_theta,
                 yarn)[:, :, 0]                                # (B,T,rope)
    k_nope = _project(c_kv, params["w_uk"])                    # (B,T,H,nope)
    v = _project(c_kv, params["w_uv"])                         # (B,T,H,v)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(B, T, H, rope)], dim=-1)
    q_full = torch.cat([q_nope, q_pe], dim=-1)
    # v padded to the query/key width for the one-width kernel, then sliced
    v_in = F.pad(v, (0, qk - v_head_dim)) if v_head_dim < qk else v
    out = blockwise_attention(q_full.reshape(B, T, H, 1, qk), k, v_in, causal=True,
                              scale=scale)
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
    if isinstance(cache.index, torch.Tensor):
        cache.index.fill_(T)
        return y, cache
    return y, MLACache(cache.c_kv, cache.k_pe, T)
