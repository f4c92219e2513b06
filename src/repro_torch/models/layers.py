"""Shared model layers: norms, RoPE, GQA attention, gated MLPs (dense subset).

The port of the JAX package's ``models/layers.py``.  Parameters are nested
dicts of tensors with the same keys, shapes and axis order (``wq`` is
``(d, H, D)``, ``wo`` is ``(H, D, d)``), so weights convert without a
transpose.

Dtypes follow JAX's promotion: the residual stream may be bfloat16 while the
weights are float32, and JAX promotes ``bf16 x fp32`` to fp32 in ``einsum``
and ``@``.  PyTorch refuses mixed-dtype products, so :func:`_mm` promotes
explicitly, as ``jnp.result_type`` does.

Train and prefill attention go through ``kernels.ops.flash_attention``: the
hand-written Hopper kernels for CUDA tensors (forward, and in training the
backward kernel through ``autograd``), the plain version on the CPU.  Decode
attention is one query against the cache, computed in plain PyTorch as the
JAX package computes it outside any kernel.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

Params = dict

# ---------------------------------------------------------------------------
# init helpers (the JAX package's distributions, from a torch.Generator)
# ---------------------------------------------------------------------------

class ShapeOnly:
    """Stands in for the init functions' ``torch.Generator`` on the meta
    device, where no generator can be made: draws from it are shapes and
    dtypes only (``init_model(device="meta")``)."""

    device = torch.device("meta")


def randn(gen, shape) -> torch.Tensor:
    """Standard normal draws from ``gen`` on its device."""
    return torch.randn(shape, generator=None if isinstance(gen, ShapeOnly) else gen,
                       device=gen.device)


def rand(gen, shape) -> torch.Tensor:
    """Uniform [0, 1) draws from ``gen`` on its device."""
    return torch.rand(shape, generator=None if isinstance(gen, ShapeOnly) else gen,
                      device=gen.device)


def dense_init(gen: torch.Generator, shape, in_axis_size: int,
               dtype=torch.float32) -> torch.Tensor:
    scale = 1.0 / math.sqrt(max(in_axis_size, 1))
    # scaled in place: a 15 GB expert weight needs no second 15 GB buffer
    return randn(gen, shape).mul_(scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    return (randn(gen, shape) * 0.02).to(dtype)


#: ``x @ w`` in the promoted dtype, on the card through the small-row
#: kernel where it fits (``ops.mm``)
_mm = ops.mm


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in the promoted dtype, as ``jnp.einsum`` promotes."""
    dt = ops[0].dtype
    for t in ops[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.einsum(eq, *(t.to(dt) for t in ops))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, lead=(), device=None) -> Params:
    return {"scale": torch.zeros(*lead, d, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * (1.0 + params["scale"])
    return y.to(dtype)


def init_layernorm(d: int, lead=(), device=None) -> Params:
    return {"scale": torch.zeros(*lead, d, device=device),
            "bias": torch.zeros(*lead, d, device=device)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * (1.0 + params["scale"]) + params["bias"]
    return y.to(dtype)


def norm_axes(kind: str) -> dict:
    """Logical sharding axes of a ``make_norm(kind)`` norm's params."""
    return {"scale": ("embed",), "bias": ("embed",)} if kind == "layernorm" \
        else {"scale": ("embed",)}


def make_norm(kind: str):
    """(init, apply) for ``cfg.norm``."""
    if kind == "rmsnorm":
        return init_rmsnorm, rmsnorm
    if kind == "layernorm":
        return init_layernorm, layernorm
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               freqs: torch.Tensor | None = None) -> torch.Tensor:
    """x: (..., T, H, D); positions: broadcastable to (..., T).  Split-half.
    ``freqs`` (D/2,) replaces ``rope_frequencies(D, theta)`` (YaRN's)."""
    if freqs is None:
        freqs = rope_frequencies(x.shape[-1], theta, x.device)      # (D/2,)
    angles = positions[..., None].float() * freqs                   # (..., T, D/2)
    angles = angles[..., None, :]                                   # (..., T, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# soft capping (gemma2)
# ---------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def blockwise_attention(
    q: torch.Tensor,             # (B, Tq, KVH, G, D)  — grouped query heads
    k: torch.Tensor,             # (B, Tk, KVH, D)
    v: torch.Tensor,             # (B, Tk, KVH, D)
    *,
    causal: bool = True,
    window: int | None = None,
    prefix_len: int | None = None,
    logit_cap: float | None = None,
    q_offset: int = 0,           # absolute position of q[0] (decode)
    k_valid_len: int | None = None,   # valid prefix of k/v (cache fill level)
    scale: float | None = None,  # logit scale; None: 1/sqrt(D)
) -> torch.Tensor:
    """Attention with the model zoo's mask menu; returns (B, Tq, KVH, G, D).

    The JAX package computes this with a jnp online-softmax scan; the port
    routes it to the flash-attention kernel (or its plain version on the
    CPU), which computes the same function.
    """
    return ops.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
        window=window, prefix_len=prefix_len, logit_cap=logit_cap, scale=scale,
        q_offset=q_offset, k_valid_len=k_valid_len)


def decode_attention(
    q: torch.Tensor,             # (B, 1, KVH, G, D)
    k: torch.Tensor,             # (B, S, KVH, D)   — cache
    v: torch.Tensor,
    *,
    q_position: int | torch.Tensor,   # absolute position of the query token
    window: int | None = None,
    logit_cap: float | None = None,
    k_positions: torch.Tensor | None = None,   # (S,) absolute positions
) -> torch.Tensor:
    """Single-token attention over a (possibly ring-buffered) KV cache.
    ``q_position`` may be a 0-dim integer tensor on the cache's device: the
    mask then reads it there."""
    B, _, KVH, G, D = q.shape
    S = k.shape[1]
    qf = (q[:, 0] * (1.0 / math.sqrt(D))).float()                                 # (B,KVH,G,D)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k.float())             # (B,KVH,G,S)
    s = softcap(s, logit_cap)
    k_pos = k_positions if k_positions is not None else torch.arange(S, device=k.device)
    mask = (k_pos >= 0) & (k_pos <= q_position)   # -1 marks empty cache slots
    if window is not None:
        mask = mask & (q_position - k_pos < window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return out[:, None].to(q.dtype)                                # (B,1,KVH,G,D)


# ---------------------------------------------------------------------------
# GQA attention layer (projections + cache handling)
# ---------------------------------------------------------------------------

def init_gqa(gen: torch.Generator, d_model: int, num_heads: int,
             num_kv_heads: int, head_dim: int, lead=(),
             dtype=torch.float32) -> Params:
    return {
        "wq": dense_init(gen, (*lead, d_model, num_heads, head_dim), d_model, dtype),
        "wk": dense_init(gen, (*lead, d_model, num_kv_heads, head_dim), d_model, dtype),
        "wv": dense_init(gen, (*lead, d_model, num_kv_heads, head_dim), d_model, dtype),
        "wo": dense_init(gen, (*lead, num_heads, head_dim, d_model),
                         num_heads * head_dim, dtype),
    }


#: logical sharding axes of ``init_gqa``'s params (the JAX package's)
GQA_AXES = {"wq": ("embed", "heads", None), "wk": ("embed", "kv_heads", None),
            "wv": ("embed", "kv_heads", None), "wo": ("heads", None, "embed")}


@dataclasses.dataclass
class KVCache:
    """Per-layer KV cache; ``size`` may be a sliding window (ring buffer).

    Unlike the JAX package's immutable cache, the port writes prefill and
    decode results into ``k``, ``v`` and ``positions`` in place (the engine
    never reads an old cache again).  ``index`` is a Python int for the
    host's bookkeeping; decode reads the position on the device instead, as
    one more than the largest of row 0's ``positions`` (the slot written
    last), so that a decode step replayed as a CUDA graph needs nothing from
    the host.
    """

    k: torch.Tensor              # (B, S, KVH, D)
    v: torch.Tensor
    positions: torch.Tensor      # (B, S) absolute position of each slot (-1 empty)
    index: int                   # next absolute position


def init_kv_cache(batch: int, size: int, num_kv_heads: int, head_dim: int,
                  dtype=torch.bfloat16, device=None, lead=()) -> KVCache:
    return KVCache(
        k=torch.zeros(*lead, batch, size, num_kv_heads, head_dim, dtype=dtype, device=device),
        v=torch.zeros(*lead, batch, size, num_kv_heads, head_dim, dtype=dtype, device=device),
        positions=torch.full((*lead, batch, size), -1, dtype=torch.int32, device=device),
        index=0,
    )


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("btd,dhk->bthk"), contiguous, in the promoted dtype."""
    d, H, D = w.shape
    return _mm(x, w.reshape(d, H * D)).reshape(*x.shape[:-1], H, D)


def gqa_attention(
    params: Params,
    x: torch.Tensor,             # (B, T, d)
    *,
    num_kv_heads: int,
    num_heads: int,
    head_dim: int,
    rope_theta: float = 10_000.0,
    use_rope: bool = True,
    causal: bool = True,
    window: int | None = None,
    prefix_len: int | None = None,
    logit_cap: float | None = None,
    cache: KVCache | None = None,
    mode: str = "prefill",       # train | prefill | decode
) -> tuple[torch.Tensor, KVCache | None]:
    """GQA attention with optional sliding window and prefix-LM mask (the
    first ``prefix_len`` positions attend to each other both ways).
    ``train`` attends over the full sequence and keeps no cache; prefill
    fills the KV cache and decode extends it (both in place)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got {mode!r}")
    B, T, d = x.shape
    G = num_heads // num_kv_heads
    q = _project(x, params["wq"])                        # (B,T,H,D)
    k = _project(x, params["wk"])                        # (B,T,KVH,D)
    v = _project(x, params["wv"])
    wo = params["wo"].reshape(num_heads * head_dim, d)

    if mode == "decode":
        if T != 1:
            raise ValueError(f"decode takes one token, got {T}")
        k_pos = cache.positions[0]                       # a view: sees the write below
        pos = k_pos.max() + 1                            # 0-dim, on the device
        if use_rope:
            p = pos.expand(B, 1)
            q = apply_rope(q, p, rope_theta)
            k = apply_rope(k, p, rope_theta)
        S = cache.k.shape[1]
        slot = (pos % S).long().view(1)                  # ring buffer
        cache.k[:, slot] = k.to(cache.k.dtype)           # index_put_, no host read
        cache.v[:, slot] = v.to(cache.v.dtype)
        cache.positions[:, slot] = pos.expand(B, 1)
        qg = q.reshape(B, 1, num_kv_heads, G, head_dim)
        out = decode_attention(
            qg, cache.k, cache.v, q_position=pos, window=window,
            logit_cap=logit_cap, k_positions=k_pos,
        )
        y = _mm(out.reshape(B, 1, num_heads * head_dim), wo)
        return y, KVCache(cache.k, cache.v, cache.positions, cache.index + 1)

    positions = torch.arange(T, device=x.device)[None, :]
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    qg = q.reshape(B, T, num_kv_heads, G, head_dim)
    out = blockwise_attention(qg, k, v, causal=causal, window=window,
                              prefix_len=prefix_len, logit_cap=logit_cap)
    y = _mm(out.reshape(B, T, num_heads * head_dim), wo)
    if mode == "train":
        return y, None

    # Build the cache from the tail of the sequence (window caches keep only
    # the last ``size`` positions).  Ring-buffer layout invariant: token p
    # lives at slot p % size, so the tail is rolled to align with decode's
    # slot indexing.
    size = min(cache.k.shape[1], max(T, 1))
    shift = T % size
    tail_k = torch.roll(k[:, T - size:], shift, dims=1)
    tail_v = torch.roll(v[:, T - size:], shift, dims=1)
    tail_pos = torch.roll(positions[:, T - size:].expand(B, size), shift,
                          dims=1).to(torch.int32)
    if cache.k.shape[1] > size:
        cache.k.zero_()
        cache.v.zero_()
        cache.positions.fill_(-1)
    cache.k[:, :size] = tail_k.to(cache.k.dtype)
    cache.v[:, :size] = tail_v.to(cache.v.dtype)
    cache.positions[:, :size] = tail_pos
    return y, KVCache(cache.k, cache.v, cache.positions, T)


# ---------------------------------------------------------------------------
# Gated MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, activation: str,
             lead=(), dtype=torch.float32) -> Params:
    if activation in ("swiglu", "geglu"):
        return {
            "wg": dense_init(gen, (*lead, d_model, d_ff), d_model, dtype),
            "wu": dense_init(gen, (*lead, d_model, d_ff), d_model, dtype),
            "wd": dense_init(gen, (*lead, d_ff, d_model), d_ff, dtype),
        }
    return {
        "wu": dense_init(gen, (*lead, d_model, d_ff), d_model, dtype),
        "wd": dense_init(gen, (*lead, d_ff, d_model), d_ff, dtype),
    }


def mlp_axes(activation: str) -> dict:
    """Logical sharding axes of ``init_mlp``'s params."""
    axes = {"wu": ("embed", "mlp"), "wd": ("mlp", "embed")}
    return {"wg": ("embed", "mlp"), **axes} if activation in ("swiglu", "geglu") else axes


def mlp(params: Params, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "swiglu":
        h = F.silu(_mm(x, params["wg"])) * _mm(x, params["wu"])
    elif activation == "geglu":
        h = F.gelu(_mm(x, params["wg"]), approximate="tanh") * _mm(x, params["wu"])
    elif activation == "gelu":
        h = F.gelu(_mm(x, params["wu"]), approximate="tanh")
    else:
        raise ValueError(activation)
    return _mm(h, params["wd"])


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d_model: int, tie: bool,
                   dtype=torch.float32) -> Params:
    params = {"embedding": embed_init(gen, (vocab, d_model), dtype)}
    if not tie:
        params["unembed"] = dense_init(gen, (d_model, vocab), d_model, dtype)
    return params


def embedding_axes(tie: bool) -> dict:
    """Logical sharding axes of ``init_embedding``'s params."""
    axes = {"embedding": ("vocab", "embed")}
    return axes if tie else {**axes, "unembed": ("embed", "vocab")}


def embed(params: Params, tokens: torch.Tensor, scale_by_dim: bool = False) -> torch.Tensor:
    x = params["embedding"][tokens]
    if scale_by_dim:
        x = x * math.sqrt(params["embedding"].shape[-1])
    return x


def unembed(params: Params, x: torch.Tensor, logit_cap: float | None = None) -> torch.Tensor:
    if "unembed" in params:
        logits = _mm(x, params["unembed"])
    else:
        logits = _mm(x, params["embedding"].T)
    return softcap(logits.float(), logit_cap)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Token-level CE with optional z-loss; logits (..., V), labels (...)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse.square()
    if mask is not None:
        loss = loss * mask
        return loss.sum() / torch.clamp(mask.sum(), min=1.0)
    return loss.mean()
