"""Plain PyTorch versions of the port's kernels (the CPU path and the
on-card yardstick each kernel is checked against)."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
                   window: int | None, prefix_len: int | None,
                   k_valid_len: int | None, k_len: int) -> torch.Tensor:
    """(Tq, Tk) boolean mask from absolute positions; the mask menu of the
    JAX package's ``layers._block_mask`` plus the true key length."""
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    m = kp < k_len
    if causal:
        c = kp <= qp
        if prefix_len is not None:
            c = c | (kp < prefix_len)     # prefix-LM: bidirectional prefix
        m = m & c
    if window is not None:
        m = m & (qp - kp < window)
    if k_valid_len is not None:
        m = m & (kp < k_valid_len)
    return m


def reference_attention(
    q: torch.Tensor,                 # (B, Tq, KVH, G, D)
    k: torch.Tensor,                 # (B, Tk, KVH, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    prefix_len: int | None = None,
    logit_cap: float | None = None,
    scale: float | None = None,
    q_offset: int = 0,
    k_valid_len: int | None = None,
) -> torch.Tensor:
    """Full-matrix masked softmax attention in float32, the plain version of
    the flash-attention kernel.

    Mirrors the JAX package's ``ref.reference_attention`` with the
    ``q_offset`` / ``k_valid_len`` of its ``layers.blockwise_attention``, and
    the online-softmax guards of its kernel: a query row that sees no key
    gives zeros (``acc / max(l, 1e-30)``), not a uniform average.
    """
    B, Tq, KVH, G, D = q.shape
    Tk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float() * scale, k.float())
    if logit_cap is not None:
        s = torch.tanh(s / logit_cap) * logit_cap
    q_pos = q_offset + torch.arange(Tq, device=q.device)
    k_pos = torch.arange(Tk, device=q.device)
    mask = attention_mask(q_pos, k_pos, causal=causal, window=window,
                          prefix_len=prefix_len, k_valid_len=k_valid_len,
                          k_len=Tk)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p / torch.clamp(l, min=1e-30),
                       v.float())
    return out.to(q.dtype)


def reference_chunk_combine(local: torch.Tensor, recv: torch.Tensor,
                            seg_mask, accumulate) -> torch.Tensor:
    """Plain version of the R2CCL stage-2 combine: per-row select/accumulate.

    local/recv: (C, M); seg_mask, accumulate: (C,) bool or int.
    out[c] = local[c]                 if not seg_mask[c]
           = local[c] + recv[c]       if seg_mask[c] and accumulate[c]
           = recv[c]                  if seg_mask[c] and not accumulate[c]
    computed in float32 and returned in local's dtype, as the JAX package's
    ``ref.reference_chunk_combine``.
    """
    seg = torch.as_tensor(seg_mask, device=local.device).bool()[:, None]
    acc = torch.as_tensor(accumulate, device=local.device).bool()[:, None]
    lf, rf = local.float(), recv.float()
    comb = torch.where(acc, lf + rf, rf)
    return torch.where(seg, comb, lf).to(local.dtype)
