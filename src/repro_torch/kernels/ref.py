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


def reference_lru_scan(a: torch.Tensor, x: torch.Tensor,
                       h0: torch.Tensor) -> torch.Tensor:
    """Plain version of the RG-LRU scan: ``h_t = a_t * h_{t-1} + x_t`` from
    ``h0``, sequential in time, in float32.

    a, x: (B, T, W); h0: (B, W).  Returns (B, T, W) float32, as the JAX
    package's ``ref.reference_lru_scan`` (which fixes ``h0``'s role the same
    way: the Pallas kernel itself starts from zero).
    """
    af, xf = a.float(), x.float()
    h = h0.float()
    hs = []
    for t in range(a.shape[1]):
        h = af[:, t] * h + xf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1) if hs else xf.clone()


def reference_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  s0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the RWKV-6 WKV recurrence in the model's layout.

    r, k, w: (B, T, H, K); v: (B, T, H, V); u: (H, K); s0: (B, H, K, V).
    ``out_t = r_t @ (S_{t-1} + u * k_t^T v_t)``, ``S_t = w_t * S_{t-1} +
    k_t^T v_t``.  Returns (out (B, T, H, V), s_T (B, H, K, V)), both float32,
    as the JAX package's ``models/rwkv6.py::wkv_scan_ref``.
    """
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]                       # (1, H, K, 1)
    s = s0.float()
    outs = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]   # (B, H, K, V)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], s + uf * kv))
        s = wf[:, t, :, :, None] * s + kv
    out = torch.stack(outs, dim=1) if outs else vf.new_zeros(vf.shape)
    return out, s
