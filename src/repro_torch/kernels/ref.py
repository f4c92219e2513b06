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
    p, _ = _probabilities(q, k, causal=causal, window=window, prefix_len=prefix_len,
                          logit_cap=logit_cap, scale=scale, q_offset=q_offset,
                          k_valid_len=k_valid_len)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.to(q.dtype)


def _probabilities(q, k, *, causal=True, window=None, prefix_len=None, logit_cap=None,
                   scale=None, q_offset=0, k_valid_len=None):
    """(softmax probabilities (B, KVH, G, Tq, Tk), zeros where masked and in
    a row that sees no key; the row log-sum-exp (B, KVH, G, Tq, 1), -inf
    for such a row), in float32."""
    Tq, D = q.shape[1], q.shape[-1]
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
    lse = torch.where(l > 0, m + torch.log(l), -math.inf)
    return p / torch.clamp(l, min=1e-30), lse


def reference_attention_lse(q, k, **kw) -> torch.Tensor:
    """The row log-sum-exp of the scores that :func:`reference_attention`
    softmaxes, (B, Tq, KVH, G) float32, -inf for a row that sees no key:
    what the flash forward writes for its backward."""
    _, lse = _probabilities(q, k, **kw)
    return lse[..., 0].permute(0, 3, 1, 2).contiguous()


def reference_attention_bwd(q, k, v, dout, *, causal: bool = True,
                            window: int | None = None, prefix_len: int | None = None,
                            logit_cap: float | None = None, scale: float | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the flash backward: (dq, dk, dv) of
    :func:`reference_attention` for the output gradient ``dout``, in
    float32 and returned in q's dtype.  With P the probabilities and O the
    output: dV = P^T dO, dP = dO V^T, dS = P (dP - rowsum(dO O)), through
    the softcap's tanh, then dQ = dS K scale and dK = dS^T Q scale."""
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kw = dict(causal=causal, window=window, prefix_len=prefix_len, logit_cap=logit_cap,
              scale=scale, q_offset=0, k_valid_len=None)
    p, _ = _probabilities(q, k, **kw)
    do = dout.float()
    vf, kf, qf = v.float(), k.float(), q.float()
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do, vf)
    delta = torch.einsum("bqhgd,bqhgd->bhgq", do, out)[..., None]
    ds = p * (dp - delta)
    if logit_cap is not None:
        raw = torch.einsum("bqhgd,bkhd->bhgqk", qf * scale, kf)
        ds = ds * (1.0 - torch.tanh(raw / logit_cap).square())
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def reference_small_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of the small-row product: x (G, M, K) float32 or
    bfloat16, w (G, K, N) float32 -> ``x[g] @ w[g]`` (G, M, N) float32, x
    widened first (exact), as ``torch.bmm`` computes it."""
    return torch.bmm(x.to(torch.float32), w)


def reference_mla_decode(q_abs: torch.Tensor, q_pe: torch.Tensor, c_kv: torch.Tensor,
                         k_pe: torch.Tensor, pos, scale: float) -> torch.Tensor:
    """Plain version of MLA decode's absorbed attention core, as
    ``models/mla.py`` computes it over the whole cache: q_abs (B, 1, H, R),
    q_pe (B, 1, H, rope), c_kv (B, S, R), k_pe (B, S, rope); the slots
    ``s <= pos`` are live (``pos`` an int or a tensor) -> ctx (B, 1, H, R)
    in c_kv's dtype (the probabilities rounded to it)."""
    S = c_kv.shape[1]
    s_nope = torch.einsum("bthr,bsr->bhts", q_abs, c_kv.to(q_abs.dtype))
    s_pe = torch.einsum("bthk,bsk->bhts", q_pe, k_pe.to(q_pe.dtype))
    s = (s_nope + s_pe).float() * scale                    # (B,H,1,S)
    valid = torch.arange(S, device=q_abs.device) <= pos    # ring validity
    s = torch.where(valid, s, NEG_INF)
    prob = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bsr->bthr", prob.to(c_kv.dtype), c_kv)


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


def reference_lru_scan_bwd(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor,
                           gh: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the RG-LRU scan's backward, the reverse recurrence
    the ``lru_scan_bwd`` kernel runs: from the forward's ``a``, its output
    ``h``, ``h0`` and the gradient ``gh`` of ``h``, with ``h_{-1} = h0``,

        dh_{T-1} = gh_{T-1},   dh_t = gh_t + a_{t+1} dh_{t+1},
        gx_t = dh_t,   ga_t = dh_t h_{t-1},   gh0 = a_0 dh_0,

    the forward recurrence run backwards in time with ``a`` shifted by one
    step.  a, h, gh: (B, T, W), T >= 1; h0: (B, W).  Returns (gx, ga, gh0),
    float32.  Tests hold it to autograd and ``jax.grad``; the card's path
    runs the kernel.
    """
    af, hf, ghf = a.float(), h.float(), gh.float()
    T = a.shape[1]
    gx, ga = torch.empty_like(ghf), torch.empty_like(ghf)
    dh = torch.zeros_like(h0, dtype=torch.float32)
    for t in range(T - 1, -1, -1):
        dh = ghf[:, t] + (af[:, t + 1] * dh if t + 1 < T else 0.0)
        gx[:, t] = dh
        ga[:, t] = dh * (hf[:, t - 1] if t > 0 else h0.float())
    return gx, ga, af[:, 0] * dh


def reference_wkv_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                      gy: torch.Tensor, gs_t: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, ...]:
    """Plain version of the WKV recurrence's backward, the reverse walk the
    ``wkv_scan_bwd`` kernel runs.  With ``S_{t-1}`` the state before step t
    (``S_{-1} = s0``) and ``dS`` the adjoint of the state after it (``gs_t``
    at the end, zeros if None), from t = T - 1 down to 0:

        c_t = v_t . gy_t
        gr_t = S_{t-1} gy_t + u * k_t c_t
        gu += r_t * k_t c_t
        gk_t = dS v_t + r_t * u c_t
        gv_t = dS^T k_t + (sum_i r_t[i] u_i k_t[i]) gy_t
        gw_t = rowsum(dS * S_{t-1})
        dS <- diag(w_t) dS + r_t^T gy_t

    and ``gs0 = dS`` at the end.  The states are recomputed forward from
    ``s0`` (the kernel replays them from per-chunk checkpoints); none is
    recovered by dividing by w, which underflows at the model's decays.
    Shapes as ``reference_wkv``, gy (B, T, H, V).  Returns (gr, gk, gv, gw,
    gu, gs0), float32.
    """
    rf, kf, vf, wf, gyf = (t.float() for t in (r, k, v, w, gy))
    uf = u.float()
    T = r.shape[1]
    states = [s0.float()]
    for t in range(T - 1):
        states.append(wf[:, t, :, :, None] * states[-1]
                      + kf[:, t, :, :, None] * vf[:, t, :, None, :])
    ds = torch.zeros_like(states[0]) if gs_t is None else gs_t.float().clone()
    grads = [torch.empty_like(x) for x in (rf, kf, vf, wf)]
    gr, gk, gv, gw = grads
    gu = torch.zeros_like(rf[:, 0])                                  # (B, H, K)
    for t in range(T - 1, -1, -1):
        rt, kt, vt, wt, gyt, sp = rf[:, t], kf[:, t], vf[:, t], wf[:, t], gyf[:, t], states[t]
        c = (vt * gyt).sum(-1, keepdim=True)                         # (B, H, 1)
        gr[:, t] = torch.einsum("bhkv,bhv->bhk", sp, gyt) + uf * kt * c
        gu += rt * kt * c
        gk[:, t] = torch.einsum("bhkv,bhv->bhk", ds, vt) + rt * uf * c
        gv[:, t] = (torch.einsum("bhkv,bhk->bhv", ds, kt)
                    + (rt * uf * kt).sum(-1, keepdim=True) * gyt)
        gw[:, t] = (ds * sp).sum(-1)
        ds = wt[..., None] * ds + rt[..., None] * gyt[..., None, :]
    return gr, gk, gv, gw, gu.sum(0), ds
