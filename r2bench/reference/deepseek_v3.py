"""DeepSeek-V3 in plain PyTorch, one chip's share of its expert layers: the
forward pass that the serving cell's check holds the program to, in the
parameter layout of ``drivers/serve_deepseek_v3.make_weights``.

The equations, as DeepSeek-V3's ``config.json`` and arXiv:2412.19437 state
them (``c`` is ``configs/deepseek-v3-10l-ep32.json``):

- Embedding, then ``num_hidden_layers`` layers, a final RMSNorm and the
  untied head.  Each layer: ``x += MLA(norm1(x))``, ``x += FFN(norm2(x))``;
  the first ``first_k_dense_replace`` FFNs are dense SwiGLU of width
  ``intermediate_size``, the rest MoE.
- MLA: ``c_q = RMSNorm(x W_dq)`` (1536), ``q = c_q W_uq`` (128 heads of 128
  nope + 64 rope); ``c_kv = RMSNorm(x W_dkv)`` (512), ``k_pe = x W_kpe``
  (64, one for all heads); ``k_nope = c_kv W_uk``, ``v = c_kv W_uv``; rope
  on ``q_pe`` and ``k_pe`` at positions 0.. with YaRN's frequencies
  (``rope_scaling``: factor 40, original 4096, beta_fast 32, beta_slow 1)
  times ``mscale / mscale_all_dim`` terms (1 here); causal softmax of
  ``[q_nope, q_pe] . [k_nope, k_pe] * scale``, ``scale = 192 ** -0.5 *
  (0.1 * mscale_all_dim * ln(factor) + 1) ** 2``; ``out W_o``.
- MoE (``scoring_func`` sigmoid, ``topk_method`` noaux_tc): ``s =
  sigmoid(x W_r)`` over all ``n_routed_experts_published`` experts;
  selection on ``s + b`` (``e_score_correction_bias``): a group's score is
  the sum of its two best, the ``topk_group`` best of ``n_group`` groups
  stay, the ``num_experts_per_tok`` best experts among them are chosen;
  weights ``s`` of the chosen over their sum (``norm_topk_prob``) times
  ``routed_scaling_factor``.  The output is the held experts' weighted
  SwiGLU outputs (experts ``first_held_expert`` .. + ``n_routed_experts``)
  plus the shared expert's, unweighted.

Precision, as the configuration states it: float32 weights and products
(TF32 off), the router in float32, the residual stream (the embedding, the
layer norms' outputs and each sum into it) rounded to bfloat16, the latent
norms and attention's softmax in float32, logits in float32.  ``llama.Precision``
lowers the products or the residual for the check's controls.

Departures from the published model, each the program's too:

- One chip's share of expert parallelism over 32 chips: only the held
  experts' part of the routed sum is computed, the part the other chips'
  experts would add is left out (no exchange), as the program's layer
  does.  The router, its bias and the selection stay at full width.
- ``num_hidden_layers`` 10 of 61 (a pipeline's first stage), no MTP module.
- Rope in split halves (the port's layout); the published checkpoints'
  interleaved pairs are the same rotation under a permutation of
  ``W_kpe``'s and ``W_uq``'s rope columns.  A norm multiplies by ``1 +
  scale`` (the port's layout), where HF's ``weight`` is the whole factor.
- Masked groups score ``-inf`` (DeepSeek's own ``inference/model.py``; HF's
  ``modeling_deepseek.py`` fills 0.0): it matters only where fewer than
  ``num_experts_per_tok`` kept experts score above 0.
- Random weights from the seed, not the FP8 checkpoint.

``pins``: each MoE layer's chosen experts given (``(N, k)`` expert ids, one
a layer in order), as the program chose them; the layer then weights those
experts by its own scores, and still records the choice it would have made
itself (``routes``), so that routing and everything downstream of it can be
held to the program apart.  Attention runs in blocks of ``block`` queries.
"""

from __future__ import annotations

import math

import torch

from .llama import Precision, add, mm, rmsnorm, to_residual


def norm32(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in float32, not rounded (the latents')."""
    xf = x.float()
    return xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * (1.0 + scale)


def yarn_get_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(dim: int, base: float, rs: dict, device=None) -> torch.Tensor:
    """``DeepseekV3YarnRotaryEmbedding``'s inverse frequencies."""
    factor, n = rs["factor"], rs["original_max_position_embeddings"]

    def corr(rot):
        return dim * math.log(n / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ar = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / (base ** ar)
    freq_inter = 1.0 / (factor * base ** ar)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
                       / (high - low), 0, 1)
    mask = 1.0 - ramp
    return freq_inter * (1 - mask) + freq_extra * mask


def rope(x: torch.Tensor, c: dict) -> torch.Tensor:
    """x (B, T, H, 64) at positions 0..T-1: the halves rotated at YaRN's
    frequencies, times the rotary mscale."""
    rs = c["rope_scaling"]
    T, D = x.shape[1], x.shape[-1]
    inv = yarn_inv_freq(D, c["rope_theta"], rs, x.device)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    m = (yarn_get_mscale(rs["factor"], rs["mscale"])
         / yarn_get_mscale(rs["factor"], rs["mscale_all_dim"]))
    cos, sin = (torch.cos(ang) * m)[None, :, None], (torch.sin(ang) * m)[None, :, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def softmax_scale(c: dict) -> float:
    rs = c["rope_scaling"]
    scale = (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5
    if rs.get("mscale_all_dim"):
        scale *= yarn_get_mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return scale


def mla(a: dict, x: torch.Tensor, c: dict, p: Precision, block: int = 512) -> torch.Tensor:
    """Multi-head latent attention over x (B, T, d), causal."""
    B, T, d = x.shape
    H, nope, rdim, vd = (c["num_attention_heads"], c["qk_nope_head_dim"],
                         c["qk_rope_head_dim"], c["v_head_dim"])
    R, eps = c["kv_lora_rank"], c["rms_norm_eps"]
    cq = norm32(mm(x, a["w_dq"], p), a["q_norm"], eps)
    q = mm(cq, a["w_uq"].reshape(c["q_lora_rank"], H * (nope + rdim)), p).view(B, T, H, -1)
    ckv = norm32(mm(x, a["w_dkv"], p), a["kv_norm"], eps)
    k_pe = rope(mm(x, a["w_kpe"], p)[:, :, None, :], c)                  # (B, T, 1, rope)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], c)], dim=-1)
    k_nope = mm(ckv, a["w_uk"].reshape(R, H * nope), p).view(B, T, H, nope)
    v = mm(ckv, a["w_uv"].reshape(R, H * vd), p).view(B, T, H, vd)
    k = torch.cat([k_nope, k_pe.expand(B, T, H, rdim)], dim=-1)
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))              # (B, H, T, .)
    scale = softmax_scale(c)
    out = torch.empty(B, H, T, vd, dtype=torch.float32, device=x.device)
    for i0 in range(0, T, block):
        i1 = min(i0 + block, T)
        s = mm(qh[:, :, i0:i1], kh[:, :, :i1].transpose(-1, -2), p) * scale
        causal = (torch.arange(i1, device=x.device)[None, :]
                  <= torch.arange(i0, i1, device=x.device)[:, None])
        s = s.masked_fill(~causal, float("-inf"))
        out[:, :, i0:i1] = mm(torch.softmax(s, dim=-1), vh[:, :, :i1], p)
    o = out.permute(0, 2, 1, 3).reshape(B, T, H * vd)
    return mm(o, a["w_o"].reshape(H * vd, d), p)


def swiglu(x, wg, wu, wd, p: Precision) -> torch.Tensor:
    return mm(torch.nn.functional.silu(mm(x, wg, p)) * mm(x, wu, p), wd, p)


def route(m: dict, xt: torch.Tensor, c: dict, p: Precision) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, top_i): the sigmoid scores over all experts and the published
    group-limited choice on the biased scores."""
    s = torch.sigmoid(mm(xt, m["router"], p))                            # (N, E)
    N, E = s.shape
    G = c["n_group"]
    biased = (s + m["router_bias"]).view(N, G, E // G)
    group_scores = biased.topk(2, dim=-1)[0].sum(dim=-1)
    keep = group_scores.topk(c["topk_group"], dim=-1)[1]
    drop = torch.ones(N, G, dtype=torch.bool, device=xt.device).scatter_(1, keep, False)
    biased = biased.masked_fill(drop[..., None], float("-inf")).flatten(1)
    return s, biased.topk(c["num_experts_per_tok"], dim=-1)[1]


def moe(m: dict, x: torch.Tensor, c: dict, p: Precision, pin=None, routes=None) -> torch.Tensor:
    """The held experts' part of the routed sum plus the shared expert, over
    x (B, T, d); ``pin`` (N, k) replaces the choice, ``routes`` collects the
    layer's own."""
    B, T, d = x.shape
    xt = x.reshape(B * T, d)
    s, top_i = route(m, xt, c, p)
    if routes is not None:
        routes.append(top_i)
    if pin is not None:
        top_i = pin.to(top_i.device)
    w = s.gather(1, top_i)
    w = w / w.sum(-1, keepdim=True) * c["routed_scaling_factor"]
    y = torch.zeros(B * T, d, dtype=torch.float32, device=x.device)
    first = c["first_held_expert"]
    for j in range(c["n_routed_experts"]):
        wj = (w * (top_i == first + j)).sum(-1)                          # (N,)
        rows = wj.nonzero()[:, 0]
        if rows.numel():
            y[rows] += wj[rows, None] * swiglu(xt[rows], m["wg"][j], m["wu"][j], m["wd"][j], p)
    y = y + swiglu(xt, m["shared_wg"], m["shared_wu"], m["shared_wd"], p)
    return y.view(B, T, d)


def layers(params: dict):
    """Each layer's params in order: the dense ``lead`` ones, then the
    stacked MoE ``blocks`` sliced."""
    yield from params["lead"]
    stacked = params["blocks"][0]
    for g in range(stacked["norm1"]["scale"].shape[0]):
        yield {k: {n: t[g] for n, t in sub.items()} for k, sub in stacked.items()}


def hidden(params: dict, c: dict, tokens: torch.Tensor, p: Precision, pins=None,
           routes=None) -> torch.Tensor:
    """The final norm's output at every position, (B, T, d)."""
    x = to_residual(params["embed"]["embedding"][tokens], p)
    eps = c["rms_norm_eps"]
    pins = iter(pins) if pins is not None else None
    for lp in layers(params):
        x = add(x, mla(lp["attn"], rmsnorm(x, lp["norm1"]["scale"], eps, p), c, p), p)
        h = rmsnorm(x, lp["norm2"]["scale"], eps, p)
        if "mlp" in lp:
            y = swiglu(h, lp["mlp"]["wg"], lp["mlp"]["wu"], lp["mlp"]["wd"], p)
        else:
            y = moe(lp["moe"], h, c, p, None if pins is None else next(pins), routes)
        x = add(x, y, p)
    return rmsnorm(x, params["final_norm"]["scale"], eps, p)


def logits(params: dict, xn: torch.Tensor, p: Precision) -> torch.Tensor:
    return mm(xn, params["embed"]["unembed"], p)
