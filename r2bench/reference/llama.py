"""A llama-architecture decoder in plain PyTorch: token embedding, layers of
grouped-query attention with rotary positions (split halves, ``theta``) and a
SwiGLU MLP, each behind an RMSNorm, a final RMSNorm and the head (tied to the
embedding or not), in the parameter layout of ``weights.make_weights``.

Precision, as a configuration states it (``configs/<name>.json``'s
``precision``): float32 weights and products, the residual stream (the
embedding, the norms' outputs and every sum into it) rounded to
``residual``, attention's softmax in float32, logits in float32.  TF32 is
off.  The lower precisions that the check's controls put in the
program's place: ``products="tf32"`` rounds both operands of every product
to TF32 (10 bits of mantissa, round to nearest) and accumulates in float32,
as the tensor cores do, the same on the CPU and the card;
``products="bfloat16"`` rounds them to bfloat16 and accumulates in float32;
``residual="float8_e4m3fn"`` rounds the residual stream to float8 e4m3
under a scale a row (its largest magnitude at 448), kept in float32.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    products: str = "float32"          # "float32" | "tf32" | "bfloat16"
    residual: str = "bfloat16"         # "bfloat16" | "float32" | "float8_e4m3fn"


def to_residual(x: torch.Tensor, p: Precision) -> torch.Tensor:
    """``x`` rounded to the residual stream's precision."""
    if p.residual == "float8_e4m3fn":
        xf = x.float()
        scale = xf.abs().amax(-1, keepdim=True).clamp(min=1e-30) / 448.0
        q = (xf / scale).to(torch.float8_e4m3fn).float() * scale
        return xf + (q - xf).detach()
    return x.to(getattr(torch, p.residual))


def add(x: torch.Tensor, y: torch.Tensor, p: Precision) -> torch.Tensor:
    """A sum into the residual stream: ``y`` rounded, added in float32, the
    sum rounded (a bfloat16 addition)."""
    return to_residual(x.float() + to_residual(y, p).float(), p)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties away) at TF32's 10 mantissa bits."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to bfloat16 (to nearest even), kept in float32."""
    return x.to(torch.bfloat16).float()


ROUNDING = {"tf32": to_tf32, "bfloat16": to_bf16}


class _RoundedProduct(torch.autograd.Function):
    """``a @ b`` with both operands rounded (``ROUNDING[kind]``), in the
    backward's two products too; ``b`` is (K, N) or has ``a``'s batch
    dimensions."""

    @staticmethod
    def forward(ctx, a, b, kind):
        ctx.save_for_backward(a, b)
        ctx.rnd = ROUNDING[kind]
        return ctx.rnd(a) @ ctx.rnd(b)

    @staticmethod
    def backward(ctx, g):
        a, b = (ctx.rnd(t) for t in ctx.saved_tensors)
        g = ctx.rnd(g)
        ga = g @ b.transpose(-1, -2)
        if b.dim() == 2:
            gb = a.reshape(-1, a.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        else:
            gb = a.transpose(-1, -2) @ g
        return ga, gb, None


def mm(a: torch.Tensor, b: torch.Tensor, p: Precision) -> torch.Tensor:
    a, b = a.float(), b.float()
    if p.products in ROUNDING:
        return _RoundedProduct.apply(a, b, p.products)
    return a @ b


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float, p: Precision) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * (1.0 + scale)
    return to_residual(y, p)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, H, D) at positions 0..T-1, the halves of D rotated."""
    T, D = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, p: Precision) -> torch.Tensor:
    """Causal attention, q (B, T, H, D), k = v (B, T, KVH, D); query head h
    reads key head h // (H // KVH)."""
    B, T, H, D = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))          # (B, H, T, D)
    s = mm(qh, kh.transpose(-1, -2), p) / math.sqrt(D)
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    return mm(torch.softmax(s, dim=-1), vh, p).permute(0, 2, 1, 3)   # (B, T, H, D)


def layer(lp: dict, x: torch.Tensor, c: dict, p: Precision) -> torch.Tensor:
    B, T, d = x.shape
    H, KVH, D = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    eps = c["rms_norm_eps"]
    h = rmsnorm(x, lp["norm1"]["scale"], eps, p)
    a = lp["attn"]
    q = mm(h, a["wq"].reshape(d, H * D), p).view(B, T, H, D)
    k = mm(h, a["wk"].reshape(d, KVH * D), p).view(B, T, KVH, D)
    v = mm(h, a["wv"].reshape(d, KVH * D), p).view(B, T, KVH, D)
    o = attention(rope(q, c["rope_theta"]), rope(k, c["rope_theta"]), v, p)
    x = add(x, mm(o.reshape(B, T, H * D), a["wo"].reshape(H * D, d), p), p)
    h = rmsnorm(x, lp["norm2"]["scale"], eps, p)
    m = lp["mlp"]
    y = mm(torch.nn.functional.silu(mm(h, m["wg"], p)) * mm(h, m["wu"], p), m["wd"], p)
    return add(x, y, p)


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked ``blocks``."""
    return {k: {n: t[i] for n, t in sub.items()} for k, sub in params["blocks"][0].items()}


def hidden(params: dict, c: dict, tokens: torch.Tensor, p: Precision) -> torch.Tensor:
    """The final norm's output at every position, (B, T, d)."""
    x = to_residual(params["embed"]["embedding"][tokens], p)
    for i in range(c["num_hidden_layers"]):
        x = layer(layer_params(params, i), x, c, p)
    return rmsnorm(x, params["final_norm"]["scale"], c["rms_norm_eps"], p)


def logits(params: dict, c: dict, xn: torch.Tensor, p: Precision) -> torch.Tensor:
    e = params["embed"]
    w = e["unembed"] if "unembed" in e else e["embedding"].T
    return mm(xn, w, p)


def loss(params: dict, c: dict, tokens: torch.Tensor, labels: torch.Tensor,
         p: Precision) -> torch.Tensor:
    """Mean next-token cross-entropy over every position, in float32."""
    lg = logits(params, c, hidden(params, c, tokens, p), p)
    return (torch.logsumexp(lg, -1) - lg.gather(-1, labels[..., None])[..., 0]).mean()
