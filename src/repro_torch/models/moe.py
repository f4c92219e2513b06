"""Mixture-of-Experts feed-forward (DBRX 16e/top-4; DeepSeek-V3 256e/top-8+shared).

The port of the JAX package's ``models/moe.py``, with its param names and
shapes (``router`` ``(d, E)``; ``wg``, ``wu`` ``(E, d, ff)``; ``wd``
``(E, ff, d)``; ``shared_*`` for shared experts).  Tokens are routed with
``top_k`` in float32, each (token, choice) slot is ranked within its expert
by a cumulative count in (token, choice) order, slots beyond the expert
capacity are dropped (contributing zero, Switch-style), and the expert FFNs
run as one batched product over the ``(E, C, d)`` dispatch buffer.  The
three dispatch layouts of the reference allocate capacity differently, so
they drop different tokens once capacity binds:

  * ``dispatch="einsum"``, ``per_example_dispatch=True`` (the default, the
    transformer's): one-hot dispatch and combine tensors per group of
    ``dispatch_group`` tokens of a batch row;
  * ``dispatch="scatter"``, ``per_example_dispatch=True``: a scatter into
    a buffer per batch row;
  * ``per_example_dispatch=False``: one scatter over the flattened batch.

The expert products are one ``torch.bmm`` over the experts, on the
``(E, d, ff)`` weights as stored (the reference computes them as an einsum,
outside any Pallas kernel).  Expert parallelism (``expert_sharding``, a mesh
axis name) constrains the two scatter paths' ``(R, E, C, d)`` buffers to be
sharded on the expert dim over that axis (``core.sharding.constrain``: the
identity on plain tensors, a redistribute on DTensors), where the reference
puts ``with_sharding_constraint``; the einsum path ignores it, as the
reference's does (constraining its buffers there forces the ``(B, T, E, C)``
mask to materialise).

The router aux loss is the usual load-balance term (mean fraction * mean
probability per expert, over each token's first choice), returned so the
train step can add it.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.sharding import constrain, rows_local

from .layers import _einsum, _mm, dense_init


def init_moe(gen: torch.Generator, d_model: int, expert_d_ff: int,
             num_experts: int, num_shared: int, activation: str, lead=(),
             dtype=torch.float32) -> dict:
    """Expert params with the JAX package's distributions, drawn from
    ``gen``; ``lead`` prefixes every shape (the stacked ``n_groups`` axis)."""
    gates = activation in ("swiglu", "geglu")
    E, d, ff = num_experts, d_model, expert_d_ff
    params: dict[str, Any] = {
        "router": dense_init(gen, (*lead, d, E), d, torch.float32),
        "wu": dense_init(gen, (*lead, E, d, ff), d, dtype),
        "wd": dense_init(gen, (*lead, E, ff, d), ff, dtype),
    }
    if gates:
        params["wg"] = dense_init(gen, (*lead, E, d, ff), d, dtype)
    if num_shared:
        params["shared_wu"] = dense_init(gen, (*lead, d, num_shared * ff), d, dtype)
        params["shared_wd"] = dense_init(gen, (*lead, num_shared * ff, d), ff, dtype)
        if gates:
            params["shared_wg"] = dense_init(gen, (*lead, d, num_shared * ff), d, dtype)
    return params


def moe_axes(num_shared: int, activation: str) -> dict:
    """Logical sharding axes of ``init_moe``'s params: the experts' own
    ``expert_embed`` and ``expert_mlp`` (the JAX package keeps FSDP off
    the expert weights' embed dim, which its dispatch einsum contracts)."""
    expert = ("experts", "expert_embed", "expert_mlp")
    axes = {"router": ("embed", "experts"), "wu": expert,
            "wd": ("experts", "expert_mlp", "expert_embed")}
    gates = activation in ("swiglu", "geglu")
    if gates:
        axes["wg"] = expert
    if num_shared:
        axes.update(shared_wu=("embed", "mlp"), shared_wd=("mlp", "embed"))
        if gates:
            axes["shared_wg"] = ("embed", "mlp")
    return axes


def _gelu(a: torch.Tensor) -> torch.Tensor:
    return F.gelu(a, approximate="tanh")


def _expert_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...ecd,edf->...ecf")`` in the promoted dtype, as one
    ``bmm`` over the experts: the (E, d, f) weights are read in place,
    never permuted or copied."""
    dt = torch.promote_types(x.dtype, w.dtype)
    E, C, d = x.shape[-3:]
    lead = x.shape[:-3]
    xe = x.to(dt).movedim(-3, 0).reshape(E, -1, d)
    y = torch.bmm(xe, w.to(dt))
    return y.reshape(E, *lead, C, w.shape[-1]).movedim(0, -3)


def _expert_ffn(params, x: torch.Tensor, activation: str) -> torch.Tensor:
    """x: (..., E, C, d) -> (..., E, C, d), batched over experts."""
    if activation == "swiglu":
        h = F.silu(_expert_mm(x, params["wg"])) * _expert_mm(x, params["wu"])
    elif activation == "geglu":
        h = _gelu(_expert_mm(x, params["wg"])) * _expert_mm(x, params["wu"])
    else:
        h = _gelu(_expert_mm(x, params["wu"]))
    return _expert_mm(h, params["wd"])


def _route(params, xt: torch.Tensor, top_k: int):
    """(probs, top_p, top_i) of the float32 router over xt (S, d); top_p
    renormalised over the chosen experts."""
    probs = torch.softmax(xt.float() @ params["router"], dim=-1)     # (S, E)
    top_p, top_i = torch.topk(probs, top_k, dim=-1)
    return probs, _renormalise(top_p), top_i


def _renormalise(top_p: torch.Tensor) -> torch.Tensor:
    """The chosen experts' probabilities over their sum, floored at 1e-9."""
    return top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)


def _shared_experts(params, xt: torch.Tensor, activation: str) -> torch.Tensor:
    if "shared_wg" in params:
        act = F.silu if activation == "swiglu" else _gelu
        h = act(_mm(xt, params["shared_wg"])) * _mm(xt, params["shared_wu"])
    else:
        h = _gelu(_mm(xt, params["shared_wu"]))
    return _mm(h, params["shared_wd"])


def _scatter_dispatch(xt, top_i, capacity: int, num_experts: int, dtype):
    """xt (S, d); top_i (S, k) -> (buf (E, C, d), keep, slot, flat_e), the
    slots ranked within their expert in flattened (token, choice) order."""
    top_k = top_i.shape[-1]
    flat_e = top_i.reshape(-1)                                       # (S*k,)
    onehot = F.one_hot(flat_e, num_experts)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1         # 0-based rank
    keep = (pos < capacity) & (pos >= 0)
    slot = pos.clamp(0, capacity - 1)
    xk = torch.repeat_interleave(xt, top_k, dim=0)
    contrib = torch.where(keep[:, None], xk, torch.zeros((), dtype=xk.dtype))
    buf = torch.zeros(num_experts, capacity, xt.shape[-1], dtype=dtype, device=xt.device)
    buf.index_put_((flat_e, slot), contrib.to(dtype), accumulate=True)
    return buf, keep, slot, flat_e


def _scatter_rows(rows, top_i, capacity: int, num_experts: int, dtype):
    """rows (R, S, d); top_i (R, S, k) -> ``_scatter_dispatch``'s four
    results for every row, stacked on a leading R."""
    disp = [_scatter_dispatch(xr, ir, capacity, num_experts, dtype)
            for xr, ir in zip(rows, top_i)]
    return tuple(torch.stack([r[i] for r in disp]) for i in range(4))


def _combine_rows(out_buf, flat_e, slot, keep):
    """out_buf (R, E, C, d); flat_e, slot, keep (R, S*k) -> each slot's
    expert output (R, S*k, d), zero where the slot was dropped."""
    R = out_buf.shape[0]
    gathered = out_buf[torch.arange(R, device=out_buf.device)[:, None], flat_e, slot]
    return torch.where(keep[..., None], gathered, torch.zeros((), dtype=gathered.dtype))


def moe_ffn(
    params,
    x: torch.Tensor,                 # (B, T, d)
    *,
    num_experts: int,
    top_k: int,
    capacity_factor: float = 1.25,
    activation: str = "swiglu",
    router_aux_weight: float = 0.01,
    expert_sharding: str | None = None,
    per_example_dispatch: bool = True,
    dispatch: str = "einsum",            # "einsum" | "scatter"
    dispatch_group: int = 512,           # token-chunk size for einsum dispatch
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, T, d), aux_loss), as the JAX package's
    ``moe_ffn`` computes them."""
    B, T, d = x.shape
    E = num_experts
    xt_all = x.reshape(B * T, d)
    probs, top_p, top_i = _route(params, xt_all, top_k)              # (B*T, k)

    if dispatch == "einsum" and per_example_dispatch:
        # one-hot dispatch per group of G tokens of a row; padded positions
        # route to expert 0 with weight 0 and rank after the real tokens
        G = max(1, min(dispatch_group, T))
        pad_t = (-T) % G
        ng = (T + pad_t) // G
        xg = F.pad(x, (0, 0, 0, pad_t))
        tp = F.pad(top_p.reshape(B, T, top_k), (0, 0, 0, pad_t))
        ti = F.pad(top_i.reshape(B, T, top_k), (0, 0, 0, pad_t))
        Bg, Tg = B * ng, G
        xg = xg.reshape(Bg, Tg, d)
        capacity = max(1, int(math.ceil(Tg * top_k / E * capacity_factor)))
        tp, ti = tp.reshape(Bg, Tg, top_k), ti.reshape(Bg, Tg, top_k)
        onehot_e = F.one_hot(ti, E).float()                          # (Bg,Tg,k,E)
        # rank of each (t, k) slot within its expert, per group
        flat = onehot_e.reshape(Bg, Tg * top_k, E)
        pos = (torch.cumsum(flat, dim=1) * flat).sum(-1) - 1.0
        pos = pos.reshape(Bg, Tg, top_k)
        keep = (pos < capacity) & (pos >= 0)
        onehot_c = F.one_hot(pos.long().clamp(0, capacity - 1), capacity).float() \
            * keep[..., None]                                        # (Bg,Tg,k,C)
        disp = torch.einsum("btke,btkc->btec", onehot_e, onehot_c)
        buf = torch.einsum("btec,btd->becd", disp.to(x.dtype), xg)
        out_buf = _expert_ffn(params, buf, activation)               # (Bg,E,C,d)
        # the combine weights are built in float32 and rounded to x's dtype
        comb = torch.einsum("btke,btkc,btk->btec", onehot_e, onehot_c,
                            tp.float()).to(x.dtype)
        y = _einsum("btec,becd->btd", comb, out_buf)
        y = y.reshape(B, ng * G, d)[:, :T].reshape(B * T, d)
    else:
        # scatter dispatch, capacity per batch row or (global) over the
        # flattened batch as one row
        rows = x if per_example_dispatch else xt_all[None]
        R, S = rows.shape[:2]
        capacity = max(1, int(math.ceil(S * top_k / E * capacity_factor)))
        # the routing runs on each shard's rows (on DTensors)
        buf, keep, slot, flat_e = rows_local(_scatter_rows, rows,
                                             top_i.reshape(R, S, top_k), capacity, E,
                                             x.dtype)
        # the experts on the expert axis, where the reference constrains them
        ep = (None, expert_sharding, None, None) if expert_sharding else None
        buf = constrain(buf, ep)
        out_buf = constrain(_expert_ffn(params, buf, activation), ep)  # (R, E, C, d)
        gathered = rows_local(_combine_rows, out_buf, flat_e, slot, keep)  # (R, S*k, d)
        w = top_p.reshape(R, S * top_k, 1).to(gathered.dtype)
        y = (gathered * w).reshape(B * T, top_k, d).sum(dim=1)

    if "shared_wu" in params:
        y = y + _shared_experts(params, xt_all, activation)

    # Switch-style load-balance aux loss, over each token's first choice
    frac = F.one_hot(top_i[:, 0], E).float().mean(dim=0)
    mean_p = probs.mean(dim=0)
    aux = router_aux_weight * E * (frac * mean_p).sum()
    return y.reshape(B, T, d), aux


def moe_ffn_dense_reference(params, x: torch.Tensor, *, num_experts: int,
                            top_k: int, activation: str = "swiglu") -> torch.Tensor:
    """Dropless dense oracle: every token computed by its top-k experts via
    full (S, E) weighting.  O(S*E*ff) — tests only."""
    B, T, d = x.shape
    xt = x.reshape(-1, d)
    probs, top_p, top_i = _route(params, xt, top_k)
    weights = torch.zeros_like(probs).scatter(-1, top_i, top_p)      # (S, E)
    per_expert = _expert_ffn(params, xt.expand(num_experts, *xt.shape),
                             activation)                             # (E, S, d)
    y = _einsum("se,esd->sd", weights.to(x.dtype), per_expert)
    if "shared_wu" in params:
        y = y + _shared_experts(params, xt, activation)
    return y.reshape(B, T, d)
