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

Past the JAX package (off by default), DeepSeek-V3 as published and one
chip's share of an expert-parallel layer:

  * ``scoring="sigmoid"`` (:func:`route_sigmoid`): its ``noaux_tc``
    router, with the selection bias ``router_bias`` a parameter;
  * :func:`moe_ffn_held`: the layer holds experts ``[first, first + count)``
    of ``num_experts`` (``wg``/``wu``/``wd`` of ``count`` experts), routes
    over all of them with the router at full width and computes only its
    own experts' part of the result, dropless, plus the shared experts.
    Prefill (more than one token a row) gathers each held expert's tokens
    and runs its products on them alone (a host read of the counts);
    decode runs every held expert on every row with zero weight where a
    row did not choose it: static shapes, no host read, so it replays in
    a CUDA graph.  While tracing is on prefill records the spans
    ``moe.route`` and ``moe.experts`` and counts ``moe.tokens`` (rows in),
    ``moe.held_slots`` ((row, choice) slots routed to a held expert),
    ``moe.expert_rows`` (rows the held experts' products computed) and
    ``moe.dropped`` (held slots not computed: 0, dropless); decode counts
    nothing (its rows are the graph's, its slots in the route log).  With
    :func:`log_routes` on, the layer also keeps its chosen experts: prefill's
    as they are, decode's in a ring on the device (in the graph too), for a
    check to hold a reference to the routing the program used
    (:func:`take_routes`).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.core.sharding import constrain, rows_local

from repro_torch.kernels import ops

from .layers import _einsum, _mm, dense_init


def init_moe(gen: torch.Generator, d_model: int, expert_d_ff: int,
             num_experts: int, num_shared: int, activation: str, lead=(),
             dtype=torch.float32, held: int | None = None,
             router_bias: bool = False) -> dict:
    """Expert params with the JAX package's distributions, drawn from
    ``gen``; ``lead`` prefixes every shape (the stacked ``n_groups`` axis).
    ``held`` experts' weights where given (the router stays at
    ``num_experts``); ``router_bias``: the sigmoid router's selection bias
    (zeros)."""
    gates = activation in ("swiglu", "geglu")
    E, d, ff = num_experts, d_model, expert_d_ff
    n = E if held is None else held
    params: dict[str, Any] = {
        "router": dense_init(gen, (*lead, d, E), d, torch.float32),
        "wu": dense_init(gen, (*lead, n, d, ff), d, dtype),
        "wd": dense_init(gen, (*lead, n, ff, d), ff, dtype),
    }
    if gates:
        params["wg"] = dense_init(gen, (*lead, n, d, ff), d, dtype)
    if num_shared:
        params["shared_wu"] = dense_init(gen, (*lead, d, num_shared * ff), d, dtype)
        params["shared_wd"] = dense_init(gen, (*lead, num_shared * ff, d), ff, dtype)
        if gates:
            params["shared_wg"] = dense_init(gen, (*lead, d, num_shared * ff), d, dtype)
    if router_bias:
        params["router_bias"] = torch.zeros(*lead, E, device=gen.device)
    return params


def moe_axes(num_shared: int, activation: str, router_bias: bool = False) -> dict:
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
    if router_bias:
        axes["router_bias"] = ("experts",)
    return axes


def _gelu(a: torch.Tensor) -> torch.Tensor:
    return F.gelu(a, approximate="tanh")


def _expert_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...ecd,edf->...ecf")`` as one ``ops.mm`` over the experts:
    the (E, d, f) weights are read in place, never permuted or copied."""
    return ops.mm(x.movedim(-3, 0), w).movedim(0, -3)


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


def route_sigmoid(params, xt: torch.Tensor, top_k: int, n_group: int, topk_group: int):
    """DeepSeek-V3's ``noaux_tc`` router over xt (S, d), in float32:
    (scores, top_w, top_i).  ``s = sigmoid(xt W)``; the choice runs on
    ``s + router_bias``: each of ``n_group`` groups scores the sum of its
    two best, the ``topk_group`` best groups stay, the top ``top_k``
    experts among them are chosen; their weights are the unbiased ``s``
    over its sum (the scaling is the caller's)."""
    s = torch.sigmoid(xt.float() @ params["router"])                  # (S, E)
    biased = s + params["router_bias"]
    if n_group > 1:
        S, E = s.shape
        g = biased.view(S, n_group, E // n_group)
        group_scores = g.topk(2, dim=-1)[0].sum(dim=-1)               # (S, n_group)
        kept = group_scores.topk(topk_group, dim=-1)[1]
        dropped = torch.ones_like(group_scores, dtype=torch.bool).scatter_(1, kept, False)
        biased = g.masked_fill(dropped[..., None], float("-inf")).flatten(1)
    top_i = biased.topk(top_k, dim=-1)[1]
    top_w = s.gather(1, top_i)
    return s, top_w / top_w.sum(-1, keepdim=True), top_i


def route(params, xt: torch.Tensor, top_k: int, scoring: str = "softmax",
          n_group: int = 1, topk_group: int = 1, scale: float = 1.0):
    """(scores, top_w, top_i) of the configured router, the weights times
    ``scale`` (``routed_scaling_factor``)."""
    if scoring == "sigmoid":
        scores, top_w, top_i = route_sigmoid(params, xt, top_k, n_group, topk_group)
    elif scoring == "softmax":
        scores, top_w, top_i = _route(params, xt, top_k)
    else:
        raise ValueError(f"scoring must be softmax or sigmoid, got {scoring!r}")
    return scores, top_w * scale, top_i


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


# ---------------------------------------------------------------------------
# one chip's share of an expert-parallel layer
# ---------------------------------------------------------------------------

def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class _RouteLog:
    """A device's logged choices: prefill's (S, k) tensors, decode's ring of
    (calls, rows, k) and the next call's slot in it."""

    def __init__(self, dev: torch.device, rows: int, top_k: int, calls: int):
        self.prefill: list[torch.Tensor] = []
        self.decode = torch.zeros(calls, rows, top_k, dtype=torch.int32, device=dev)
        self.next = torch.zeros((), dtype=torch.int64, device=dev)


_route_logs: dict[torch.device, _RouteLog] = {}


def log_routes(device, rows: int, top_k: int, calls: int) -> None:
    """From now on the held layer keeps its chosen experts on ``device``:
    each prefill call's (tokens, top_k) ids, and each decode call's in a
    ring of ``calls`` slots of up to ``rows`` rows (before a graph is
    captured, so that its replays write there too)."""
    dev = _device(device)
    _route_logs[dev] = _RouteLog(dev, rows, top_k, calls)


def take_routes(device) -> tuple[list[torch.Tensor], torch.Tensor]:
    """The choices logged on ``device`` since the last take, in call order:
    prefill's list and decode's (calls, rows, top_k); empties the log (one
    host read).  Raises where decode overran its ring."""
    log = _route_logs[_device(device)]
    n = int(log.next)
    if n > log.decode.shape[0]:
        raise RuntimeError(f"{n} decode calls overran the route log's {log.decode.shape[0]}")
    pre, dec = log.prefill, log.decode[:n].clone()
    log.prefill = []
    log.next.zero_()
    return pre, dec


def stop_routes(device) -> None:
    _route_logs.pop(_device(device), None)


def _log(top_i: torch.Tensor, decode: bool) -> None:
    log = _route_logs.get(_device(top_i.device))
    if log is None:
        return
    if decode:
        slot = (log.next % log.decode.shape[0]).view(1)
        log.decode[:, :top_i.shape[0]].index_copy_(0, slot, top_i[None].to(torch.int32))
        log.next.add_(1)
    else:
        log.prefill.append(top_i)


def _one_expert(params, j: int, h: torch.Tensor, activation: str) -> torch.Tensor:
    """Held expert ``j``'s FFN over rows h (n, d), in the promoted dtype."""
    if activation in ("swiglu", "geglu"):
        act = F.silu if activation == "swiglu" else _gelu
        a = act(_mm(h, params["wg"][j])) * _mm(h, params["wu"][j])
    else:
        a = _gelu(_mm(h, params["wu"][j]))
    return _mm(a, params["wd"][j])


def _held_gathered(params, xt, top_w, top_i, first: int, count: int, activation: str):
    """Prefill: each held expert's (row, weight) pairs gathered, its FFN run
    on those rows alone and added in, expert by expert (no row twice in one
    ``index_add_``: the sums are deterministic).  Reads the counts on the
    host."""
    N, d = xt.shape
    local = top_i - first
    tok, choice = ((local >= 0) & (local < count)).nonzero(as_tuple=True)
    e = local[tok, choice]
    order = torch.sort(e, stable=True).indices
    tok, e, w = tok[order], e[order], top_w[tok, choice][order]
    sizes = torch.bincount(e, minlength=count).tolist()
    y = torch.zeros(N, d, dtype=torch.promote_types(xt.dtype, params["wd"].dtype),
                    device=xt.device)
    start = 0
    for j, n in enumerate(sizes):
        if n:
            rows = tok[start:start + n]
            y.index_add_(0, rows, _one_expert(params, j, xt[rows], activation)
                         * w[start:start + n, None].to(y.dtype))
        start += n
    tracing.count("moe.tokens", N)
    tracing.count("moe.held_slots", len(tok))
    tracing.count("moe.expert_rows", start)
    tracing.count("moe.dropped", len(tok) - start)
    return y


def _held_dense(params, xt, top_w, top_i, first: int, count: int, activation: str):
    """Decode: every held expert on every row, weighted by the row's
    weight for it (0 where unchosen); static shapes, no host read."""
    mine = top_i[..., None] == torch.arange(first, first + count, device=xt.device)
    wh = (mine * top_w[..., None]).sum(1)                            # (N, count)
    out = _expert_ffn(params, xt.expand(count, *xt.shape), activation)  # (count, N, d)
    return torch.einsum("nsd,sn->sd", out, wh.to(out.dtype))


def moe_ffn_held(
    params,
    x: torch.Tensor,                 # (B, T, d)
    *,
    num_experts: int,
    top_k: int,
    held: tuple[int, int],
    activation: str = "swiglu",
    scoring: str = "softmax",
    n_group: int = 1,
    topk_group: int = 1,
    routed_scaling_factor: float = 1.0,
    decode: bool = False,
) -> torch.Tensor:
    """The part of the MoE layer's output that the held experts ``held =
    (first, count)`` of ``num_experts`` give, routed over all of them,
    dropless, plus the shared experts where ``params`` hold them (each chip
    computes them for its own tokens).  ``decode`` takes the static path.
    No aux loss: the layer serves."""
    B, T, d = x.shape
    if num_experts % n_group or not 0 <= held[0] <= held[0] + held[1] <= num_experts:
        raise ValueError(f"experts {held} of {num_experts} in {n_group} groups")
    xt = x.reshape(B * T, d)
    with tracing.span(None if decode else "moe.route"):
        _, top_w, top_i = route(params, xt, top_k, scoring, n_group, topk_group,
                                routed_scaling_factor)
    if _route_logs:
        _log(top_i, decode)
    with tracing.span(None if decode else "moe.experts"):
        fn = _held_dense if decode else _held_gathered
        y = fn(params, xt, top_w, top_i, held[0], held[1], activation)
        if "shared_wu" in params:
            y = y + _shared_experts(params, xt, activation)
    return y.reshape(B, T, d)
