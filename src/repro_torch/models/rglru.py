"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The port of the JAX package's ``models/rglru.py``.  Per channel:

    r_t = sigmoid(W_r x_t)                      # recurrence gate
    i_t = sigmoid(W_i x_t)                      # input gate
    a_t = exp(-c * softplus(Lambda) * r_t)      # data-dependent decay
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

inside Griffin's recurrent block: linear in -> causal conv1d(4) -> RG-LRU ->
gated linear out.  Train and prefill run the recurrence through
``kernels.ops.lru_scan`` (the Hopper kernel for CUDA tensors, the plain
sequential scan on the CPU); decode is a single state update in plain
PyTorch, as in the JAX package.  Parameters keep the JAX keys and shapes.

Like the port's KV cache, an :class:`RGLRUState` is updated in place by
prefill and decode and returned.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from .layers import _mm, dense_init, rand, randn

C_CONST = 8.0


def init_rglru_block(gen: torch.Generator, d_model: int, lru_width: int,
                     conv_width: int, lead=(), dtype=torch.float32) -> dict:
    w, dev = lru_width, gen.device
    # Lambda init so a = exp(-c*softplus(L)) is spread in (0.9, 0.999), the
    # Griffin init: softplus^-1(-ln(u)/c) for u ~ U(0.9, 0.999)
    u = 0.9 + 0.099 * rand(gen, (*lead, w))
    lam = torch.log(torch.expm1(-torch.log(u) / C_CONST))
    return {
        "w_x": dense_init(gen, (*lead, d_model, w), d_model, dtype),
        "w_gate": dense_init(gen, (*lead, d_model, w), d_model, dtype),
        "conv_w": (randn(gen, (*lead, conv_width, w))
                   * 0.1).to(dtype),
        "conv_b": torch.zeros((*lead, w), dtype=dtype, device=dev),
        "w_rg": dense_init(gen, (*lead, w, w), w, dtype),
        "b_rg": torch.zeros((*lead, w), device=dev),
        "w_ig": dense_init(gen, (*lead, w, w), w, dtype),
        "b_ig": torch.zeros((*lead, w), device=dev),
        "lam": lam.float(),
        "w_out": dense_init(gen, (*lead, w, d_model), w, dtype),
    }


#: logical sharding axes of ``init_rglru_block``'s params (the JAX package's)
RGLRU_AXES = {"w_x": ("embed", "lru"), "w_gate": ("embed", "lru"),
              "conv_w": (None, "lru"), "conv_b": ("lru",),
              "w_rg": ("lru", None), "b_rg": ("lru",),
              "w_ig": ("lru", None), "b_ig": ("lru",),
              "lam": ("lru",), "w_out": ("lru", "embed")}


@dataclasses.dataclass
class RGLRUState:
    """Decode-time state: LRU hidden + conv tail window."""

    h: torch.Tensor                # (B, W)
    conv_tail: torch.Tensor        # (B, conv_width-1, W)


def init_rglru_state(batch: int, lru_width: int, conv_width: int,
                     dtype=torch.float32, device=None, lead=()) -> RGLRUState:
    return RGLRUState(
        h=torch.zeros((*lead, batch, lru_width), dtype=dtype, device=device),
        conv_tail=torch.zeros((*lead, batch, conv_width - 1, lru_width),
                              dtype=dtype, device=device))


def _gates(params, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """u: (..., W) post-conv activations -> (a, gated_input) in float32."""
    uf = u.float()
    r = torch.sigmoid(uf @ params["w_rg"].float() + params["b_rg"])
    i = torch.sigmoid(uf @ params["w_ig"].float() + params["b_ig"])
    log_a = -C_CONST * F.softplus(params["lam"]) * r       # (..., W), < 0
    a = torch.exp(log_a)
    x_in = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * uf)
    return a, x_in


def _tail(seq: torch.Tensor, n: int) -> torch.Tensor:
    """The last ``n`` time steps of (B, T, W), empty for n = 0."""
    return seq[:, seq.shape[1] - n:]


def rglru_block(
    params,
    x: torch.Tensor,               # (B, T, d)
    *,
    conv_width: int,
    state: RGLRUState | None = None,
    mode: str = "train",
) -> tuple[torch.Tensor, RGLRUState | None]:
    """Returns (y in x's dtype, the state updated in place, or None in
    train mode).  Prefill and decode need ``state`` (:func:`init_rglru_state`)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got {mode!r}")
    if mode != "train" and state is None:
        raise ValueError(f"mode={mode!r} needs a state (init_rglru_state)")
    B, T, _ = x.shape
    u = _mm(x, params["w_x"])                                   # (B,T,W)
    gate = F.gelu(_mm(x, params["w_gate"]).float(), approximate="tanh")
    W = u.shape[-1]
    conv_w, conv_b = params["conv_w"].float(), params["conv_b"].float()

    if mode == "decode":
        if T != 1:
            raise ValueError(f"decode takes one token, got {T}")
        hist = torch.cat([state.conv_tail, u.to(state.conv_tail.dtype)], dim=1)
        win = _tail(hist, conv_width)                           # (B,cw,W)
        cu = torch.einsum("bcw,cw->bw", win.float(), conv_w) + conv_b
        a, x_in = _gates(params, cu[:, None])                   # (B,1,W)
        h = a[:, 0] * state.h.float() + x_in[:, 0]
        y = (h * gate[:, 0]) @ params["w_out"].float()
        state.h.copy_(h)
        state.conv_tail.copy_(_tail(hist, conv_width - 1))
        return y[:, None].to(x.dtype), state

    # causal conv1d over time, continuing from the state's tail
    pad = state.conv_tail.to(u.dtype) if state is not None \
        else torch.zeros((B, conv_width - 1, W), dtype=u.dtype, device=u.device)
    up = torch.cat([pad, u], dim=1)                             # (B,T+cw-1,W)
    cu = sum(up[:, c:c + T].float() * conv_w[c] for c in range(conv_width)) + conv_b

    a, x_in = _gates(params, cu)                                # (B,T,W)
    h0 = state.h.float() if state is not None \
        else torch.zeros((B, W), device=x.device)
    h = ops.lru_scan(a, x_in, h0.contiguous())                  # (B,T,W)
    y = (h * gate) @ params["w_out"].float()
    if mode == "train":
        return y.to(x.dtype), None
    state.h.copy_(h[:, -1])
    state.conv_tail.copy_(_tail(up, conv_width - 1))
    return y.to(x.dtype), state
