"""RWKV-6 "Finch" time-mix + channel-mix (arXiv:2404.05892).

The port of the JAX package's ``models/rwkv6.py``.  Attention-free: the WKV
recurrence keeps a matrix state S (H x K x V) per sequence with a
data-dependent per-channel decay w_t:

    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)      # bonus u on the current token
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

Token-shift mixes each input with the previous token through learned,
data-dependent (low-rank) interpolation.  Train and prefill run the
recurrence through ``kernels.ops.wkv_scan`` (the Hopper kernel for CUDA
tensors, the plain scan on the CPU); decode is a single state update in
plain PyTorch (the plain scan at T=1, as the JAX block decodes through
``wkv_scan_ref``), like the RG-LRU block's.  Parameters keep the JAX keys and
shapes.  Like the port's KV cache, an :class:`RWKVState` is updated in
place by prefill and decode and returned.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from .layers import dense_init, rand, randn

GROUP_NORM_EPS = 64e-5        # RWKV's ln_x, per head


def init_rwkv_block(gen: torch.Generator, d_model: int, head_size: int,
                    decay_lora: int, tokenshift_lora: int, lead=(),
                    dtype=torch.float32) -> dict:
    d, dev = d_model, gen.device
    ff = d * 7 // 2

    def dense(shape, fan_in):
        return dense_init(gen, (*lead, *shape), fan_in, dtype)

    return {
        # time-mix projections
        "w_r": dense((d, d), d), "w_k": dense((d, d), d),
        "w_v": dense((d, d), d), "w_g": dense((d, d), d),
        "w_o": dense((d, d), d),
        # data-dependent decay (low-rank): w_t = exp(-exp(base + lora(x)))
        "decay_base": torch.full((*lead, d), -6.0, device=dev),
        "decay_a": dense((d, decay_lora), d),
        "decay_b": dense((decay_lora, d), decay_lora),
        # per-channel bonus for the current token
        "u": randn(gen, (*lead, d)) * 0.1,
        # token-shift interpolation (one mu per projection role + lora)
        "mu": rand(gen, (*lead, 5, d)),
        "ts_a": dense((d, tokenshift_lora), d),
        "ts_b": dense((tokenshift_lora, 5 * d), tokenshift_lora),
        "ln_x_scale": torch.ones((*lead, d), device=dev),
        # channel-mix
        "cm_k": dense((d, ff), d),
        "cm_v": dense((ff, d), ff),
        "cm_mu": rand(gen, (*lead, d)),
    }


#: logical sharding axes of ``init_rwkv_block``'s params (the JAX package's)
RWKV_AXES = {"w_r": ("embed", "heads"), "w_k": ("embed", "heads"),
             "w_v": ("embed", "heads"), "w_g": ("embed", "heads"),
             "w_o": ("heads", "embed"),
             "decay_base": (None,), "decay_a": ("embed", None), "decay_b": (None, "heads"),
             "u": (None,), "mu": (None, None), "ts_a": ("embed", None), "ts_b": (None, None),
             "ln_x_scale": (None,), "cm_k": ("embed", "mlp"), "cm_v": ("mlp", "embed"),
             "cm_mu": (None,)}


@dataclasses.dataclass
class RWKVState:
    s: torch.Tensor                 # (B, H, K, V) wkv state
    shift_tm: torch.Tensor          # (B, d) previous token (time-mix)
    shift_cm: torch.Tensor          # (B, d) previous token (channel-mix)


def init_rwkv_state(batch: int, d_model: int, head_size: int,
                    dtype=torch.float32, device=None, lead=()) -> RWKVState:
    H = d_model // head_size
    return RWKVState(
        s=torch.zeros((*lead, batch, H, head_size, head_size), dtype=dtype,
                      device=device),
        shift_tm=torch.zeros((*lead, batch, d_model), dtype=dtype, device=device),
        shift_cm=torch.zeros((*lead, batch, d_model), dtype=dtype, device=device))


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x: (B,T,d); prev: (B,d) last token of the previous segment."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def rwkv_block(
    params,
    x: torch.Tensor,               # (B,T,d)
    *,
    head_size: int,
    state: RWKVState | None = None,
    mode: str = "train",
) -> tuple[torch.Tensor, RWKVState | None]:
    """Returns (y in x's dtype, the state updated in place, or None in
    train mode).  Prefill and decode need ``state`` (:func:`init_rwkv_state`)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got {mode!r}")
    if mode != "train" and state is None:
        raise ValueError(f"mode={mode!r} needs a state (init_rwkv_state)")
    B, T, d = x.shape
    H = d // head_size
    if mode == "decode" and T != 1:
        raise ValueError(f"decode takes one token, got {T}")
    xf = x.float()

    def f32(name):
        return params[name].float()

    prev_tm = state.shift_tm.float() if state is not None \
        else torch.zeros((B, d), device=x.device)
    xs = _token_shift(xf, prev_tm)                              # (B,T,d)

    # Finch data-dependent token shift: per-role interpolation factors
    lora = torch.tanh(xf @ f32("ts_a")) @ f32("ts_b")           # (B,T,5d)
    mix = torch.sigmoid(params["mu"][None, None] + lora.reshape(B, T, 5, d))
    xr, xk, xv, xw, xg = [xf + mix[:, :, i] * (xs - xf) for i in range(5)]

    r = (xr @ f32("w_r")).reshape(B, T, H, head_size)
    k = (xk @ f32("w_k")).reshape(B, T, H, head_size)
    v = (xv @ f32("w_v")).reshape(B, T, H, head_size)
    g = F.silu(xg @ f32("w_g"))

    dec = params["decay_base"] + torch.tanh(xw @ f32("decay_a")) @ f32("decay_b")
    w = torch.exp(-torch.exp(dec)).reshape(B, T, H, head_size)  # in (0,1)
    u = params["u"].reshape(H, head_size).contiguous()

    s0 = state.s.float() if state is not None \
        else torch.zeros((B, H, head_size, head_size), device=x.device)
    if mode == "decode":
        out, s_t = ref.reference_wkv(r, k, v, w, u, s0)
    else:
        out, s_t = ops.wkv_scan(r, k, v, w, u, s0.contiguous())

    # group-norm per head (RWKV's ln_x), then gate and project out
    mu_ = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, correction=0)
    o = (out - mu_) * torch.rsqrt(var + GROUP_NORM_EPS)
    o = o.reshape(B, T, d) * params["ln_x_scale"]
    y_tm = (o * g) @ f32("w_o")

    # channel-mix sublayer (with its own token shift)
    h_in = xf + y_tm
    prev_cm = state.shift_cm.float() if state is not None \
        else torch.zeros((B, d), device=x.device)
    hk = h_in + params["cm_mu"] * (_token_shift(h_in, prev_cm) - h_in)
    cm = torch.square(F.relu(hk @ f32("cm_k")))
    y = y_tm + cm @ f32("cm_v")

    if mode == "train":
        return y.to(x.dtype), None
    state.s.copy_(s_t)
    state.shift_tm.copy_(xf[:, -1])
    state.shift_cm.copy_(h_in[:, -1])
    return y.to(x.dtype), state
