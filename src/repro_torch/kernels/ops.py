"""Dispatch for the port's kernels, by the device of the tensors given.

A CPU tensor goes to the kernel's plain PyTorch version (``ref.py``); a
CUDA tensor goes to the hand-written Hopper kernel, which either launches or
raises: there is no fallback from the card to the plain version.
``impl="reference"`` asks for the plain version on any device, for checks
that hold a model through the kernels against it.  On the card, inputs that
require grad (with grad mode on) go through the kernel's
``autograd.Function``.
"""

from __future__ import annotations

import torch

from . import ref
from .chunk_combine import chunk_combine_cuda
from .flash_attention import FlashAttention, flash_attention_bwd_cuda, flash_attention_cuda
from .lru_scan import LRUScan, lru_scan_bwd_cuda, lru_scan_cuda
from .wkv_scan import WKVScan, wkv_scan_bwd_cuda, wkv_scan_cuda

IMPLS = ("auto", "reference")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def _wants_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(
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
    impl: str = "auto",
) -> torch.Tensor:
    """(B,Tq,KVH,G,D) x (B,Tk,KVH,D)^2 -> (B,Tq,KVH,G,D), in q's dtype.

    On the card, inputs that require grad (with grad mode on) go through
    :class:`FlashAttention`, whose backward is the backward kernel; it takes
    no ``q_offset`` or ``k_valid_len`` (decode and cache reads are
    inference-only) and raises if given them.
    """
    _check_impl(impl)
    kw = dict(causal=causal, window=window, prefix_len=prefix_len,
              logit_cap=logit_cap, scale=scale, q_offset=q_offset,
              k_valid_len=k_valid_len)
    if impl == "reference" or q.device.type == "cpu":
        return ref.reference_attention(q, k, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    if _wants_grad(q, k, v):
        if q_offset != 0 or k_valid_len is not None:
            raise ValueError("the flash_attention backward kernel takes no "
                             "q_offset or k_valid_len")
        return FlashAttention.apply(q, k, v, causal, window, prefix_len,
                                    logit_cap, scale)
    return flash_attention_cuda(q, k, v, **kw)


def chunk_combine(local: torch.Tensor, recv: torch.Tensor, seg_mask, accumulate,
                  *, out: torch.Tensor | None = None) -> torch.Tensor:
    """Fused R2CCL stage-2 merge of (C, M) buffers with (C,) row masks;
    ``out=local`` merges in place.  Returns ``out`` (a new tensor if not
    given)."""
    if local.device.type == "cpu":
        res = ref.reference_chunk_combine(local, recv, seg_mask, accumulate)
        return res if out is None else out.copy_(res)
    if local.device.type != "cuda":
        raise ValueError(f"no chunk_combine kernel for device {local.device}")
    return chunk_combine_cuda(local, recv, seg_mask, accumulate, out=out)


def lru_scan(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor, *,
             impl: str = "auto") -> torch.Tensor:
    """RG-LRU states ``h_t = a_t * h_{t-1} + x_t`` from ``h0``: a, x
    (B, T, W), h0 (B, W) -> (B, T, W) float32.  On the card, inputs that
    require grad go through :class:`LRUScan`, whose backward is the
    ``lru_scan_bwd`` kernel."""
    _check_impl(impl)
    if impl == "reference" or a.device.type == "cpu":
        return ref.reference_lru_scan(a, x, h0)
    if a.device.type != "cuda":
        raise ValueError(f"no lru_scan kernel for device {a.device}")
    if _wants_grad(a, x, h0):
        return LRUScan.apply(a, x, h0)
    return lru_scan_cuda(a, x, h0)


def wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, s0: torch.Tensor, *, impl: str = "auto"
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 WKV recurrence in the model's layout: r, k, v, w (B, T, H, K),
    u (H, K), s0 (B, H, K, K) -> (out (B, T, H, K), s_T (B, H, K, K)),
    float32.  On the card, inputs that require grad go through
    :class:`WKVScan`, whose backward is the ``wkv_scan_bwd`` kernel."""
    _check_impl(impl)
    if impl == "reference" or r.device.type == "cpu":
        return ref.reference_wkv(r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"no wkv_scan kernel for device {r.device}")
    if _wants_grad(r, k, v, w, u, s0):
        return WKVScan.apply(r, k, v, w, u, s0)
    return wkv_scan_cuda(r, k, v, w, u, s0)


_WRAPPERS = {"flash_attention": flash_attention_cuda,
             "flash_attention_bwd": flash_attention_bwd_cuda,
             "chunk_combine": chunk_combine_cuda,
             "lru_scan": lru_scan_cuda,
             "lru_scan_bwd": lru_scan_bwd_cuda,
             "wkv_scan": wkv_scan_cuda,
             "wkv_scan_bwd": wkv_scan_bwd_cuda}


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: w.launches for name, w in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for w in _WRAPPERS.values():
        w.launches = 0
