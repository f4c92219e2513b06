"""Dispatch for the port's kernels, by the device of the tensors given.

A CPU tensor goes to the kernel's plain PyTorch version (``ref.py``); a
CUDA tensor goes to the hand-written Hopper kernel, which either launches or
raises: there is no fallback from the card to the plain version.
``flash_attention(impl="reference")`` asks for the plain attention on any
device, for checks that hold a model through the kernel against it.
"""

from __future__ import annotations

import torch

from . import ref
from .chunk_combine import chunk_combine_cuda
from .flash_attention import FlashAttention, flash_attention_bwd_cuda, flash_attention_cuda

IMPLS = ("auto", "reference")


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
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    kw = dict(causal=causal, window=window, prefix_len=prefix_len,
              logit_cap=logit_cap, scale=scale, q_offset=q_offset,
              k_valid_len=k_valid_len)
    if impl == "reference" or q.device.type == "cpu":
        return ref.reference_attention(q, k, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
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


_WRAPPERS = {"flash_attention": flash_attention_cuda,
             "flash_attention_bwd": flash_attention_bwd_cuda,
             "chunk_combine": chunk_combine_cuda}


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: w.launches for name, w in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for w in _WRAPPERS.values():
        w.launches = 0
