"""Dispatch for the port's kernels, by the device of the tensors given.

A CPU tensor goes to the kernel's plain PyTorch version (``ref.py``); a
CUDA tensor goes to the hand-written Hopper kernel, which either launches or
raises: there is no fallback from the card to the plain version.
``impl="reference"`` asks for the plain version on any device, for checks
that hold the kernel against it.
"""

from __future__ import annotations

import torch

from . import ref
from .flash_attention import flash_attention_cuda

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
    """(B,Tq,KVH,G,D) x (B,Tk,KVH,D)^2 -> (B,Tq,KVH,G,D), in q's dtype."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    kw = dict(causal=causal, window=window, prefix_len=prefix_len,
              logit_cap=logit_cap, scale=scale, q_offset=q_offset,
              k_valid_len=k_valid_len)
    if impl == "reference" or q.device.type == "cpu":
        return ref.reference_attention(q, k, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    return flash_attention_cuda(q, k, v, **kw)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {"flash_attention": flash_attention_cuda.launches}


def reset_launch_counts() -> None:
    flash_attention_cuda.launches = 0
