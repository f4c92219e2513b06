"""Dispatch for the port's kernels, by the device of the tensors given.

A CPU tensor goes to the kernel's plain PyTorch version (``ref.py``); a
CUDA tensor goes to the kernel's dispatcher op (``library.py``), which
launches the hand-written Hopper kernel or raises: there is no fallback from
the card to the plain version.  A meta tensor goes to the op too, whose fake
gives the output's shape and dtype, so a dry run never walks a plain scan's
time loop.  :func:`mm`, the models' one product, takes the small-row
kernel on the card where it fits and ``@`` / ``bmm`` (cuBLAS) elsewhere;
:func:`mla_decode`, MLA decode's attention core, takes its kernel on the card
where it fits and the plain version elsewhere (the meta device included).

This module alone chooses, and :func:`use` is its one switch:
``use("reference")`` asks for the plain version of every kernel on any
device (and cuBLAS for every product), for checks that hold a model through
the kernels against it; ``use("op")`` sends a CPU tensor through the op as
well (its CPU implementation is the plain version), so that a CPU run counts
the kernels' work by their formulas as the card's does.  Off the CPU path,
inputs that require grad (with grad mode on) go through the kernel's
``autograd.Function``.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch import tracing
from . import library, ref  # noqa: F401  (library registers the ops)
from .chunk_combine import chunk_combine_cuda
from .flash_attention import FlashAttention, flash_attention_bwd_cuda, flash_attention_cuda
from .lru_scan import LRUScan, lru_scan_bwd_cuda, lru_scan_cuda
from .mla_decode import fits as mla_decode_fits
from .mla_decode import mla_decode_cuda
from .small_mm import fits as small_mm_fits
from .small_mm import small_mm_cuda
from .small_mm import x_aligned as small_mm_x_aligned
from .wkv_scan import WKVScan, wkv_scan_bwd_cuda, wkv_scan_cuda

IMPLS = ("auto", "reference", "op")
DEVICES = ("cpu", "cuda", "meta")

_impl = contextvars.ContextVar("kernel_impl", default="auto")


@contextlib.contextmanager
def use(impl: str):
    """Inside, every function of this module takes ``impl`` (one of
    ``IMPLS``; ``"auto"`` outside any ``use``); raises on another."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    token = _impl.set(impl)
    try:
        yield
    finally:
        _impl.reset(token)


def current() -> str:
    """The implementation :func:`use` has chosen here."""
    return _impl.get()


def _plain(name: str, t: torch.Tensor) -> bool:
    """Whether the current impl and ``t``'s device take the plain version
    (else the op); raises on a device with no kernel."""
    if t.device.type not in DEVICES:
        raise ValueError(f"no {name} kernel for device {t.device}")
    impl = _impl.get()
    return impl == "reference" or (impl == "auto" and t.device.type == "cpu")


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
) -> torch.Tensor:
    """(B,Tq,KVH,G,D) x (B,Tk,KVH,D)^2 -> (B,Tq,KVH,G,D), in q's dtype.

    Through the op, inputs that require grad (with grad mode on) go through
    :class:`FlashAttention`, whose backward is the backward kernel; it takes
    no ``q_offset`` or ``k_valid_len`` (decode and cache reads are
    inference-only) and raises if given them.
    """
    if _plain("flash_attention", q):
        return ref.reference_attention(q, k, v, causal=causal, window=window,
                                       prefix_len=prefix_len, logit_cap=logit_cap,
                                       scale=scale, q_offset=q_offset,
                                       k_valid_len=k_valid_len)
    if _wants_grad(q, k, v):
        if q_offset != 0 or k_valid_len is not None:
            raise ValueError("the flash_attention backward kernel takes no "
                             "q_offset or k_valid_len")
        return FlashAttention.apply(q, k, v, causal, window, prefix_len,
                                    logit_cap, scale)
    return torch.ops.repro_torch.flash_attention_fwd(
        q, k, v, None, causal, window, prefix_len, logit_cap, scale, q_offset,
        k_valid_len)


def chunk_combine(local: torch.Tensor, recv: torch.Tensor, seg_mask, accumulate,
                  *, out: torch.Tensor | None = None) -> torch.Tensor:
    """Fused R2CCL stage-2 merge of (C, M) buffers with (C,) row masks
    (sequences of bools); ``out=local`` merges in place.  Returns ``out`` (a
    new tensor if not given)."""
    if _plain("chunk_combine", local):
        res = ref.reference_chunk_combine(local, recv, seg_mask, accumulate)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty_like(local)
    torch.ops.repro_torch.chunk_combine(local, recv, _bools(seg_mask), _bools(accumulate),
                                        out)
    return out


def _bools(mask) -> list | tuple:
    """A (C,) mask as the op's ``bool[]``: a list or tuple as it is, an
    array or tensor as a list (a CUDA tensor is copied to the host)."""
    if isinstance(mask, (list, tuple)):
        return mask
    return torch.as_tensor(mask).bool().tolist()


def lru_scan(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """RG-LRU states ``h_t = a_t * h_{t-1} + x_t`` from ``h0``: a, x
    (B, T, W), h0 (B, W) -> (B, T, W) float32.  Through the op, inputs that
    require grad go through :class:`LRUScan`, whose backward is the
    ``lru_scan_bwd`` kernel."""
    if _plain("lru_scan", a):
        return ref.reference_lru_scan(a, x, h0)
    if _wants_grad(a, x, h0):
        return LRUScan.apply(a, x, h0)
    return torch.ops.repro_torch.lru_scan(a, x, h0)


def wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, s0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 WKV recurrence in the model's layout: r, k, v, w (B, T, H, K),
    u (H, K), s0 (B, H, K, K) -> (out (B, T, H, K), s_T (B, H, K, K)),
    float32.  Through the op, inputs that require grad go through
    :class:`WKVScan`, whose backward is the ``wkv_scan_bwd`` kernel."""
    if _plain("wkv_scan", r):
        return ref.reference_wkv(r, k, v, w, u, s0)
    if _wants_grad(r, k, v, w, u, s0):
        return WKVScan.apply(r, k, v, w, u, s0)
    return torch.ops.repro_torch.wkv_scan(r, k, v, w, u, s0, None)


def small_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for w (K, N), x (..., K), or ``x[g] @ w[g]`` for w
    (G, K, N), x (G, ..., K): float32, x float32 or bfloat16 (widened).
    Through the op, the small-row kernel, which takes at most
    ``small_mm.MAX_ROWS`` rows a batch entry (``small_mm.fits``); an x
    whose rows are off the 16-byte grid is copied first; no autograd."""
    K, N = w.shape[-2:]
    G = 1 if w.dim() == 2 else w.shape[0]
    x3 = x.reshape(G, -1, K)
    w3 = w.unsqueeze(0) if w.dim() == 2 else w
    if _plain("small_mm", x):
        y = ref.reference_small_mm(x3, w3)
    else:
        if x3.device.type == "cuda" and not small_mm_x_aligned(x3):
            x3 = x3.clone(memory_format=torch.contiguous_format)
        y = torch.ops.repro_torch.small_mm(x3, w3)
    return y.reshape(*x.shape[:-1], N)


def _small_rows(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether :func:`mm` sends a product to the small-row kernel: on the
    card, where ``small_mm.fits`` (float32, at most 16 rows, w row-major, no
    grad) and not inside ``use("reference")``, counted under
    ``mm.small_rows``, else cuBLAS, under ``mm.library`` (while tracing is
    on; once a capture inside a graph).  A CPU or meta product (the JAX
    parity tests, the dry run) keeps ``@`` and counts nothing."""
    if not (x.is_cuda and w.is_cuda):
        return False
    take = _impl.get() != "reference" and small_mm_fits(x, w)
    tracing.count("mm.small_rows" if take else "mm.library")
    return take


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for w (K, N), or ``x[g] @ w[g]`` for w (G, K, N) and x
    (G, ..., K), in the promoted dtype (``jnp.result_type``): the models'
    one product, through :func:`small_mm` where :func:`_small_rows` says so,
    else ``@`` / one ``bmm``."""
    if _small_rows(x, w):
        return small_mm(x, w)
    dt = torch.promote_types(x.dtype, w.dtype)
    if w.dim() == 2:
        return x.to(dt) @ w.to(dt)
    K, N = w.shape[-2:]
    return torch.bmm(x.to(dt).reshape(w.shape[0], -1, K), w.to(dt)).reshape(*x.shape[:-1], N)


def mla_decode(q_abs: torch.Tensor, q_pe: torch.Tensor, c_kv: torch.Tensor,
               k_pe: torch.Tensor, pos, scale: float) -> torch.Tensor:
    """MLA decode's absorbed attention core: ``softmax(scale * (q_abs
    c_kv^T + q_pe k_pe^T)) c_kv`` over the live slots ``s <= pos`` of the
    latent cache (``pos`` an int, or the cache's int64 position on its
    device); q_abs (B, 1, H, R), q_pe (B, 1, H, rope), c_kv (B, S, R), k_pe
    (B, S, rope) -> (B, 1, H, R).  On the card, where
    ``mla_decode.fits`` holds and not inside ``use("reference")``, the
    kernel (float32 out), counted under ``attn.mla_decode`` while tracing is
    on (once a capture inside a graph); a CPU call inside ``use("op")``
    takes the op too.  Else, the meta device included (the dry run and its
    sharded count keep the plain products over every slot), the plain
    version (out in the cache's dtype)."""
    impl = _impl.get()
    dev = q_abs.device.type
    take = (impl != "reference" and (dev == "cuda" or (dev == "cpu" and impl == "op"))
            and mla_decode_fits(q_abs, q_pe, c_kv, k_pe))
    if not take:
        return ref.reference_mla_decode(q_abs, q_pe, c_kv, k_pe, pos, scale)
    if dev == "cuda":
        tracing.count("attn.mla_decode")
    index, host = (pos, 0) if isinstance(pos, torch.Tensor) else (None, int(pos))
    return torch.ops.repro_torch.mla_decode(q_abs, q_pe, c_kv, k_pe, index, host, scale, None)


_WRAPPERS = {"flash_attention": flash_attention_cuda,
             "flash_attention_bwd": flash_attention_bwd_cuda,
             "chunk_combine": chunk_combine_cuda,
             "lru_scan": lru_scan_cuda,
             "lru_scan_bwd": lru_scan_bwd_cuda,
             "wkv_scan": wkv_scan_cuda,
             "wkv_scan_bwd": wkv_scan_bwd_cuda,
             "small_mm": small_mm_cuda,
             "mla_decode": mla_decode_cuda}


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: w.launches for name, w in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for w in _WRAPPERS.values():
        w.launches = 0
