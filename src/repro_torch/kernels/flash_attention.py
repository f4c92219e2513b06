"""Flash attention on Hopper: the wrappers of ``csrc/flash_attention.cu``
(forward) and ``csrc/flash_attention_bwd.cu`` (backward).

The forward replaces the TPU kernel ``flash_attention_pallas`` of the JAX
package (``kernels/flash_attention.py``).  The backward has no Pallas
counterpart: it replaces ``jax.grad`` through the JAX package's
``models/layers.py::blockwise_attention``.  :class:`FlashAttention` joins the
two as a ``torch.autograd.Function``.  The kernels' plain version is
``ref.reference_attention`` (differentiated by autograd);
``ops.flash_attention`` picks between them by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from .build import entry

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 13
             + [ctypes.c_float, ctypes.c_float]
             + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 13
                 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
MAX_HEAD_DIM = 256
MAX_BWD_HEAD_DIM = 128  # the backward's K, V, Q and dO tiles fit shared memory
MAX_GROUP = 64          # query heads per KV head: one CTA holds them all


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,Tq,KVH,G,D), k = v (B,Tk,KVH,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, KVH, G, D = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, KVH, D):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         "on batch, kv heads or head_dim")
    if D > MAX_HEAD_DIM or G > MAX_GROUP:
        raise ValueError(f"flash_attention kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM} and <= {MAX_GROUP} query heads per "
                         f"kv head; got D={D}, G={G}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention kernel needs q, k, v on one CUDA "
                         f"device; got {q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")


def flash_attention_cuda(
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
    lse: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch the kernel on q's device and PyTorch's current stream.

    ``lse``, if given, is a float32 (B, Tq, KVH, G) tensor that receives each
    query row's log-sum-exp (-inf for a row that sees no key), for the
    backward.  Raises on inputs the kernel does not take and when the launch
    is refused (``cudaGetLastError`` non-zero).
    ``flash_attention_cuda.launches`` counts launches.
    """
    _check(q, k, v)
    B, Tq, KVH, G, D = q.shape
    Tk = k.shape[1]
    if lse is not None and (lse.shape != (B, Tq, KVH, G) or lse.dtype != torch.float32
                            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 {(B, Tq, KVH, G)} "
                         f"tensor on {q.device}")
    out = torch.empty_like(q)
    scale = scale if scale is not None else D ** -0.5
    fn = entry("flash_attention", "repro_flash_attention_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], B, Tq, Tk, KVH, G, D, int(bool(causal)),
                 int(window is not None), int(window or 0),
                 int(prefix_len is not None), int(prefix_len or 0),
                 int(logit_cap is not None), float(logit_cap or 0.0),
                 float(scale), int(q_offset),
                 int(k_valid_len is not None), int(k_valid_len or 0),
                 None if lse is None else lse.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def flash_attention_bwd_cuda(
    q: torch.Tensor,                 # (B, Tq, KVH, G, D)
    k: torch.Tensor,                 # (B, Tk, KVH, D)
    v: torch.Tensor,
    out: torch.Tensor,               # the forward's output, like q
    dout: torch.Tensor,              # gradient of the loss w.r.t. out
    lse: torch.Tensor,               # the forward's (B, Tq, KVH, G) float32
    *,
    causal: bool = True,
    window: int | None = None,
    prefix_len: int | None = None,
    logit_cap: float | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the backward kernel, on PyTorch's current stream.

    One call launches three kernels (delta = rowsum(dO * O), dK/dV, dQ) and
    counts once in ``flash_attention_bwd_cuda.launches``.  Raises on inputs
    the kernel does not take (head_dim above 128) and when a
    launch is refused.
    """
    _check(q, k, v)
    B, Tq, KVH, G, D = q.shape
    Tk = k.shape[1]
    if D > MAX_BWD_HEAD_DIM:
        raise ValueError(f"flash_attention backward kernel takes head_dim <= "
                         f"{MAX_BWD_HEAD_DIM}, got {D}")
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor like q")
    if lse.shape != (B, Tq, KVH, G) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 {(B, Tq, KVH, G)} "
                         f"tensor on {q.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    scale = scale if scale is not None else D ** -0.5
    fn = entry("flash_attention_bwd", "repro_flash_attention_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 _DTYPES[q.dtype], B, Tq, Tk, KVH, G, D, int(bool(causal)),
                 int(window is not None), int(window or 0),
                 int(prefix_len is not None), int(prefix_len or 0),
                 int(logit_cap is not None), float(logit_cap or 0.0),
                 float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: "
                           f"cudaError_t {err}")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


class FlashAttention(torch.autograd.Function):
    """Attention whose forward and backward are the hand-written kernels.

    ``apply(q, k, v, causal, window, prefix_len, logit_cap, scale)``; the
    forward keeps the row log-sum-exp for the backward, which recomputes
    the probabilities from it instead of storing the T x T matrix.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix_len, logit_cap, scale):
        B, Tq, KVH, G, _ = q.shape
        lse = torch.empty((B, Tq, KVH, G), dtype=torch.float32, device=q.device)
        out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                   prefix_len=prefix_len, logit_cap=logit_cap,
                                   scale=scale, lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window, prefix_len=prefix_len,
                      logit_cap=logit_cap, scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, dout.contiguous(),
                                              lse, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None
