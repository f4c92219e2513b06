"""Flash attention on Hopper: the wrapper of ``csrc/flash_attention.cu``.

Replaces the TPU kernel ``flash_attention_pallas`` of the JAX package
(``kernels/flash_attention.py``).  The kernel's plain version is
``ref.reference_attention``; ``ops.flash_attention`` picks between them by
the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 13
             + [ctypes.c_float, ctypes.c_float]
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])
MAX_HEAD_DIM = 256
MAX_GROUP = 64          # query heads per KV head: one CTA holds them all


def _entry():
    fn = load_library("flash_attention").lib.repro_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


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
) -> torch.Tensor:
    """Launch the kernel on q's device and PyTorch's current stream.

    Raises on inputs the kernel does not take and when the launch is refused
    (``cudaGetLastError`` non-zero).  ``flash_attention_cuda.launches``
    counts launches.
    """
    _check(q, k, v)
    B, Tq, KVH, G, D = q.shape
    Tk = k.shape[1]
    out = torch.empty_like(q)
    scale = scale if scale is not None else D ** -0.5
    fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], B, Tq, Tk, KVH, G, D, int(bool(causal)),
                 int(window is not None), int(window or 0),
                 int(prefix_len is not None), int(prefix_len or 0),
                 int(logit_cap is not None), float(logit_cap or 0.0),
                 float(scale), int(q_offset),
                 int(k_valid_len is not None), int(k_valid_len or 0), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
