"""MLA decode's attention over the latent cache on Hopper: the wrapper of
``csrc/mla_decode.cu``.

Replaces no TPU kernel: the JAX package computes MLA's absorbed decode in
jnp, and the port computed it in plain PyTorch over every slot of the
cache.  The kernel computes the same core, ``softmax(scale * (q_abs c_kv^T
+ q_pe k_pe^T)) c_kv`` over the live slots, reading the cache's position
from the device.  The plain version is ``ref.reference_mla_decode``;
``ops.mla_decode`` picks between them by the call's device and
:func:`fits`.  :func:`splits` sizes the kernel's split of the cache.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import entry

#: the latent and rotary widths the kernel is built for (DeepSeek-V2 / V3's
#: kv_lora_rank and qk_rope_head_dim)
RANK, ROPE = 512, 64
#: as ``csrc/mla_decode.cu``: heads a CTA, slots a cache tile
HEADS_PER_CTA, SLOTS_PER_TILE = 32, 32

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_float,
                                                               ctypes.c_void_p])


def _rows_contiguous(c: torch.Tensor, width: int) -> bool:
    """A (B, S, width) cache whose slots are contiguous rows on the 16-byte
    grid, at any batch stride on that grid."""
    size = c.element_size()
    return (c.stride(2) == 1 and c.stride(1) == width and c.stride(0) * size % 16 == 0
            and (c.device.type == "meta" or c.data_ptr() % 16 == 0))


def fits(q_abs: torch.Tensor, q_pe: torch.Tensor, c_kv: torch.Tensor,
         k_pe: torch.Tensor) -> bool:
    """Whether the kernel takes a decode call, whatever the device: q_abs
    (B, 1, H, 512) and q_pe (B, 1, H, 64) float32; c_kv (B, S, 512) and
    k_pe (B, S, 64) of one dtype, float32 or bfloat16, their slots
    contiguous rows on the 16-byte grid; and no gradient wanted."""
    if q_abs.dim() != 4 or q_pe.dim() != 4 or c_kv.dim() != 3 or k_pe.dim() != 3:
        return False
    B, T, H, R = q_abs.shape
    if T != 1 or R != RANK or tuple(q_pe.shape) != (B, 1, H, ROPE):
        return False
    if c_kv.shape[0] != B or tuple(k_pe.shape) != (B, c_kv.shape[1], ROPE) \
            or c_kv.shape[2] != RANK:
        return False
    if q_abs.dtype != torch.float32 or q_pe.dtype != torch.float32:
        return False
    if c_kv.dtype not in _DTYPES or k_pe.dtype != c_kv.dtype:
        return False
    if not (_rows_contiguous(c_kv, RANK) and _rows_contiguous(k_pe, ROPE)):
        return False
    return not (torch.is_grad_enabled()
                and any(t.requires_grad for t in (q_abs, q_pe, c_kv, k_pe)))


@functools.lru_cache(maxsize=None)
def splits(B: int, H: int, S: int, n_sm: int = 132) -> int:
    """The splits of the cache a call of ``B`` rows and ``H`` heads over
    ``S`` slots takes: as many as fill ``n_sm`` SMs with one CTA each
    (``ceil(H / 32)`` CTAs a row and split), at least 1, at most the tiles of
    32 slots in ``S``.  The kernel deals the live tiles evenly over them."""
    ctas = B * -(-H // HEADS_PER_CTA)
    return max(1, min(-(-S // SLOTS_PER_TILE), n_sm // ctas))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def mla_decode_cuda(q_abs: torch.Tensor, q_pe: torch.Tensor, c_kv: torch.Tensor,
                    k_pe: torch.Tensor, index: torch.Tensor | None, pos: int,
                    scale: float, *, lse: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel and its merge of the splits on the cache's device
    and PyTorch's current stream.

    q_abs (B, 1, H, 512), q_pe (B, 1, H, 64) float32 (copied if not
    contiguous); c_kv (B, S, 512), k_pe (B, S, 64), float32 or bfloat16,
    as :func:`fits` takes them.  The slots ``s <= pos`` are live (all of
    them once ``pos >= S``), ``pos`` read from ``index`` (an int64 of one
    element on the device, read by the kernel) or else from ``pos``.
    Returns ctx (B, 1, H, 512) float32; writes each (row, head)'s
    log-sum-exp of the scaled scores into ``lse`` ((B, H) float32) if
    given.  Raises on anything else and when a launch is refused.
    ``mla_decode_cuda.launches`` counts calls (each launches the attention
    kernel and the merge).
    """
    if not (q_abs.is_cuda and all(t.device == q_abs.device for t in (q_pe, c_kv, k_pe))):
        raise ValueError(f"mla_decode kernel needs every tensor on one CUDA device; got "
                         f"{q_abs.device}, {q_pe.device}, {c_kv.device}, {k_pe.device}")
    if not fits(q_abs, q_pe, c_kv, k_pe):
        raise ValueError(
            f"mla_decode kernel takes q_abs (B, 1, H, {RANK}), q_pe (B, 1, H, {ROPE}) float32 "
            f"and c_kv (B, S, {RANK}), k_pe (B, S, {ROPE}) of one dtype, float32 or bfloat16, "
            f"slots contiguous rows on the 16-byte grid, no grad; got "
            f"{tuple(q_abs.shape)} {q_abs.dtype}, {tuple(q_pe.shape)} {q_pe.dtype}, "
            f"{tuple(c_kv.shape)} {c_kv.dtype} strides {c_kv.stride()}, "
            f"{tuple(k_pe.shape)} {k_pe.dtype} strides {k_pe.stride()}")
    if index is not None and not (index.device == q_abs.device and index.dtype == torch.int64
                                  and index.numel() == 1):
        raise ValueError(f"mla_decode kernel reads its position from one int64 on the "
                         f"device; got {index.dtype} {tuple(index.shape)} on {index.device}")
    B, _, H, _ = q_abs.shape
    S = c_kv.shape[1]
    if lse is not None and not (lse.shape == (B, H) and lse.dtype == torch.float32
                                and lse.is_contiguous() and lse.device == q_abs.device):
        raise ValueError(f"lse must be a contiguous ({B}, {H}) float32 on the device")
    dev = q_abs.device
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    nsplit = splits(B, H, S, _sms(idx))
    qa, qp = q_abs.contiguous(), q_pe.contiguous()
    out = torch.empty((B, 1, H, RANK), dtype=torch.float32, device=dev)
    o_part = torch.empty((B, H, nsplit, RANK), dtype=torch.float32, device=dev)
    ml_part = torch.empty((B, H, nsplit, 2), dtype=torch.float32, device=dev)
    fn = entry("mla_decode", "repro_mla_decode", _ARGTYPES)
    args = (qa.data_ptr(), qp.data_ptr(), c_kv.data_ptr(), k_pe.data_ptr(),
            None if index is None else index.data_ptr(), int(pos), o_part.data_ptr(),
            ml_part.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
            _DTYPES[c_kv.dtype], B, H, S, c_kv.stride(0), k_pe.stride(0), nsplit, float(scale))
    if idx == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(idx):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mla_decode kernel launch failed: cudaError_t {err}")
    mla_decode_cuda.launches += 1
    return out


mla_decode_cuda.launches = 0
