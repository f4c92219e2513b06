"""R2CCL chunk combine on Hopper: the wrapper of ``csrc/chunk_combine.cu``.

Replaces the TPU kernel ``chunk_combine_pallas`` of the JAX package
(``kernels/chunk_combine.py``), the stage-2 merge of R2CCL-AllReduce.  The
kernel's plain version is ``ref.reference_chunk_combine``;
``ops.chunk_combine`` picks between them by the tensors' device.

The wrapper runs once per merge, 66-132 times a training step, and an
event-timed loop of launches counts the first call's host time, so its
host work is kept small: masks go to the kernel as Python ``bytes`` (no
numpy round trip for the lists the collectives pass), the device context is
entered only when the tensors are not on the current device, and each
tensor's byte span is taken once for the overlap checks.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .build import entry

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_char_p] * 2
             + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])
MAX_CHUNKS = 1024       # rows whose (seg, acc) bits fit the kernel's parameters


def _mask(m, C: int, name: str) -> bytes:
    """(C,) host bytes, 0 or 1, from a bool / int sequence, array or tensor
    (a CUDA tensor is copied to the host, which waits for the card)."""
    if isinstance(m, (list, tuple)):
        b = bytes(map(bool, m))
        if len(b) != C:
            raise ValueError(f"{name} must have shape ({C},), got ({len(b)},)")
        return b
    if isinstance(m, torch.Tensor):
        m = m.detach().cpu().numpy()
    a = np.asarray(m).astype(bool)
    if a.shape != (C,):
        raise ValueError(f"{name} must have shape ({C},), got {a.shape}")
    return a.astype(np.uint8).tobytes()


def _span(t: torch.Tensor) -> tuple[int, int]:
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


def _overlap(a: tuple[int, int], b: tuple[int, int]) -> bool:
    return a[0] < b[1] and b[0] < a[1]


def chunk_combine_cuda(local: torch.Tensor, recv: torch.Tensor, seg_mask,
                       accumulate, *, out: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Launch the kernel on local's device and PyTorch's current stream.

    ``local``, ``recv`` (and ``out``): contiguous (C, M) CUDA tensors of one
    dtype, float32 or bfloat16; ``out`` may be ``local`` itself (in place)
    and is a new tensor when not given.  ``seg_mask``, ``accumulate``: (C,)
    bools on the host.  Raises on anything else and when the launch is
    refused.  ``chunk_combine_cuda.launches`` counts launches.
    """
    if local.dim() != 2 or recv.shape != local.shape:
        raise ValueError(f"want local = recv (C, M); got {tuple(local.shape)}, "
                         f"{tuple(recv.shape)}")
    if local.dtype not in _DTYPES or recv.dtype != local.dtype:
        raise TypeError(f"chunk_combine takes float32 or bfloat16 local, recv "
                        f"of one dtype; got {local.dtype}, {recv.dtype}")
    if not (local.is_cuda and recv.device == local.device):
        raise ValueError("chunk_combine kernel needs local, recv on one CUDA "
                         f"device; got {local.device}, {recv.device}")
    if not (local.is_contiguous() and recv.is_contiguous()):
        raise ValueError("chunk_combine kernel needs contiguous local, recv")
    C, M = local.shape
    if not 1 <= C <= MAX_CHUNKS:
        raise ValueError(f"chunk_combine kernel takes 1..{MAX_CHUNKS} rows, got {C}")
    if out is None:
        out = torch.empty_like(local)
    elif (out.shape != local.shape or out.dtype != local.dtype
          or out.device != local.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous tensor like local")
    out_span, local_span = _span(out), _span(local)
    if out_span[0] != local_span[0] and _overlap(out_span, local_span):
        raise ValueError("out must be local itself or not overlap it")
    if _overlap(out_span, _span(recv)):
        raise ValueError("out must not overlap recv")
    seg = _mask(seg_mask, C, "seg_mask")
    acc = _mask(accumulate, C, "accumulate")
    fn = entry("chunk_combine", "repro_chunk_combine", _ARGTYPES)
    args = (local_span[0], recv.data_ptr(), out_span[0], seg, acc,
            _DTYPES[local.dtype], C, M)
    if local.device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(local.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"chunk_combine kernel launch failed: cudaError_t {err}")
    chunk_combine_cuda.launches += 1
    return out


chunk_combine_cuda.launches = 0
