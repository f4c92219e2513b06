"""RWKV-6 WKV recurrence on Hopper: the wrapper of ``csrc/wkv_scan.cu``.

Replaces the TPU kernel ``wkv_scan_pallas`` of the JAX package
(``kernels/wkv_scan.py``), in the model's layout, with the starting state
``s0`` and the final state ``s_T`` that serving needs.  The kernel's plain
version is ``ref.reference_wkv``; ``ops.wkv_scan`` picks between them by
the tensors' device.  :class:`WKVScan` puts the kernel under autograd with
a backward that raises (ROADMAP.md, queue 2, "Backward kernels with no
Pallas counterpart").
"""

from __future__ import annotations

import ctypes

import torch

from .build import entry

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
HEAD_SIZES = (16, 32, 64)      # K = V, one kernel instantiation each


def wkv_scan_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on r's device and PyTorch's current stream.

    r, k, v, w: contiguous float32 (B, T, H, K) CUDA tensors, T >= 1 and
    K in ``HEAD_SIZES``; u: (H, K); s0: (B, H, K, K).  Returns (out
    (B, T, H, K), s_T (B, H, K, K)), float32.  Raises on anything else and
    when the launch is refused.  ``wkv_scan_cuda.launches`` counts launches.
    """
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"want r = k = v = w (B,T,H,K); got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    B, T, H, K = r.shape
    if u.shape != (H, K) or s0.shape != (B, H, K, K):
        raise ValueError(f"want u {(H, K)}, s0 {(B, H, K, K)}; got "
                         f"{tuple(u.shape)}, {tuple(s0.shape)}")
    if K not in HEAD_SIZES or T < 1:
        raise ValueError(f"wkv_scan kernel takes head sizes {HEAD_SIZES} and "
                         f"T >= 1; got K={K}, T={T}")
    ins = (r, k, v, w, u, s0)
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError(f"wkv_scan takes float32 inputs; got {[t.dtype for t in ins]}")
    if not (r.is_cuda and all(t.device == r.device for t in ins)):
        raise ValueError("wkv_scan kernel needs its inputs on one CUDA device")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("wkv_scan kernel needs contiguous inputs")
    out = torch.empty_like(v)
    s_t = torch.empty_like(s0)
    fn = entry("wkv_scan", "repro_wkv_scan", _ARGTYPES)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), s0.data_ptr(), out.data_ptr(), s_t.data_ptr(),
                 B, T, H, K, stream)
    if err != 0:
        raise RuntimeError(f"wkv_scan kernel launch failed: cudaError_t {err}")
    wkv_scan_cuda.launches += 1
    return out, s_t


wkv_scan_cuda.launches = 0


class WKVScan(torch.autograd.Function):
    """The kernel under autograd: ``apply(r, k, v, w, u, s0)`` returns
    ``(out, s_T)``.  Its backward raises, so that a training step on the
    card fails where it needs a backward kernel."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        return wkv_scan_cuda(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, grad_out, grad_s):
        raise NotImplementedError(
            "wkv_scan has no backward kernel: the recurrent families are "
            "served, not trained, on the card (ROADMAP.md, queue 2, 'Backward "
            "kernels with no Pallas counterpart')")
