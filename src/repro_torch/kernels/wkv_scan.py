"""RWKV-6 WKV recurrence on Hopper: the wrappers of ``csrc/wkv_scan.cu``
and ``csrc/wkv_scan_bwd.cu``.

The forward replaces the TPU kernel ``wkv_scan_pallas`` of the JAX package
(``kernels/wkv_scan.py``), in the model's layout, with the starting state
``s0`` and the final state ``s_T`` that serving needs.  The backward has no
Pallas counterpart: it replaces ``jax.grad`` through the JAX model's
``wkv_scan_ref``.  The plain versions are ``ref.reference_wkv`` and
``ref.reference_wkv_bwd``; ``ops.wkv_scan`` picks between kernel and plain
version by the tensors' device.  :class:`WKVScan` puts the kernels under
autograd: its forward also writes the state at the start of every
``CHUNK`` steps, from which the backward replays each chunk.
"""

from __future__ import annotations

import ctypes

import torch

from .build import entry

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
HEAD_SIZES = (16, 32, 64)      # K = V, one kernel instantiation each
CHUNK = 16                     # steps between checkpoints (both kernels' kChunk)


def _check(what: str, r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, u: torch.Tensor, **state: torch.Tensor | None) -> None:
    """Raise unless r, k, v, w are (B, T, H, K) with T >= 1 and K in
    ``HEAD_SIZES``, u is (H, K), each named state tensor (None: absent) has
    its shape, (B, H, K, K) or, for ``ckpt``, (B, H, ceil(T / CHUNK), K,
    K), and all are contiguous float32 on one CUDA device."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"want r = k = v = w (B,T,H,K); got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    B, T, H, K = r.shape
    want = {n: (B, H, -(-T // CHUNK), K, K) if n == "ckpt" else (B, H, K, K)
            for n in state}
    got = {n: tuple(t.shape) for n, t in state.items() if t is not None}
    if u.shape != (H, K) or any(got[n] != want[n] for n in got):
        raise ValueError(f"want u {(H, K)}, {want}; got {tuple(u.shape)}, {got}")
    if K not in HEAD_SIZES or T < 1:
        raise ValueError(f"{what} kernel takes head sizes {HEAD_SIZES} and "
                         f"T >= 1; got K={K}, T={T}")
    ins = [r, k, v, w, u] + [t for t in state.values() if t is not None]
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError(f"{what} takes float32 inputs; got {[t.dtype for t in ins]}")
    if not (r.is_cuda and all(t.device == r.device for t in ins)):
        raise ValueError(f"{what} kernel needs its inputs on one CUDA device")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError(f"{what} kernel needs contiguous inputs")


def wkv_scan_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                  ckpt: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on r's device and PyTorch's current stream.

    r, k, v, w: contiguous float32 (B, T, H, K) CUDA tensors, T >= 1 and
    K in ``HEAD_SIZES``; u: (H, K); s0: (B, H, K, K).  Returns (out
    (B, T, H, K), s_T (B, H, K, K)), float32.  With ``ckpt``, a contiguous
    float32 (B, H, ceil(T / CHUNK), K, K) tensor, the state at the start of
    every chunk is written there too (serving passes none).  Raises on
    anything else and when the launch is refused.
    ``wkv_scan_cuda.launches`` counts launches.
    """
    _check("wkv_scan", r, k, v, w, u, s0=s0, ckpt=ckpt)
    B, T, H, K = r.shape
    out = torch.empty_like(v)
    s_t = torch.empty_like(s0)
    fn = entry("wkv_scan", "repro_wkv_scan", _ARGTYPES)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), s0.data_ptr(), out.data_ptr(), s_t.data_ptr(),
                 None if ckpt is None else ckpt.data_ptr(), B, T, H, K, stream)
    if err != 0:
        raise RuntimeError(f"wkv_scan kernel launch failed: cudaError_t {err}")
    wkv_scan_cuda.launches += 1
    return out, s_t


wkv_scan_cuda.launches = 0


def wkv_scan_bwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      w: torch.Tensor, u: torch.Tensor, ckpt: torch.Tensor,
                      gy: torch.Tensor, gs_t: torch.Tensor | None = None, *,
                      want_gs0: bool = True) -> tuple[torch.Tensor | None, ...]:
    """Launch the backward kernel on r's device and PyTorch's current
    stream: one launch, a cluster of :func:`bwd_cluster` CTAs a (b, h).

    r, k, v, w, u as :func:`wkv_scan_cuda`; ``ckpt`` the states that the
    forward wrote; gy (B, T, H, K) the gradient of its output and ``gs_t``
    (B, H, K, K) that of its final state, or None (zeros).  Returns (gr, gk,
    gv, gw, gu, gs0), float32, gs0 None unless ``want_gs0``.  Besides the
    outputs it allocates a scratch of ``bwd_cluster(K) * B * H * K``
    floats (u's gradient before its sum over b) and ``H`` ints.  Raises on
    anything else and when the launch is refused.
    ``wkv_scan_bwd_cuda.launches`` counts calls.
    """
    if ckpt is None:
        raise ValueError("wkv_scan_bwd needs the states the forward wrote (ckpt)")
    _check("wkv_scan_bwd", r, k, v, w, u, ckpt=ckpt, gs_t=gs_t)
    _check("wkv_scan_bwd", gy, k, v, w, u)       # gy: r's shape, type and place
    B, T, H, K = r.shape
    gr, gk, gv, gw = (torch.empty_like(r) for _ in range(4))
    gu = torch.empty_like(u)
    gs0 = torch.empty((B, H, K, K), device=r.device) if want_gs0 else None
    gu_part = torch.empty((bwd_cluster(K), B, H, K), device=r.device)
    ticket = torch.empty((H,), dtype=torch.int32, device=r.device)
    fn = entry("wkv_scan_bwd", "repro_wkv_scan_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                 ckpt.data_ptr(), gy.data_ptr(),
                 None if gs_t is None else gs_t.data_ptr(), gr.data_ptr(),
                 gk.data_ptr(), gv.data_ptr(), gw.data_ptr(), gu.data_ptr(),
                 None if gs0 is None else gs0.data_ptr(), gu_part.data_ptr(),
                 ticket.data_ptr(), B, T, H, K, stream)
    if err != 0:
        raise RuntimeError(f"wkv_scan_bwd kernel launch failed: cudaError_t {err}")
    wkv_scan_bwd_cuda.launches += 1
    return gr, gk, gv, gw, gu, gs0


wkv_scan_bwd_cuda.launches = 0


def bwd_cluster(K: int) -> int:
    """The CTAs of a (b, h)'s cluster in the backward kernel at head size
    ``K`` in ``HEAD_SIZES``, as the built kernel reports it (its columns a
    CTA are its own choice): the first dimension of u's gradient scratch."""
    return entry("wkv_scan_bwd", "repro_wkv_scan_bwd_cluster", [ctypes.c_int])(K)


class WKVScan(torch.autograd.Function):
    """The kernels under autograd, through their dispatcher ops
    (``kernels/library.py``): ``apply(r, k, v, w, u, s0)`` returns ``(out,
    s_T)``.  The forward writes the per-chunk states and saves them with its
    inputs; the backward is the ``wkv_scan_bwd`` op, and computes s0's
    gradient only where it is asked for."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        B, T, H, K = r.shape
        ckpt = torch.empty((B, H, -(-T // CHUNK), K, K), device=r.device)
        out, s_t = torch.ops.repro_torch.wkv_scan(r, k, v, w, u, s0, ckpt)
        ctx.save_for_backward(r, k, v, w, u, ckpt)
        ctx.set_materialize_grads(False)      # an unread s_T's gradient stays None
        return out, s_t

    @staticmethod
    def backward(ctx, grad_out, grad_s):
        r, k, v, w, u, ckpt = ctx.saved_tensors
        gy = torch.zeros_like(r) if grad_out is None else grad_out.contiguous()
        gs_t = None if grad_s is None else grad_s.contiguous()
        want_gs0 = ctx.needs_input_grad[5]
        *grads, gs0 = torch.ops.repro_torch.wkv_scan_bwd(r, k, v, w, u, ckpt, gy, gs_t,
                                                         want_gs0)
        return (*grads, gs0 if want_gs0 else None)
