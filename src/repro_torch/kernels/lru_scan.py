"""RG-LRU scan on Hopper: the wrappers of ``csrc/lru_scan.cu`` and
``csrc/lru_scan_bwd.cu``.

The forward replaces the TPU kernel ``lru_scan_pallas`` of the JAX package
(``kernels/lru_scan.py``), with the starting state ``h0`` the model passes.
The backward has no Pallas counterpart: it replaces ``jax.grad`` through the
JAX model's ``lru_scan_ref``.  The plain versions are
``ref.reference_lru_scan`` and ``ref.reference_lru_scan_bwd``;
``ops.lru_scan`` picks between kernel and plain version by the tensors'
device.  :class:`LRUScan` puts the kernels under autograd.
:func:`lru_scan_tiled` is the forward kernel's tiled walk in plain torch,
for the CPU tests.
"""

from __future__ import annotations

import ctypes

import torch

from .build import entry

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
# the kernel's walk (csrc/lru_scan.cu): time steps a tile, warps a CTA
TILE, WARPS = 128, 8


def lru_scan_cuda(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a's device and PyTorch's current stream.

    a, x: contiguous float32 (B, T, W) CUDA tensors, T >= 1; h0: contiguous
    float32 (B, W).  Returns the (B, T, W) float32 states.  Raises on
    anything else and when the launch is refused.
    ``lru_scan_cuda.launches`` counts launches.
    """
    if a.dim() != 3 or x.shape != a.shape or h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"want a = x (B,T,W), h0 (B,W); got {tuple(a.shape)}, "
                         f"{tuple(x.shape)}, {tuple(h0.shape)}")
    if any(t.dtype != torch.float32 for t in (a, x, h0)):
        raise TypeError(f"lru_scan takes float32 a, x, h0; got {a.dtype}, "
                        f"{x.dtype}, {h0.dtype}")
    if not (a.is_cuda and x.device == a.device and h0.device == a.device):
        raise ValueError("lru_scan kernel needs a, x, h0 on one CUDA device; got "
                         f"{a.device}, {x.device}, {h0.device}")
    if not (a.is_contiguous() and x.is_contiguous() and h0.is_contiguous()):
        raise ValueError("lru_scan kernel needs contiguous a, x, h0")
    B, T, W = a.shape
    if T < 1:
        raise ValueError("lru_scan kernel needs at least one time step")
    out = torch.empty_like(a)
    fn = entry("lru_scan", "repro_lru_scan", _ARGTYPES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), x.data_ptr(), h0.data_ptr(), out.data_ptr(),
                 B, T, W, stream)
    if err != 0:
        raise RuntimeError(f"lru_scan kernel launch failed: cudaError_t {err}")
    lru_scan_cuda.launches += 1
    return out


lru_scan_cuda.launches = 0


def lru_scan_tiled(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor, *,
                   tile: int = TILE, warps: int = WARPS) -> torch.Tensor:
    """The kernel's arithmetic in plain torch, on any device: T in tiles of
    ``tile`` steps padded with a = 1 and x = 0, each tile split into
    ``warps`` sub-chunks of ``tile // warps`` steps.  A sub-chunk is scanned
    from zero into the pair (A, X); sub-chunk j starts from the tile's
    carry-in with the pairs of sub-chunks 0 .. j - 1 folded on in that
    order; each sub-chunk's recurrence is run again from its start, and the
    last sub-chunk's last h carries into the next tile.  The kernel fuses
    each multiply-add; this adds after rounding the product.  On no path:
    the CPU tests check the design's numerics with it.

    a, x: (B, T, W); h0: (B, W).  Returns (B, T, W) float32.
    """
    if tile % warps:
        raise ValueError(f"tile {tile} is not a multiple of warps {warps}")
    B, T, W = a.shape
    sub, tiles = tile // warps, -(-T // tile)
    pad = tiles * tile - T
    af = torch.cat([a.float(), a.new_ones(B, pad, W, dtype=torch.float32)], 1)
    xf = torch.cat([x.float(), x.new_zeros(B, pad, W, dtype=torch.float32)], 1)
    af, xf = (t.view(B, tiles, warps, sub, W) for t in (af, xf))
    out = torch.empty_like(af)
    carry = h0.float()
    for k in range(tiles):
        ak, xk = af[:, k], xf[:, k]                  # (B, warps, sub, W)
        A, X = ak[:, :, 0], xk[:, :, 0]
        for i in range(1, sub):
            X = ak[:, :, i] * X + xk[:, :, i]
            A = A * ak[:, :, i]
        starts = [carry]
        for j in range(warps - 1):
            starts.append(A[:, j] * starts[-1] + X[:, j])
        h = torch.stack(starts, 1)                   # (B, warps, W)
        for i in range(sub):
            h = ak[:, :, i] * h + xk[:, :, i]
            out[:, k, :, i] = h
        carry = h[:, -1]
    return out.view(B, tiles * tile, W)[:, :T]


def lru_scan_bwd_cuda(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor,
                      gh: torch.Tensor, *, want_gh0: bool = True
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Launch the backward kernel on a's device and PyTorch's current stream.

    a, h (the forward's output), gh (the gradient of h): contiguous float32
    (B, T, W) CUDA tensors, T >= 1; h0: contiguous float32 (B, W).  Returns
    (gx, ga, gh0), gh0 None unless ``want_gh0``.  Raises on anything else
    and when the launch is refused.  ``lru_scan_bwd_cuda.launches`` counts
    launches.
    """
    ins = (a, h, gh)
    if a.dim() != 3 or any(t.shape != a.shape for t in ins) \
            or h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"want a = h = gh (B,T,W), h0 (B,W); got "
                         f"{[tuple(t.shape) for t in (*ins, h0)]}")
    if any(t.dtype != torch.float32 for t in (*ins, h0)):
        raise TypeError(f"lru_scan_bwd takes float32 inputs; got "
                        f"{[t.dtype for t in (*ins, h0)]}")
    if not (a.is_cuda and all(t.device == a.device for t in (*ins, h0))):
        raise ValueError("lru_scan_bwd kernel needs its inputs on one CUDA device")
    if not all(t.is_contiguous() for t in (*ins, h0)):
        raise ValueError("lru_scan_bwd kernel needs contiguous inputs")
    B, T, W = a.shape
    if T < 1:
        raise ValueError("lru_scan_bwd kernel needs at least one time step")
    gx, ga = torch.empty_like(a), torch.empty_like(a)
    gh0 = torch.empty_like(h0) if want_gh0 else None
    fn = entry("lru_scan_bwd", "repro_lru_scan_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), h.data_ptr(), h0.data_ptr(), gh.data_ptr(),
                 gx.data_ptr(), ga.data_ptr(), gh0.data_ptr() if want_gh0 else None,
                 B, T, W, stream)
    if err != 0:
        raise RuntimeError(f"lru_scan_bwd kernel launch failed: cudaError_t {err}")
    lru_scan_bwd_cuda.launches += 1
    return gx, ga, gh0


lru_scan_bwd_cuda.launches = 0


class LRUScan(torch.autograd.Function):
    """The kernels under autograd, through their dispatcher ops
    (``kernels/library.py``): ``apply(a, x, h0)``.  The forward saves a, h0
    and its output; the backward is the ``lru_scan_bwd`` op, and computes
    h0's gradient only where it is asked for."""

    @staticmethod
    def forward(ctx, a, x, h0):
        h = torch.ops.repro_torch.lru_scan(a, x, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, grad):
        a, h, h0 = ctx.saved_tensors
        want_gh0 = ctx.needs_input_grad[2]
        gx, ga, gh0 = torch.ops.repro_torch.lru_scan_bwd(a, h, h0, grad.contiguous(),
                                                         want_gh0)
        return ga, gx, gh0 if want_gh0 else None
