"""Float32 products at few rows on Hopper: the wrapper of ``csrc/small_mm.cu``.

Replaces no TPU kernel: it takes from cuBLAS the float32 products a decode
step makes at 1-16 rows, ``y[g] = x[g] @ w[g]`` with w stored (K, N),
which are bound by the weights' bytes.  The plain version is
``ref.reference_small_mm``; ``ops.small_mm`` picks between them by the
tensors' device.  :func:`fits` is the rule ``ops.mm``, the models' one
product, routes a product on the card by; :func:`plan` chooses the
kernel's tile and K split.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .build import entry

#: the most rows a product may have to take the kernel (its largest template)
MAX_ROWS = 16
#: columns a CTA, widest first; K split over a cluster of this many CTAs
WIDTHS = (128, 64, 32)
SPLITS = (1, 2, 4, 8, 16)
#: as ``csrc/small_mm.cu``: threads a CTA, rows a thread takes a step
THREADS, UNROLL = 256, 4

_XDTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_void_p])


def fits(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the product ``x @ w`` (``w`` (K, N)), or ``x[g] @ w[g]``
    (``w`` (G, K, N), x (G, ..., K)), is one the kernel takes, whatever the
    device: w float32 and x float32 or bfloat16 (promoted, float32), at
    most ``MAX_ROWS`` rows a batch entry, w row-major with N contiguous,
    on the 16-byte grid with N and its strides multiples of 4 floats, K a
    multiple of 8 (x's rows whole 16-byte copies), and no gradient
    wanted."""
    if w.dtype != torch.float32 or x.dtype not in _XDTYPES or w.dim() not in (2, 3):
        return False
    if x.dim() < w.dim() or x.shape[-1] != w.shape[-2]:
        return False
    if w.dim() == 3 and x.shape[0] != w.shape[0]:
        return False
    K, N = w.shape[-2:]
    rows = math.prod(x.shape[:-1] if w.dim() == 2 else x.shape[1:-1])
    if not (1 <= rows <= MAX_ROWS and K >= 8 and K % 8 == 0 and N >= 4 and N % 4 == 0):
        return False
    ld = w.stride(-2)
    if w.stride(-1) != 1 or ld < N or ld % 4 or (w.dim() == 3 and w.stride(0) % 4):
        return False
    if w.device.type != "meta" and w.data_ptr() % 16:
        return False
    return not (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad))


@functools.lru_cache(maxsize=None)
def plan(G: int, K: int, N: int, n_sm: int = 132) -> tuple[int, int]:
    """(bn, split): the kernel's columns a CTA and CTAs along K for a
    product of G batch entries of (K, N) weights on ``n_sm`` SMs.  The
    widest tile first, split the fewest ways that gives at least ``n_sm //
    2`` CTAs, each CTA of a split at least two steps of rows (``THREADS *
    UNROLL / (bn / 4)`` a step); failing that, the narrower tiles likewise,
    and failing all, the most CTAs.  Timed against every other choice at
    the serving cells' decode shapes (``launch/sweep_small_mm.py``, an
    H100), it gave a decode step's products within 1.5-7% of the best
    choice per product, at 1-16 rows."""
    most = None
    for bn in WIDTHS:
        step_rows = THREADS * UNROLL * 4 // bn
        for split in SPLITS:
            if split > 1 and -(-K // split) < 2 * step_rows:
                break
            ctas = -(-N // bn) * split * G
            if ctas >= n_sm // 2:
                return bn, split
            if most is None or ctas > most[0]:
                most = (ctas, bn, split)
    return most[1], most[2]


def x_aligned(x: torch.Tensor) -> bool:
    """Whether the kernel reads (G, M, K) x as it lies: its last dim
    contiguous, its base and its two other strides on the 16-byte grid."""
    size = x.element_size()
    return (x.stride(2) == 1 and x.data_ptr() % 16 == 0
            and x.stride(0) * size % 16 == 0 and x.stride(1) * size % 16 == 0)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def small_mm_cuda(x: torch.Tensor, w: torch.Tensor, *, bn: int | None = None,
                  split: int | None = None) -> torch.Tensor:
    """Launch the kernel on w's device and PyTorch's current stream.

    x: (G, M, K) float32 or bfloat16, 1 <= M <= ``MAX_ROWS``, its last dim
    contiguous, its rows on the 16-byte grid (any batch stride, 0
    included); w: (G, K, N) float32, its last dim contiguous, N, its row
    stride and batch stride multiples of 4, on the 16-byte grid; K a
    multiple of 8.  Returns y (G, M, N) float32, contiguous.  ``bn`` and
    ``split`` override :func:`plan` (for a sweep).  Raises on anything else
    and when the launch is refused.  ``small_mm_cuda.launches`` counts
    launches.
    """
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"want x (G, M, K), w (G, K, N); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if x.dtype not in _XDTYPES or w.dtype != torch.float32:
        raise TypeError(f"small_mm takes float32 or bfloat16 x and float32 w; got "
                        f"{x.dtype}, {w.dtype}")
    if not (w.is_cuda and x.device == w.device):
        raise ValueError(f"small_mm kernel needs x, w on one CUDA device; got {x.device}, "
                         f"{w.device}")
    G, M, K = x.shape
    N = w.shape[2]
    if not 1 <= M <= MAX_ROWS:
        raise ValueError(f"small_mm kernel takes 1..{MAX_ROWS} rows, got {M}")
    if K < 8 or K % 8 or N < 4 or N % 4:
        raise ValueError(f"small_mm kernel needs K a multiple of 8 and N a multiple of 4; "
                         f"got K {K}, N {N}")
    if not x_aligned(x):
        raise ValueError("small_mm kernel needs x's last dim contiguous and its rows on the "
                         "16-byte grid")
    swg, ldw, one = w.stride()
    if one != 1 or ldw < N or ldw % 4 or swg % 4 or w.data_ptr() % 16:
        raise ValueError(f"small_mm kernel needs w row-major with N contiguous, its strides "
                         f"multiples of 4 and w on the 16-byte grid; got strides "
                         f"{w.stride()}")
    index = w.device.index if w.device.index is not None else torch.cuda.current_device()
    if bn is None or split is None:
        bn, split = plan(G, K, N, _sms(index))
    y = torch.empty((G, M, N), dtype=torch.float32, device=w.device)
    fn = entry("small_mm", "repro_small_mm", _ARGTYPES)
    args = (x.data_ptr(), w.data_ptr(), y.data_ptr(), x.stride(0), x.stride(1), swg, ldw,
            G, M, K, N, _XDTYPES[x.dtype], bn, split)
    if index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"small_mm kernel launch failed: cudaError_t {err}")
    small_mm_cuda.launches += 1
    return y


small_mm_cuda.launches = 0
