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
import dataclasses

import torch

from .build import entry

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 13
             + [ctypes.c_float, ctypes.c_float]
             + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 13
                 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
MAX_HEAD_DIM = 256
MAX_BWD_HEAD_DIM = 256  # above 128 the backward splits the columns over warp pairs
MAX_GROUP = 64          # query heads per KV head: one CTA holds them all
# the backward's work split (csrc/flash_attention_bwd.cu): keys per dK/dV
# CTA, query rows per dQ CTA, the largest cluster
BWD_KEYS, BWD_ROWS, BWD_MAX_SPLIT = 64, 64, 8
H100_SMS = 132


def fwd_tiles(D: int) -> tuple[int, int]:
    """(query rows per CTA, keys per K/V tile) of the forward kernel at
    head_dim D: its ``Tiles`` (16 rows a warp)."""
    return (128, 32) if D > 128 else (64, 64)


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """How the forward kernel walks one (batch, kv head).

    ``rows`` query rows per CTA (16 a warp, a row is ``t * G + g``),
    ``keys`` keys per K/V tile.  ``ctas``: (query tile, first key tile,
    classes) per CTA in launch order, where ``classes[i][w]`` is what warp
    ``w`` does with key tile ``first + i``: ``"skip"`` (none of its pairs
    visible: no products), ``"full"`` (all visible: no mask) or
    ``"masked"`` (the mask pair by pair).
    """
    rows: int
    keys: int
    ctas: tuple[tuple[int, int, tuple[tuple[str, ...], ...]], ...]


def fwd_plan(Tq: int, Tk: int, G: int, D: int, *, causal: bool = True,
             window: int | None = None, prefix_len: int | None = None,
             q_offset: int = 0, k_valid_len: int | None = None) -> FwdPlan:
    """The forward kernel's walk over the key tiles, computed as
    ``key_tiles`` and ``classify`` in ``csrc/flash_attention.cu`` compute
    it on the card (the CPU tests check that it meets every visible pair
    once and masks every hidden pair it meets)."""
    bm, bk = fwd_tiles(D)
    nr = Tq * G
    kend = min(Tk, k_valid_len) if k_valid_len is not None else Tk
    in_prefix = lambda key: prefix_len is not None and key < prefix_len

    def key_tiles(r0: int, r1: int) -> tuple[int, int]:
        qa, qb = q_offset + r0 // G, q_offset + (r1 - 1) // G
        khi = kend
        if causal:
            khi = min(khi, max(qb + 1, prefix_len or 0))
        klo = max(0, qa - window + 1) if window is not None else 0
        return klo // bk, (-(-khi // bk) if klo < khi else klo // bk)

    def classify(r0: int, r1: int, k0: int) -> str:
        if r0 >= r1:
            return "skip"
        qa, qb = q_offset + r0 // G, q_offset + (r1 - 1) // G
        kb = k0 + bk - 1
        if (k0 >= kend or (causal and k0 > qb and not in_prefix(k0))
                or (window is not None and qa - kb >= window)):
            return "skip"
        full = kb < kend
        if causal:
            full = full and (kb <= qa or in_prefix(kb))
        if window is not None:
            full = full and qb - k0 < window
        return "full" if full else "masked"

    nqt = -(-nr // bm)
    ctas = []
    for qt in (range(nqt - 1, -1, -1) if causal else range(nqt)):
        r0 = qt * bm
        lo, hi = key_tiles(r0, min(r0 + bm, nr))
        ctas.append((qt, lo, tuple(
            tuple(classify(w0, min(w0 + 16, nr), kt * bk)
                  for w0 in range(r0, r0 + bm, 16))
            for kt in range(lo, hi))))
    return FwdPlan(bm, bk, tuple(ctas))


def _bwd_tiles(D: int, dtype: torch.dtype) -> tuple[int, int, int]:
    """(query rows per dK/dV step, keys per dQ step, CTAs an SM): the
    kernel's ``Tiles``.  Above head_dim 128 a CTA's warps split the columns
    in two halves, and fp32 steps 16 keys in the dQ pass to fit shared
    memory."""
    br = 32 if D <= 64 or dtype == torch.bfloat16 else 16
    bkq = 16 if D > 128 and dtype == torch.float32 else 32
    return br, bkq, 3 if D <= 64 else 1


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How the backward kernel splits its work for one (batch, kv head).

    ``dkdv``: (key tile, cluster rank, first row, end row) per dK/dV CTA in
    launch order: the CTA sums keys [64 tile, 64 tile + 64) against query
    rows [first, end) (a row is ``t * G + g``).  ``dq``: (query tile,
    cluster rank, first key, end key) per dQ CTA in launch order, for rows
    [64 tile, 64 tile + 64).  A cluster's CTAs split one tile's range and
    sum their partial gradients in rank order.  Rows and keys past the
    tensors' ends, and pairs the mask hides, are masked in the kernel.
    """
    split_dkdv: int
    split_dq: int
    dkdv: tuple[tuple[int, int, int, int], ...]
    dq: tuple[tuple[int, int, int, int], ...]


def _split(total: int, most: int, minb: int, n_sm: int) -> int:
    s = 1
    while s < BWD_MAX_SPLIT and -(-most // s) * n_sm * minb > total:
        s *= 2
    return s


def _share(lo: int, hi: int, split: int) -> list[tuple[int, int]]:
    chunk = -(-(hi - lo) // split)
    out = []
    for rank in range(split):
        first = min(hi, lo + rank * chunk)
        out.append((first, min(hi, first + chunk)))
    return out


def bwd_plan(B: int, Tq: int, Tk: int, KVH: int, G: int, D: int, *,
             causal: bool = True, window: int | None = None,
             prefix_len: int | None = None, dtype: torch.dtype = torch.float32,
             n_sm: int = H100_SMS) -> BwdPlan:
    """The backward kernel's work split, computed as ``dkdv_tiles``,
    ``dq_tiles``, ``share`` and ``choose_split`` in
    ``csrc/flash_attention_bwd.cu`` compute it on the card (the CPU tests
    check that it covers every visible pair once)."""
    br, bkq, minb = _bwd_tiles(D, dtype)
    n_kt = -(-Tk // BWD_KEYS)
    nr = Tq * G
    n_qt = -(-nr // BWD_ROWS)

    def dkdv_tiles(kt: int) -> tuple[int, int]:
        k0 = kt * BWD_KEYS
        kmax = min(k0 + BWD_KEYS, Tk) - 1
        qlo, qhi = 0, Tq
        if causal and not (prefix_len is not None and k0 < prefix_len):
            qlo = k0
        if window is not None:
            qhi = min(qhi, kmax + window)
        if qlo >= qhi:
            return 0, 0
        return qlo * G // br, -(-qhi * G // br)

    def dq_tiles(qt: int) -> tuple[int, int]:
        r0, r1 = qt * BWD_ROWS, min(qt * BWD_ROWS + BWD_ROWS, nr)
        khi = Tk
        if causal:
            lim = (r1 - 1) // G + 1
            if prefix_len is not None:
                lim = max(lim, prefix_len)
            khi = min(khi, lim)
        klo = max(0, r0 // G - window + 1) if window is not None else 0
        return klo // bkq, (-(-khi // bkq) if klo < khi else klo // bkq)

    kv_spans = [dkdv_tiles(kt) for kt in range(n_kt)]
    split_kv = _split(sum(hi - lo for lo, hi in kv_spans) * B * KVH,
                      max(hi - lo for lo, hi in kv_spans), minb, n_sm)
    dkdv = tuple((kt, rank, first * br, end * br)
                 for kt, (lo, hi) in enumerate(kv_spans)
                 for rank, (first, end) in enumerate(_share(lo, hi, split_kv)))
    order = range(n_qt - 1, -1, -1) if causal else range(n_qt)
    q_spans = {qt: dq_tiles(qt) for qt in order}
    split_q = _split(sum(hi - lo for lo, hi in q_spans.values()) * B * KVH,
                     max(hi - lo for lo, hi in q_spans.values()), minb, n_sm)
    dq = tuple((qt, rank, first * bkq, end * bkq)
               for qt, (lo, hi) in q_spans.items()
               for rank, (first, end) in enumerate(_share(lo, hi, split_q)))
    return BwdPlan(split_kv, split_q, dkdv, dq)


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

    One call launches three kernels (delta = rowsum(dO * O), then dK/dV
    and dQ, each a cluster launch split as :func:`bwd_plan` says) and
    counts once in ``flash_attention_bwd_cuda.launches``.  Raises on inputs
    the kernel does not take (head_dim above 256) and when a
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
    """Attention whose forward and backward are the hand-written kernels,
    through their dispatcher ops (``kernels/library.py``: the kernels on the
    card, the fakes on the meta device, the plain versions on the CPU).

    ``apply(q, k, v, causal, window, prefix_len, logit_cap, scale)``; the
    forward keeps the row log-sum-exp for the backward, which recomputes
    the probabilities from it instead of storing the T x T matrix.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix_len, logit_cap, scale):
        B, Tq, KVH, G, _ = q.shape
        lse = torch.empty((B, Tq, KVH, G), dtype=torch.float32, device=q.device)
        out = torch.ops.repro_torch.flash_attention_fwd(
            q, k, v, lse, causal, window, prefix_len, logit_cap, scale, 0, None)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = (causal, window, prefix_len, logit_cap, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(
            q, k, v, out, dout.contiguous(), lse, *ctx.kw)
        return dq, dk, dv, None, None, None, None, None
