"""The hand-written kernels as dispatcher ops, ``torch.ops.repro_torch.*``.

Each kernel's launch is registered as an op with three implementations:
for CUDA tensors the wrapper that launches the kernel (``*_cuda``), for
CPU tensors the plain version (``ref.py``), and a fake for the meta device
that gives outputs of the right shapes and dtypes and reads no value.  Each
op also has its FLOP formula (``torch.utils.flop_counter``) and its byte
formula (``launch/cost_analysis.py``), so ``FlopCounterMode`` counts the same
work whether the op launches its kernel, runs its plain version or its fake.

The ops are defined with ``torch.library.Library`` and Python kernels, not
``torch.library.custom_op``: on the CPU of the build machine a call through
the dispatcher costs about 4 us over a direct call, where ``custom_op`` costs
about 20 us (and a ``TORCH_LIBRARY`` block would mean compiling against
PyTorch's headers, minutes a build).  ``ops.py`` routes meta and CUDA tensors
through these ops and CPU tensors to the plain versions directly; the
``autograd.Function`` of each kernel calls its forward and backward ops.

Each op also has a sharding rule for DTensor (:func:`register_shardings`,
called by the dry run's count of a sharded step): an op runs on the local
shards when its inputs are split on their batch dim, or on their head (or
channel) dim, on a mesh dimension, and else on replicated inputs.

Schemas mirror the C entry points: an output that the kernel writes only
when asked (the forward's row ``lse``, the WKV forward's per-chunk states) is
a mutable optional argument; an output it may skip (``gh0``, ``gs0``) comes
back empty when not asked for.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.launch import cost_analysis as CA
from . import ref
from .chunk_combine import chunk_combine_cuda
from .flash_attention import flash_attention_bwd_cuda, flash_attention_cuda
from .lru_scan import lru_scan_bwd_cuda, lru_scan_cuda
from .mla_decode import mla_decode_cuda
from .small_mm import small_mm_cuda
from .wkv_scan import CHUNK, wkv_scan_bwd_cuda, wkv_scan_cuda

NAMESPACE = "repro_torch"
LIB = torch.library.Library(NAMESPACE, "DEF")

SCHEMAS = {
    "flash_attention_fwd": (
        "flash_attention_fwd(Tensor q, Tensor k, Tensor v, Tensor(a!)? lse, bool causal, "
        "int? window, int? prefix_len, float? logit_cap, float? scale, int q_offset, "
        "int? k_valid_len) -> Tensor"),
    "flash_attention_bwd": (
        "flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor out, Tensor dout, "
        "Tensor lse, bool causal, int? window, int? prefix_len, float? logit_cap, "
        "float? scale) -> (Tensor, Tensor, Tensor)"),
    "chunk_combine": (
        "chunk_combine(Tensor local, Tensor recv, bool[] seg_mask, bool[] accumulate, "
        "Tensor(a!) out) -> ()"),
    "lru_scan": "lru_scan(Tensor a, Tensor x, Tensor h0) -> Tensor",
    "lru_scan_bwd": (
        "lru_scan_bwd(Tensor a, Tensor h, Tensor h0, Tensor gh, bool want_gh0) "
        "-> (Tensor, Tensor, Tensor)"),
    "wkv_scan": (
        "wkv_scan(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor s0, "
        "Tensor(a!)? ckpt) -> (Tensor, Tensor)"),
    "wkv_scan_bwd": (
        "wkv_scan_bwd(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor ckpt, "
        "Tensor gy, Tensor? gs_t, bool want_gs0) "
        "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)"),
    "small_mm": "small_mm(Tensor x, Tensor w) -> Tensor",
    "mla_decode": (
        "mla_decode(Tensor q_abs, Tensor q_pe, Tensor c_kv, Tensor k_pe, Tensor? index, "
        "int pos, float scale, Tensor(a!)? lse) -> Tensor"),
}


def _attn_kw(causal, window, prefix_len, logit_cap, scale, q_offset=0, k_valid_len=None):
    return dict(causal=causal, window=window, prefix_len=prefix_len, logit_cap=logit_cap,
                scale=scale, q_offset=q_offset, k_valid_len=k_valid_len)


def _empty(t: torch.Tensor) -> torch.Tensor:
    return t.new_empty((0,))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _flash_fwd_cuda(q, k, v, lse, causal, window, prefix_len, logit_cap, scale,
                    q_offset, k_valid_len):
    return flash_attention_cuda(q, k, v, lse=lse, **_attn_kw(
        causal, window, prefix_len, logit_cap, scale, q_offset, k_valid_len))


def _flash_fwd_cpu(q, k, v, lse, causal, window, prefix_len, logit_cap, scale,
                   q_offset, k_valid_len):
    kw = _attn_kw(causal, window, prefix_len, logit_cap, scale, q_offset, k_valid_len)
    if lse is not None:
        lse.copy_(ref.reference_attention_lse(q, k, **kw))
    return ref.reference_attention(q, k, v, **kw)


def _flash_fwd_fake(q, k, v, lse, causal, window, prefix_len, logit_cap, scale,
                    q_offset, k_valid_len):
    return q.new_empty(q.shape)


def _flash_fwd_cost(q, k, v, lse, causal, window, prefix_len, logit_cap, scale,
                    q_offset, k_valid_len):
    return CA.flash_fwd_cost(q.shape, k.shape, q.dtype, causal=causal, window=window,
                             prefix_len=prefix_len, q_offset=q_offset,
                             k_valid_len=k_valid_len, lse=lse is not None)


def _flash_bwd_cuda(q, k, v, out, dout, lse, causal, window, prefix_len, logit_cap, scale):
    return flash_attention_bwd_cuda(q, k, v, out, dout, lse, causal=causal, window=window,
                                    prefix_len=prefix_len, logit_cap=logit_cap, scale=scale)


def _flash_bwd_cpu(q, k, v, out, dout, lse, causal, window, prefix_len, logit_cap, scale):
    return ref.reference_attention_bwd(q, k, v, dout, causal=causal, window=window,
                                       prefix_len=prefix_len, logit_cap=logit_cap,
                                       scale=scale)


def _flash_bwd_fake(q, k, v, out, dout, lse, causal, window, prefix_len, logit_cap, scale):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _flash_bwd_cost(q, k, v, out, dout, lse, causal, window, prefix_len, logit_cap, scale):
    return CA.flash_bwd_cost(q.shape, k.shape, q.dtype, causal=causal, window=window,
                             prefix_len=prefix_len)


# ---------------------------------------------------------------------------
# chunk combine
# ---------------------------------------------------------------------------

def _combine_cuda(local, recv, seg_mask, accumulate, out):
    chunk_combine_cuda(local, recv, seg_mask, accumulate, out=out)


def _combine_cpu(local, recv, seg_mask, accumulate, out):
    out.copy_(ref.reference_chunk_combine(local, recv, seg_mask, accumulate))


def _combine_fake(local, recv, seg_mask, accumulate, out):
    return None


def _combine_cost(local, recv, seg_mask, accumulate, out):
    return CA.chunk_combine_cost(local.shape, local.dtype, seg_mask, accumulate,
                                 in_place=torch._C._is_alias_of(out, local))


# ---------------------------------------------------------------------------
# the scans
# ---------------------------------------------------------------------------

def _lru_fake(a, x, h0):
    return a.new_empty(a.shape, dtype=torch.float32)


def _lru_cost(a, x, h0):
    return CA.lru_scan_cost(*a.shape)


def _lru_bwd_cuda(a, h, h0, gh, want_gh0):
    gx, ga, gh0 = lru_scan_bwd_cuda(a, h, h0, gh, want_gh0=want_gh0)
    return gx, ga, gh0 if want_gh0 else _empty(h0)


def _lru_bwd_cpu(a, h, h0, gh, want_gh0):
    gx, ga, gh0 = ref.reference_lru_scan_bwd(a, h, h0, gh)
    return gx, ga, gh0 if want_gh0 else _empty(h0)


def _lru_bwd_fake(a, h, h0, gh, want_gh0):
    gh0 = h0.new_empty(h0.shape, dtype=torch.float32) if want_gh0 else _empty(h0)
    return (a.new_empty(a.shape, dtype=torch.float32),
            a.new_empty(a.shape, dtype=torch.float32), gh0)


def _lru_bwd_cost(a, h, h0, gh, want_gh0):
    return CA.lru_scan_bwd_cost(*a.shape, want_gh0=want_gh0)


def _wkv_cpu(r, k, v, w, u, s0, ckpt):
    """The plain recurrence, a chunk of ``CHUNK`` steps at a time when the
    per-chunk states are asked for."""
    if ckpt is None:
        return ref.reference_wkv(r, k, v, w, u, s0)
    T, outs, s = r.shape[1], [], s0
    for c, t0 in enumerate(range(0, T, CHUNK)):
        ckpt[:, :, c] = s
        sl = slice(t0, t0 + CHUNK)
        out, s = ref.reference_wkv(r[:, sl], k[:, sl], v[:, sl], w[:, sl], u, s)
        outs.append(out)
    return torch.cat(outs, dim=1), s


def _wkv_fake(r, k, v, w, u, s0, ckpt):
    return (v.new_empty(v.shape, dtype=torch.float32),
            s0.new_empty(s0.shape, dtype=torch.float32))


def _wkv_cost(r, k, v, w, u, s0, ckpt):
    return CA.wkv_scan_cost(*r.shape, ckpt=ckpt is not None, chunk=CHUNK)


def _wkv_bwd_cuda(r, k, v, w, u, ckpt, gy, gs_t, want_gs0):
    grads = wkv_scan_bwd_cuda(r, k, v, w, u, ckpt, gy, gs_t, want_gs0=want_gs0)
    return (*grads[:5], grads[5] if want_gs0 else _empty(r))


def _wkv_bwd_cpu(r, k, v, w, u, ckpt, gy, gs_t, want_gs0):
    grads = ref.reference_wkv_bwd(r, k, v, w, u, ckpt[:, :, 0], gy, gs_t)
    return (*grads[:5], grads[5] if want_gs0 else _empty(r))


def _wkv_bwd_fake(r, k, v, w, u, ckpt, gy, gs_t, want_gs0):
    B, T, H, K = r.shape
    f32 = dict(dtype=torch.float32)
    return (*(t.new_empty(t.shape, **f32) for t in (r, k, v, w, u)),
            r.new_empty((B, H, K, K), **f32) if want_gs0 else _empty(r))


def _wkv_bwd_cost(r, k, v, w, u, ckpt, gy, gs_t, want_gs0):
    return CA.wkv_scan_bwd_cost(*r.shape, gs_t=gs_t is not None, want_gs0=want_gs0)


# ---------------------------------------------------------------------------
# the small-row product
# ---------------------------------------------------------------------------

def _small_mm_fake(x, w):
    return w.new_empty((x.shape[0], x.shape[1], w.shape[2]), dtype=torch.float32)


def _small_mm_cost(x, w):
    return CA.small_mm_cost(x.shape, w.shape, x.dtype)


# ---------------------------------------------------------------------------
# MLA decode's attention core
# ---------------------------------------------------------------------------

def _mla_decode_cuda(q_abs, q_pe, c_kv, k_pe, index, pos, scale, lse):
    return mla_decode_cuda(q_abs, q_pe, c_kv, k_pe, index, pos, scale, lse=lse)


def _position(index, pos) -> int | None:
    """The position a call reads: ``pos``, or ``index``'s value (None on the
    meta device, which holds none)."""
    if index is None:
        return pos
    return None if index.device.type == "meta" else int(index)


def _mla_decode_cpu(q_abs, q_pe, c_kv, k_pe, index, pos, scale, lse):
    """The plain version; its context widened to float32, as the kernel
    gives it."""
    p = _position(index, pos)
    if lse is not None:
        s = (torch.einsum("bthr,bsr->bhts", q_abs, c_kv.float())
             + torch.einsum("bthk,bsk->bhts", q_pe, k_pe.float())) * scale
        valid = torch.arange(c_kv.shape[1], device=c_kv.device) <= p
        lse.copy_(torch.where(valid, s, -torch.inf).logsumexp(-1)[:, :, 0])
    return ref.reference_mla_decode(q_abs, q_pe, c_kv, k_pe, p, scale).float()


def _mla_decode_fake(q_abs, q_pe, c_kv, k_pe, index, pos, scale, lse):
    return q_abs.new_empty(q_abs.shape, dtype=torch.float32)


def _mla_decode_cost(q_abs, q_pe, c_kv, k_pe, index, pos, scale, lse):
    return CA.mla_decode_cost(q_abs.shape, k_pe.shape[-1], c_kv.shape[1],
                              _position(index, pos), c_kv.dtype, lse=lse is not None)


#: name -> (CUDA launch, CPU plain version, meta fake, cost)
OPS = {
    "flash_attention_fwd": (_flash_fwd_cuda, _flash_fwd_cpu, _flash_fwd_fake, _flash_fwd_cost),
    "flash_attention_bwd": (_flash_bwd_cuda, _flash_bwd_cpu, _flash_bwd_fake, _flash_bwd_cost),
    "chunk_combine": (_combine_cuda, _combine_cpu, _combine_fake, _combine_cost),
    "lru_scan": (lru_scan_cuda, ref.reference_lru_scan, _lru_fake, _lru_cost),
    "lru_scan_bwd": (_lru_bwd_cuda, _lru_bwd_cpu, _lru_bwd_fake, _lru_bwd_cost),
    "wkv_scan": (wkv_scan_cuda, _wkv_cpu, _wkv_fake, _wkv_cost),
    "wkv_scan_bwd": (_wkv_bwd_cuda, _wkv_bwd_cpu, _wkv_bwd_fake, _wkv_bwd_cost),
    "small_mm": (small_mm_cuda, ref.reference_small_mm, _small_mm_fake, _small_mm_cost),
    "mla_decode": (_mla_decode_cuda, _mla_decode_cpu, _mla_decode_fake, _mla_decode_cost),
}


def _flop_formula(cost):
    def flops(*args, out_val=None, **kwargs):
        return cost(*args, **kwargs).flops
    return flops


for _name, (_cuda, _cpu, _fake, _cost) in OPS.items():
    LIB.define(SCHEMAS[_name])
    LIB.impl(_name, _cuda, "CUDA")
    LIB.impl(_name, _cpu, "CPU")
    LIB.impl(_name, _fake, "Meta")
    CA.KERNEL_COSTS[_name] = _cost
    register_flop_formula(getattr(torch.ops.repro_torch, _name), get_raw=True)(
        _flop_formula(_cost))


# ---------------------------------------------------------------------------
# sharding rules (DTensor)
# ---------------------------------------------------------------------------

#: per op: each argument's (batch dim, head dim) -- None for an argument
#: that is not a tensor, a None dim where it has none -- and a function of
#: the arguments giving each output's.  A weight with no batch dim (``u``)
#: gets a ``Partial`` gradient when the batch is split; an output the call
#: does not ask for (an empty ``gh0``, ``gs0``) is replicated.
_ATTN, _SEQ, _STATE = (0, 2), (0, 2), (0, 1)
SHARD_DIMS = {
    "flash_attention_fwd": ([_ATTN] * 4 + [None] * 7, lambda *a: [_ATTN]),
    "flash_attention_bwd": ([_ATTN] * 6 + [None] * 5, lambda *a: [_ATTN] * 3),
    "lru_scan": ([_SEQ, _SEQ, _STATE], lambda *a: [_SEQ]),
    "lru_scan_bwd": ([_SEQ, _SEQ, _STATE, _SEQ, None],
                     lambda *a: [_SEQ, _SEQ, _STATE if a[4] else (None, None)]),
    "wkv_scan": ([_SEQ] * 4 + [(None, 0), _STATE, _STATE],
                 lambda *a: [_SEQ, _STATE]),
    "wkv_scan_bwd": ([_SEQ] * 4 + [(None, 0), _STATE, _SEQ, _STATE, None],
                     lambda *a: [_SEQ] * 4 + [("partial", 0),
                                              _STATE if a[8] else (None, None)]),
}


def _sharding_rule(arg_dims, out_dims):
    """A ``register_sharding`` function: all replicated, all split on the
    batch dim, or all split on the head dim."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    def placement(d):
        return Partial() if d == "partial" else Replicate() if d is None else Shard(d)

    def rule(*args):
        outs = out_dims(*args)
        tensor = [dims is not None and a is not None for a, dims in zip(args, arg_dims)]
        found = [([Replicate()] * len(outs),
                  [Replicate() if t else None for t in tensor])]
        for which in (0, 1):
            found.append(([placement(o[which]) for o in outs],
                          [placement(dims[which]) if t else None
                           for t, dims in zip(tensor, arg_dims)]))
        return found
    return rule


def register_shardings() -> None:
    """Give every op its sharding rule for DTensor (``SHARD_DIMS``); a
    second call changes nothing.  ``chunk_combine`` has none: it merges a
    rank's own buffers inside the explicit gradient programs.  Nor has
    ``small_mm`` or ``mla_decode``: the model routes only CUDA tensors (and
    CPU tensors inside ``ops.use("op")``) to them, and the sharded count's
    meta DTensors keep the plain versions."""
    from torch.distributed.tensor.experimental import register_sharding

    for name, (arg_dims, out_dims) in SHARD_DIMS.items():
        register_sharding(getattr(torch.ops.repro_torch, name).default)(
            _sharding_rule(arg_dims, out_dims))
