"""What a step costs on an H100: the card's peaks, the roofline terms, the
wire bytes of a collective program, and one FLOP and one byte formula for
each hand-written kernel.

The port of the JAX package's ``launch/hlo_analysis.py``.  There is no HLO
to parse: the port runs eagerly, so its costs are counted as the step runs
(on the meta device for a dry run, on the card to check it) by a
``TorchDispatchMode`` that sees every op, :class:`CostCounter`, beside
``torch.utils.flop_counter.FlopCounterMode``.  Every kernel of
``kernels/`` is a dispatcher op (``kernels/library.py``) whose FLOP formula,
registered with ``register_flop_formula``, is the one here; so the same
formula counts the same work whether the op runs its kernel on the card, its
plain version on the CPU or its fake on the meta device.  The collective
traffic that ``parse_collectives`` read from the HLO is counted from the
port's own schedule IR (:func:`program_wire_bytes`): the program that
``core/collectives.py`` runs.

The formulas count what the function needs, not what a kernel does: each
input read once and each output written once, and for attention the
products of the (query, key) pairs its mask leaves visible, counted in
closed form (:func:`visible_pairs`).  They are the formulas behind
``PERF.md``'s "bound ms" column and ``chip_smoke.py``'s bounds.
"""

from __future__ import annotations

import dataclasses
import math
from collections import Counter
from typing import Mapping

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One device's peaks.  ``peak_flops`` by op class: ``bf16`` (tensor
    cores), ``tf32``, ``tf32x3`` (fp32-accurate products as three TF32
    products) and ``fp32`` (CUDA cores); ``hbm_bw`` and ``hbm_bytes`` its
    memory's rate and capacity; ``nic_bw`` the rate one device's collective
    bytes leave its node at (the roofline's collective term); ``nvlink_bw``
    the rate to the other devices of its node."""

    name: str
    peak_flops: Mapping[str, float]
    hbm_bw: float
    hbm_bytes: float
    nic_bw: float
    nvlink_bw: float = 0.0
    #: the class a bare FLOP count is taken at (JAX's single PEAK_FLOPS)
    default_class: str = "bf16"


#: NVIDIA H100 SXM5, from NVIDIA's H100 datasheet: dense peaks without
#: sparsity at the 700 W limit, not measurements.  The paper's testbed is
#: 8-GPU H100 servers on InfiniBand with one NIC a GPU (``PAPER.md``): an
#: NDR NIC moves 400 Gb/s, 50e9 B/s, each way.
H100_SXM = Hardware(
    name="NVIDIA H100 SXM5 (datasheet)",
    peak_flops={"bf16": 989.4e12,              # datasheet: bf16 tensor cores
                "tf32": 494.7e12,              # datasheet: TF32 tensor cores
                "tf32x3": 494.7e12 / 3,        # fp32-accurate as 3 TF32 products
                "fp32": 66.9e12},              # datasheet: fp32 on the CUDA cores
    hbm_bw=3.35e12,                            # datasheet: HBM3, 3.35 TB/s
    hbm_bytes=80e9,                            # datasheet: 80 GB
    nic_bw=50e9,                               # NDR InfiniBand, 400 Gb/s a direction
    nvlink_bw=450e9)                           # datasheet: NVLink 900 GB/s, 450 each way

PEAK_NAMES = {"bf16": "bf16 tensor cores", "tf32": "TF32 tensor cores",
              "tf32x3": "3xTF32 on the tensor cores", "fp32": "fp32 CUDA cores"}


def flops_seconds(flops: float | Mapping[str, float], hw: Hardware = H100_SXM) -> float:
    """Least seconds for ``flops``: a count at ``hw``'s default class, or a
    mapping of counts by class, each at its class's peak."""
    if not isinstance(flops, Mapping):
        flops = {hw.default_class: flops}
    return sum(n / hw.peak_flops[c] for c, n in flops.items() if n)


def roofline_terms(
    *,
    flops_per_device: float | Mapping[str, float],
    hbm_bytes_per_device: float,
    wire_bytes_per_device: float,
    chips: int,
    hw: Hardware = H100_SXM,
) -> dict[str, float | str]:
    """The three roofline terms, in seconds, as the JAX package's
    ``roofline_terms``: the compute term sums each op class's FLOPs at that
    class's peak (a bare count is taken at ``hw.default_class``, which with
    one class is JAX's formula), memory is the bytes at ``hw.hbm_bw``, the
    collective term the wire bytes at ``hw.nic_bw``."""
    compute = flops_seconds(flops_per_device, hw)
    memory = hbm_bytes_per_device / hw.hbm_bw
    collective = wire_bytes_per_device / hw.nic_bw
    dominant = max(("compute", compute), ("memory", memory),
                   ("collective", collective), key=lambda kv: kv[1])
    return {"compute_s": compute, "memory_s": memory, "collective_s": collective,
            "bottleneck": dominant[0], "bound_s": dominant[1]}


def model_flops(cfg, tokens: float, mode: str) -> float:
    """6·N_active·D for training, 2·N_active·D for inference (the JAX
    package's, from ``cfg.active_param_count()``)."""
    n = cfg.active_param_count()
    per_tok = 6.0 * n if mode == "train" else 2.0 * n
    return per_tok * tokens


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def program_wire_bytes(program, nbytes: int, comm_dtype: str) -> float:
    """Bytes one rank puts on the wire to all-reduce a payload of ``nbytes``
    (in ``comm_dtype``) under ``program``, a ``core.schedule``
    ``CollectiveProgram``, as ``core/collectives.py`` runs it: the payload
    split into the segments at ``round(frac * numel)``, each segment padded
    to its schedule's chunks, and every step moving one chunk (or the whole
    buffer) from each of its sources.  A rank is counted as a source of
    every step: the count XLA makes per device for the same program (one
    ``ppermute`` operand a step, ``parse_collectives``).  ``program`` None
    (``mode="xla"``, a library all-reduce) is not a program: use
    :func:`all_reduce_wire_bytes`."""
    item = _ITEMSIZE[comm_dtype]
    total = nbytes // item
    wire, start = 0, 0
    for i, seg in enumerate(program.segments):
        end = total if i == len(program.segments) - 1 else start + int(round(seg.frac * total))
        end = min(max(end, start), total)
        n, start = end - start, end
        if n <= 0:
            continue
        C = seg.schedule.num_chunks
        M = -(-n // C)
        wire += sum(C * M if st.whole_buffer else M for st in seg.schedule.steps)
    return float(wire * item)


def all_reduce_wire_bytes(nbytes: float, ranks: int) -> float:
    """A ring all-reduce of ``nbytes`` on ``ranks`` ranks: 2 (n - 1) / n of
    the payload a rank (``parse_collectives``' all-reduce factor)."""
    return nbytes * 2 * (ranks - 1) / ranks if ranks > 1 else 0.0


# ---------------------------------------------------------------------------
# the kernels' formulas
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelCost:
    """The work of one kernel call: operations of one class and the bytes
    the function must move (each input read once, each output written
    once)."""

    flops: int
    nbytes: int
    peak: str                      # a key of Hardware.peak_flops

    def bound(self, hw: Hardware = H100_SXM) -> dict:
        """Least time on ``hw``: the larger of the operations at the class's
        peak and the bytes at the memory's rate, with what bounds it."""
        t_ops, t_bytes = self.flops / hw.peak_flops[self.peak], self.nbytes / hw.hbm_bw
        return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                    bound_by="operations" if t_ops >= t_bytes else "bytes",
                    bound_peak=f"{PEAK_NAMES[self.peak]} at "
                               f"{hw.peak_flops[self.peak] / 1e12:.4g} TFLOP/s",
                    ops_ms=t_ops * 1e3, bytes_ms=t_bytes * 1e3,
                    gflop=self.flops / 1e9, mbytes=self.nbytes / 1e6)


def _arith_sum(a: int, b: int, fa: int, fb: int) -> int:
    """Sum of a function linear on the integers a..b (inclusive) with values
    fa at a and fb at b."""
    return (b - a + 1) * (fa + fb) // 2


def visible_pairs(Tq: int, Tk: int, *, causal: bool = True, window: int | None = None,
                  prefix_len: int | None = None, q_offset: int = 0,
                  k_valid_len: int | None = None) -> int:
    """The (query, key) pairs the mask leaves visible, in closed form (no
    mask is built).  Query i sits at position ``q_offset + i``; it sees the
    keys ``k < min(Tk, k_valid_len)`` that are causal (``k <= q``) or in the
    prefix (``k < prefix_len``), and within ``window`` (``q - k <
    window``): the mask menu of ``ref.attention_mask``.  For query q that
    is the key range [lo(q), hi(q)), piecewise linear in q; the sum is taken
    in closed form over the pieces."""
    kend = min(Tk, k_valid_len) if k_valid_len is not None else Tk
    P = prefix_len or 0
    if kend <= 0 or Tq <= 0:
        return 0

    def count(q: int) -> int:
        hi = min(kend, max(q + 1, P)) if causal else kend
        lo = max(0, q - window + 1) if window is not None else 0
        return max(0, hi - lo)

    q0, q1 = q_offset, q_offset + Tq          # queries [q0, q1)
    W = window if window is not None else 0
    # the kinks of count(q): where q + 1 meets P or kend, where the window's
    # start leaves 0, and where hi - lo reaches 0
    cuts = {P - 1, kend - 1, -1}
    if window is not None:
        cuts |= {W - 1, kend + W - 1, P + W - 1}
    starts = sorted({q0} | {c for c in cuts if q0 < c < q1})
    total = 0
    for a, b in zip(starts, starts[1:] + [q1]):
        total += _arith_sum(a, b - 1, count(a), count(b - 1))
    return total


def _elt(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _attn_peak(dtype: torch.dtype) -> str:
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "tf32x3"


def flash_fwd_cost(q_shape, k_shape, dtype: torch.dtype = torch.float32, *,
                   causal: bool = True, window: int | None = None,
                   prefix_len: int | None = None, q_offset: int = 0,
                   k_valid_len: int | None = None, lse: bool = False) -> KernelCost:
    """The flash forward at q (B, Tq, KVH, G, D), k = v (B, Tk, KVH, D):
    2 * D operations for each of its two products a visible pair and query
    head; q, k, v read, out written (and the fp32 row lse if asked)."""
    B, Tq, KVH, G, D = q_shape
    Tk = k_shape[1]
    pairs = visible_pairs(Tq, Tk, causal=causal, window=window, prefix_len=prefix_len,
                          q_offset=q_offset, k_valid_len=k_valid_len)
    q_n, k_n = math.prod(q_shape), math.prod(k_shape)
    nbytes = (2 * q_n + 2 * k_n) * _elt(dtype) + (4 * B * Tq * KVH * G if lse else 0)
    return KernelCost(4 * D * pairs * B * KVH * G, nbytes, _attn_peak(dtype))


def flash_bwd_cost(q_shape, k_shape, dtype: torch.dtype = torch.float32, *,
                   causal: bool = True, window: int | None = None,
                   prefix_len: int | None = None) -> KernelCost:
    """The flash backward: five products of 2 * D a visible pair and query
    head (the scores again, dV, dP, dQ, dK: 2.5x the forward's); q, k, v,
    out, dout and the fp32 row lse read, dq, dk, dv written."""
    B, Tq, KVH, G, D = q_shape
    pairs = visible_pairs(Tq, k_shape[1], causal=causal, window=window,
                          prefix_len=prefix_len)
    q_n, k_n = math.prod(q_shape), math.prod(k_shape)
    nbytes = (4 * q_n + 4 * k_n) * _elt(dtype) + 4 * B * Tq * KVH * G
    return KernelCost(10 * D * pairs * B * KVH * G, nbytes, _attn_peak(dtype))


def chunk_combine_cost(shape, dtype: torch.dtype, seg_mask, accumulate, *,
                       in_place: bool = True) -> KernelCost:
    """The R2CCL merge of (C, M) chunks: an accumulating row reads local and
    recv and writes out (one add an element), a selecting row reads recv and
    writes out, an untouched row moves nothing in place (else a copy)."""
    C, M = shape
    seg = [bool(s) for s in seg_mask]
    acc = [bool(a) for a in accumulate]
    moved = sum((3 if a else 2) if s else (0 if in_place else 2) for s, a in zip(seg, acc))
    adds = sum(s and a for s, a in zip(seg, acc))
    return KernelCost(adds * M, moved * M * _elt(dtype), "fp32")


def small_mm_cost(x_shape, w_shape, x_dtype: torch.dtype = torch.float32) -> KernelCost:
    """The small-row product y[g] = x[g] @ w[g], x (G, M, K), w (G, K, N)
    float32: a multiply-add a (row, k, column) on the CUDA cores; x read
    (in its dtype), w read, the float32 y written.  Bound by w's bytes."""
    G, M, K = x_shape
    N = w_shape[-1]
    nbytes = G * M * K * _elt(x_dtype) + 4 * G * K * N + 4 * G * M * N
    return KernelCost(2 * G * M * K * N, nbytes, "fp32")


def mla_decode_cost(q_shape, rope: int, S: int, pos: int | None,
                    cache_dtype: torch.dtype = torch.float32, *,
                    lse: bool = False) -> KernelCost:
    """MLA decode's attention core at q_abs (B, 1, H, R) over a cache of
    ``S`` slots whose live length is ``min(pos + 1, S)`` (all ``S`` when
    ``pos`` is None, a position on the meta device): 2 (R + rope) operations
    a (row, head, live slot) for the scores and 2 R for the context, fp32 as
    3xTF32; the float32 queries read, the live slots' c_kv and k_pe read
    once (in the cache's dtype), the float32 context written (and the row
    log-sum-exp if asked)."""
    B, _, H, R = q_shape
    live = S if pos is None else max(0, min(pos + 1, S))
    nbytes = (4 * B * H * (R + rope) + B * live * (R + rope) * _elt(cache_dtype)
              + 4 * B * H * R + (4 * B * H if lse else 0))
    return KernelCost(2 * B * H * live * (2 * R + rope), nbytes, "tf32x3")


def lru_scan_cost(B: int, T: int, W: int) -> KernelCost:
    """h_t = a_t h_{t-1} + x_t in fp32: a multiply and an add an element;
    a, x read, h written, h0 read."""
    return KernelCost(2 * B * T * W, 4 * (3 * B * T * W + B * W), "fp32")


def lru_scan_bwd_cost(B: int, T: int, W: int, *, want_gh0: bool = True) -> KernelCost:
    """The reverse recurrence dh_t = gh_t + a_{t+1} dh_{t+1}, ga_t = dh_t
    h_{t-1}: three operations an element; a, h, gh read, gx, ga written, h0
    read (and gh0 written if asked)."""
    gh0 = B * W if want_gh0 else 0
    return KernelCost(3 * B * T * W + gh0, 4 * (5 * B * T * W + B * W + gh0), "fp32")


def wkv_scan_cost(B: int, T: int, H: int, K: int, *, ckpt: bool = False,
                  chunk: int = 16) -> KernelCost:
    """RWKV-6's WKV recurrence, V = K: per (b, t, h), out = r (S + u k^T v)
    is 2KV + 3K + 2V operations and S <- w S + k^T v is 3KV; r, k, v, w
    read and out written, u read, s0 read and s_T written (and with
    ``ckpt`` the state at each chunk's start written)."""
    V = K
    nbytes = 4 * (5 * B * T * H * K + H * K + 2 * B * H * K * V)
    if ckpt:
        nbytes += 4 * B * H * (-(-T // chunk)) * K * V
    return KernelCost((5 * K * V + 3 * K + 2 * V) * B * T * H, nbytes, "fp32")


def wkv_scan_bwd_cost(B: int, T: int, H: int, K: int, *, gs_t: bool = False,
                      want_gs0: bool = False) -> KernelCost:
    """The WKV backward: per (b, t, h) the state again (3KV), the adjoint's
    update (3KV) and the sums gr, gk, gv, gw (2KV each); r, k, v, w, gy
    read and gr, gk, gv, gw written, u read and gu written, the starting
    state read (and s_T's gradient read, s0's written, where given)."""
    V = K
    states = 1 + int(gs_t) + int(want_gs0)
    nbytes = 4 * (9 * B * T * H * K + 2 * H * K + states * B * H * K * V)
    return KernelCost(14 * K * V * B * T * H, nbytes, "fp32")


# ---------------------------------------------------------------------------
# counting a step as it runs
# ---------------------------------------------------------------------------

#: op name (``torch.ops.repro_torch.<name>``) -> (args, kwargs) -> KernelCost;
#: filled by ``kernels/library.py`` where it registers each op
KERNEL_COSTS: dict[str, object] = {}

_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
             "detach", "_unsafe_view", "lift_fresh", "alias", "sym_size", "sym_stride",
             "sym_numel", "sym_storage_offset", "is_contiguous", "size", "stride",
             "numel", "dim", "storage_offset", "_local_scalar_dense", "set_"}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _matmul_class(dtype: torch.dtype) -> str:
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    return "tf32" if torch.backends.cuda.matmul.allow_tf32 else "fp32"


class CostCounter(TorchDispatchMode):
    """Counts, for every op dispatched inside it: its FLOPs by op class, by
    ``torch.utils.flop_counter``'s registry (which holds the kernels'
    formulas), and its bytes, unfused: each tensor input read and each
    output written, views and allocations moving nothing, a kernel op by
    its byte formula, an in-place ``index_put_`` by the slots it writes.
    ``flops`` (by class), ``flops_by_op``, ``nbytes``
    and ``kernel_calls`` (by kernel op) hold the counts."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._registry = flop_registry
        self.flops: Counter = Counter()
        self.flops_by_op: Counter = Counter()
        self.kernel_calls: Counter = Counter()
        self.nbytes = 0

    @property
    def total_flops(self) -> float:
        return float(sum(self.flops.values()))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace == "repro_torch":
            cost = KERNEL_COSTS[name](*args, **kwargs)
            self.kernel_calls[name] += 1
            self.flops[cost.peak] += cost.flops
            self.flops_by_op[name] += cost.flops
            self.nbytes += cost.nbytes
            return out
        formula = self._registry.get(packet)
        if formula is not None:
            n = formula(*args, **kwargs, out_val=out)
            ins = _tensors(args)
            self.flops[_matmul_class(ins[0].dtype if ins else torch.float32)] += n
            self.flops_by_op[name] += n
        if name == "index_put_":
            # a write at indices (a decode step's cache slot) reads the
            # indices and the values and writes the values' bytes of self
            self.nbytes += sum(map(_nbytes, _tensors(args[1:]))) + _nbytes(args[2])
        elif not (getattr(func, "is_view", False) or name in _NO_BYTES):
            self.nbytes += sum(map(_nbytes, _tensors((args, kwargs))))
            self.nbytes += sum(map(_nbytes, _tensors(out)))
        return out


# ---------------------------------------------------------------------------
# the collectives a sharded step issues
# ---------------------------------------------------------------------------

#: ``parse_collectives``' op kinds, in its order
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")

#: the functional collectives DTensor issues (``_c10d_functional``, and
#: ``_dtensor.shard_dim_alltoall`` for a Shard(i) -> Shard(j) move), by kind
FUNCTIONAL_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}


def collective_wire_bytes(kind: str, operand_bytes: float, group: int) -> float:
    """Bytes one device puts on the wire for one collective of
    ``operand_bytes`` on a group of ``group``, by ``parse_collectives``'
    factors: all-reduce 2(g-1)/g, all-gather (g-1) times its operand (the
    shard), reduce-scatter and all-to-all (g-1)/g, a permute 1."""
    if kind == "all-reduce":
        return operand_bytes * 2 * (group - 1) / group
    if kind == "all-gather":
        return operand_bytes * (group - 1)
    if kind in ("reduce-scatter", "all-to-all"):
        return operand_bytes * (group - 1) / group
    return float(operand_bytes)


@dataclasses.dataclass
class Collective:
    """One collective as issued: its kind, its operand's bytes on one
    device and its group's size."""

    kind: str
    operand_bytes: int
    group: int

    @property
    def wire_bytes(self) -> float:
        return collective_wire_bytes(self.kind, self.operand_bytes, self.group)


class CollectiveCounter(TorchDispatchMode):
    """Records every functional collective dispatched inside it (the
    counterpart of ``parse_collectives`` over the partitioned HLO): kind,
    the operand's bytes (an all-gather's shard, a reduce-scatter's whole
    input) and the group's size."""

    def __init__(self):
        super().__init__()
        self.collectives: list[Collective] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(t is DTensor for t in types):
            # let DTensor run first and desugar the op into its collectives,
            # which come back here on local tensors (as ``CommDebugMode``)
            return NotImplemented
        kwargs = kwargs or {}
        kind = FUNCTIONAL_COLLECTIVES.get(func._overloadpacket.__name__)
        if kind is not None and func.namespace in ("_c10d_functional", "_dtensor"):
            import torch.distributed as dist

            bound = dict(zip((a.name for a in func._schema.arguments), args), **kwargs)
            group = bound["group_name"]
            if not isinstance(group, str):
                group = group.group_name
            size = dist.distributed_c10d._resolve_process_group(group).size()
            ins = bound.get("input", bound.get("inputs"))
            self.collectives.append(Collective(kind, sum(map(_nbytes, _tensors(ins))), size))
        return func(*args, **kwargs)

    def op_bytes(self) -> dict[str, float]:
        """Operand bytes by kind (``CollectiveStats.op_bytes``)."""
        out = dict.fromkeys(COLLECTIVE_KINDS, 0.0)
        for c in self.collectives:
            out[c.kind] += c.operand_bytes
        return out

    def op_counts(self) -> dict[str, int]:
        out = dict.fromkeys(COLLECTIVE_KINDS, 0)
        for c in self.collectives:
            out[c.kind] += 1
        return out

    def wire_by_kind(self) -> dict[str, float]:
        out = dict.fromkeys(COLLECTIVE_KINDS, 0.0)
        for c in self.collectives:
            out[c.kind] += c.wire_bytes
        return out
