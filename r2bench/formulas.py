"""The yardstick: the card's peaks, the work of each hand-written kernel a
cell's metrics read, and the model FLOPs of a step.

Frozen copies of ``repro_torch.launch.cost_analysis``'s ``H100_SXM``,
``KernelCost``, ``visible_pairs``, ``flash_fwd_cost`` and
``chunk_combine_cost``, so that a change to the program cannot move the
bounds it is measured against.  Model FLOPs are counted from the
configuration, not from what the program dispatches: the matrix products
(``2 * N`` a token forward, ``6 * N`` a token in a training step, N the
weights of the products) plus attention's two products over the causal pairs
(``QK^T`` and ``PV``: ``4 * head_dim`` a pair and query head forward, three
times that in training); recomputation is not counted.
"""

from __future__ import annotations

import dataclasses
import math

#: NVIDIA H100 SXM5 datasheet peaks at the 700 W limit (dense, no sparsity)
PEAK_FLOPS = {"bf16": 989.4e12, "tf32": 494.7e12, "tf32x3": 494.7e12 / 3, "fp32": 66.9e12}
HBM_BW = 3.35e12
_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """One kernel call's work: operations of one class and the bytes the
    function must move (each input read once, each output written once)."""

    flops: int
    nbytes: int
    peak: str

    def bound_s(self) -> float:
        """Least seconds on the card: operations at the class's peak or bytes
        at the memory's rate, whichever is larger."""
        return max(self.flops / PEAK_FLOPS[self.peak], self.nbytes / HBM_BW)


def _arith_sum(a: int, b: int, fa: int, fb: int) -> int:
    return (b - a + 1) * (fa + fb) // 2


def visible_pairs(Tq: int, Tk: int, *, causal: bool = True, window: int | None = None,
                  prefix_len: int | None = None, q_offset: int = 0,
                  k_valid_len: int | None = None) -> int:
    """The (query, key) pairs a mask leaves visible, in closed form: query i
    at position ``q_offset + i`` sees keys ``k < min(Tk, k_valid_len)`` that
    are causal (``k <= q``) or in the prefix, and within ``window``."""
    kend = min(Tk, k_valid_len) if k_valid_len is not None else Tk
    P = prefix_len or 0
    if kend <= 0 or Tq <= 0:
        return 0

    def count(q: int) -> int:
        hi = min(kend, max(q + 1, P)) if causal else kend
        lo = max(0, q - window + 1) if window is not None else 0
        return max(0, hi - lo)

    q0, q1 = q_offset, q_offset + Tq
    W = window if window is not None else 0
    cuts = {P - 1, kend - 1, -1}
    if window is not None:
        cuts |= {W - 1, kend + W - 1, P + W - 1}
    starts = sorted({q0} | {c for c in cuts if q0 < c < q1})
    total = 0
    for a, b in zip(starts, starts[1:] + [q1]):
        total += _arith_sum(a, b - 1, count(a), count(b - 1))
    return total


def flash_fwd_cost(q_shape, k_shape, dtype: str = "float32", *, causal: bool = True,
                   window: int | None = None, prefix_len: int | None = None,
                   q_offset: int = 0, k_valid_len: int | None = None,
                   lse: bool = False) -> KernelCost:
    """The flash forward at q (B, Tq, KVH, G, D), k = v (B, Tk, KVH, D): 2 * D
    operations for each of its two products a visible pair and query head
    (3xTF32 on the tensor cores for fp32); q, k, v read and out written."""
    B, Tq, KVH, G, D = q_shape
    pairs = visible_pairs(Tq, k_shape[1], causal=causal, window=window,
                          prefix_len=prefix_len, q_offset=q_offset, k_valid_len=k_valid_len)
    q_n, k_n = math.prod(q_shape), math.prod(k_shape)
    nbytes = (2 * q_n + 2 * k_n) * _ITEMSIZE[dtype] + (4 * B * Tq * KVH * G if lse else 0)
    peak = "bf16" if dtype in ("bfloat16", "float16") else "tf32x3"
    return KernelCost(4 * D * pairs * B * KVH * G, nbytes, peak)


def chunk_combine_cost(shape, dtype: str, seg_mask, accumulate, *,
                       in_place: bool = True) -> KernelCost:
    """The R2CCL merge of (C, M) chunks: an accumulating row reads local and
    recv and writes out (one add an element), a selecting row reads recv and
    writes out, an untouched row moves nothing in place (else a copy)."""
    C, M = shape
    seg = [bool(s) for s in seg_mask]
    acc = [bool(a) for a in accumulate]
    moved = sum((3 if a else 2) if s else (0 if in_place else 2) for s, a in zip(seg, acc))
    adds = sum(s and a for s, a in zip(seg, acc))
    return KernelCost(adds * M, moved * M * _ITEMSIZE[dtype], "fp32")


# ---------------------------------------------------------------------------
# model FLOPs of a llama-architecture configuration (configs/<name>.json)
# ---------------------------------------------------------------------------

def body_params(c: dict) -> int:
    """Weights of the products of the layers: Q, K, V, O and the gated MLP."""
    d, H, KVH, D, F = (c["hidden_size"], c["num_attention_heads"],
                       c["num_key_value_heads"], c["head_dim"], c["intermediate_size"])
    return c["num_hidden_layers"] * (2 * d * H * D + 2 * d * KVH * D + 3 * d * F)


def head_params(c: dict) -> int:
    return c["hidden_size"] * c["vocab_size"]


def attention_fwd_flops(c: dict, seq_len: int) -> int:
    """``QK^T`` and ``PV`` of one causal sequence through every layer."""
    pairs = seq_len * (seq_len + 1) // 2
    return c["num_hidden_layers"] * 4 * c["head_dim"] * c["num_attention_heads"] * pairs


def train_flops(c: dict, seq_lens) -> float:
    """A training step over sequences of ``seq_lens`` tokens (logits at every
    position)."""
    tokens = sum(seq_lens)
    return (6.0 * (body_params(c) + head_params(c)) * tokens
            + 3.0 * sum(attention_fwd_flops(c, t) for t in seq_lens))


def prefill_flops(c: dict, prompt_lens) -> float:
    """Prefill of prompts of ``prompt_lens`` real tokens: the layers at every
    token, the head at each prompt's last token only (the one the next token
    is read from)."""
    return (2.0 * body_params(c) * sum(prompt_lens) + 2.0 * head_params(c) * len(prompt_lens)
            + sum(attention_fwd_flops(c, t) for t in prompt_lens))
