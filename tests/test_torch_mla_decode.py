"""MLA decode's attention core (``kernels/mla_decode.py``, ``csrc/mla_decode.cu``)
and the rule ``ops.mla_decode`` routes by.

On the CPU: the plain version against the expression ``models/mla.py``
computed decode with (the same bits, float32 and bfloat16 caches, the ring
included), the routing rule, the split of the cache, the cost formula on
the meta device and through the op, and a decode step of a model at the
kernel's widths through the op against the plain version.  On the card
(``requires_cuda``): the kernel against a float64 evaluation at H 128, R
512, rope 64 over rows 1 / 3 / 8 / 16 and live lengths 1 to the whole ring,
a captured graph replayed while the position advances, the same bits on
two calls, its refusals, and the launches of a decode step.  This file
imports no JAX:

    PYTHONPATH=src python -m pytest -m requires_cuda tests/test_torch_mla_decode.py
"""

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tracing
from repro_torch.kernels import ops, ref
from repro_torch.kernels import mla_decode as MD
from repro_torch.launch import cost_analysis as CA
from repro_torch.launch.cost_analysis import CostCounter

F32, BF16 = torch.float32, torch.bfloat16
NEG_INF = -1e30
H, R, ROPE, S = 128, 512, 64, 2432
#: DeepSeek-V3's softmax scale: 192^-0.5 times YaRN's mscale squared
SCALE = 192 ** -0.5 * 1.8738977289104462


def _inputs(B, H, R, rope, S, dtype=F32, device="cpu", seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    q_abs = torch.randn(B, 1, H, R, generator=g, device=device)
    q_pe = torch.randn(B, 1, H, rope, generator=g, device=device)
    c_kv = torch.randn(B, S, R, generator=g, device=device).to(dtype)
    k_pe = torch.randn(B, S, rope, generator=g, device=device).to(dtype)
    return q_abs, q_pe, c_kv, k_pe


def _old_expression(q_abs, q_pe, c_all, kpe_all, pos, scale):
    """The absorbed attention core as ``models/mla.py`` wrote it inline
    before it went through ``ops.mla_decode``, line for line."""
    S = c_all.shape[1]
    s_nope = torch.einsum("bthr,bsr->bhts", q_abs, c_all.to(q_abs.dtype))
    s_pe = torch.einsum("bthk,bsk->bhts", q_pe, kpe_all.to(q_pe.dtype))
    s = (s_nope + s_pe).float() * scale                    # (B,H,1,S)
    valid = torch.arange(S, device=q_abs.device) <= pos        # ring validity
    s = torch.where(valid, s, NEG_INF)
    prob = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bsr->bthr", prob.to(c_all.dtype), c_all)  # (B,1,H,R)


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("pos", [0, 5, 23, 40, "tensor"])
def test_plain_version_is_the_old_expression_to_the_bit(dtype, pos):
    """S = 24 slots; positions inside the cache, at its last slot, past it
    (the ring: every slot live) and on the device as a tensor."""
    ins = _inputs(3, 4, 32, 16, 24, dtype)
    p = torch.tensor(9) if pos == "tensor" else pos
    got = ref.reference_mla_decode(*ins, p, 0.17)
    want = _old_expression(*ins, p, 0.17)
    assert got.dtype == dtype and got.shape == (3, 1, 4, 32)
    assert torch.equal(got, want)


# (id, make the four inputs, whether the kernel takes them)
FITS = [
    ("v3", lambda: _shapes(2, H, 8), True),
    ("bf16-cache", lambda: _shapes(2, H, 8, cache=BF16), True),
    ("few-heads", lambda: _shapes(1, 8, 8), True),
    ("fp16-cache", lambda: _shapes(2, H, 8, cache=torch.float16), False),
    ("mixed-cache", lambda: _shapes(2, H, 8, kpe=BF16), False),
    ("bf16-q", lambda: _shapes(2, H, 8, q=BF16), False),
    ("two-tokens", lambda: _shapes(2, H, 8, T=2), False),
    ("rank-32", lambda: _shapes(2, 4, 8, r=32, rope=16), False),
    ("padded-slots", lambda: _shapes(2, H, 8, pad=4), False),
    ("cache-view", lambda: _shapes(4, H, 8, view=2), True),
    ("grad", lambda: _shapes(2, H, 8, grad=True), False),
]


def _shapes(B, heads, slots, *, cache=F32, kpe=None, q=F32, T=1, r=R, rope=ROPE, pad=0,
            view=0, grad=False):
    q_abs = torch.empty(B, T, heads, r, dtype=q).requires_grad_(grad)
    q_pe = torch.empty(B, T, heads, rope, dtype=q)
    c_kv = torch.empty(B, slots, r + pad, dtype=cache)[:, :, :r]
    k_pe = torch.empty(B, slots, rope, dtype=kpe or cache)
    if view:                            # the first rows of a larger cache
        q_abs, q_pe = q_abs[:view], q_pe[:view]
        c_kv, k_pe = c_kv[:view], k_pe[:view]
    return q_abs, q_pe, c_kv, k_pe


@pytest.mark.parametrize("name,make,takes", FITS, ids=[f[0] for f in FITS])
def test_fits(name, make, takes):
    assert MD.fits(*make()) is takes


def test_splits_fill_the_card_at_every_row_count():
    """At V3's 128 heads (4 CTAs a row and split) and 2432 slots: 1 to 16
    rows take 96-132 CTAs, one wave; a cache of one tile takes one split."""
    for B in range(1, 17):
        n = MD.splits(B, H, S)
        assert 96 <= B * 4 * n <= 132, (B, n)
    assert [MD.splits(B, H, S) for B in (1, 2, 4, 8, 16)] == [33, 16, 8, 4, 2]
    assert MD.splits(1, H, 32) == 1 and MD.splits(64, H, S) == 1


def test_cost_formula_counts_the_live_slots():
    """2 (2R + rope) operations a (row, head, live slot); the queries, the
    live slots and the context in bytes; all S slots where the position is
    unknown (None) or past the cache."""
    q = (8, 1, H, R)
    c = CA.mla_decode_cost(q, ROPE, S, 2047)
    assert c.flops == 2 * 8 * H * 2048 * (2 * R + ROPE) and c.peak == "tf32x3"
    assert c.nbytes == 4 * 8 * H * (R + ROPE) + 4 * 8 * 2048 * (R + ROPE) + 4 * 8 * H * R
    assert CA.mla_decode_cost(q, ROPE, S, None).flops == \
        CA.mla_decode_cost(q, ROPE, S, 10 ** 6).flops == 2 * 8 * H * S * (2 * R + ROPE)
    bf = CA.mla_decode_cost(q, ROPE, S, 2047, BF16, lse=True)
    assert bf.nbytes == c.nbytes - 2 * 8 * 2048 * (R + ROPE) + 4 * 8 * H
    # 8 rows, L 2048, 10 layers: 45.6 GFLOP, 0.28 ms at 3xTF32's peak
    assert 10 * c.flops / 1e9 == pytest.approx(45.63, abs=0.01)
    assert 10 * c.bound()["bound_ms"] == pytest.approx(0.2767, abs=1e-3)
    assert c.bound()["bound_by"] == "operations"


def _count(fn):
    with FlopCounterMode(display=False) as fc, CostCounter() as cc:
        out = fn()
    return out, fc.get_total_flops(), cc


def test_op_counts_alike_on_meta_and_on_the_cpu():
    """The op's fake and its plain CPU version count the formula's FLOPs
    and bytes at a host position and at an index tensor on the CPU; the
    meta device's fake gives the kernel's float32 (B, 1, H, R)."""
    want = CA.mla_decode_cost((2, 1, 8, R), ROPE, 40, 17)
    for dev in ("meta", "cpu"):
        q_abs, q_pe, c_kv, k_pe = (t.to(dev) for t in _inputs(2, 8, R, ROPE, 40, BF16))
        out, flops, cc = _count(lambda: torch.ops.repro_torch.mla_decode(
            q_abs, q_pe, c_kv, k_pe, None, 17, 0.1, None))
        assert out.shape == (2, 1, 8, R) and out.dtype == F32
        assert flops == want.flops and cc.kernel_calls == {"mla_decode": 1}
        assert cc.nbytes == CA.mla_decode_cost((2, 1, 8, R), ROPE, 40, 17, BF16).nbytes
    _, flops, _ = _count(lambda: torch.ops.repro_torch.mla_decode(
        *_inputs(2, 8, R, ROPE, 40), torch.tensor(17), 0, 0.1, None))
    assert flops == want.flops


def test_ops_routes_by_device_and_impl():
    """On the CPU the plain version (the cache's dtype), inside
    ``use("op")`` the op (float32, the same values), inside
    ``use("reference")`` the plain version again; the meta device keeps
    the plain products over every slot (the dry run); a shape the kernel
    does not take stays plain inside ``use("op")``."""
    ins = _inputs(2, 8, R, ROPE, 40, BF16)
    plain = ops.mla_decode(*ins, 17, 0.1)
    assert plain.dtype == BF16 and torch.equal(plain, ref.reference_mla_decode(*ins, 17, 0.1))
    for impl, calls in (("op", {"mla_decode": 1}), ("reference", {})):
        with ops.use(impl):
            out, _, cc = _count(lambda: ops.mla_decode(*ins, torch.tensor(17), 0.1))
        assert dict(cc.kernel_calls) == calls
        assert torch.equal(out.float(), plain.float())
    meta = [t.to("meta") for t in ins]
    _, flops, cc = _count(lambda: ops.mla_decode(*meta, 17, 0.1))
    assert not cc.kernel_calls and flops == 2 * 2 * 8 * 40 * (2 * R + ROPE)
    small = _inputs(2, 4, 32, 16, 40)
    with ops.use("op"):
        _, _, cc = _count(lambda: ops.mla_decode(*small, 17, 0.1))
    assert not cc.kernel_calls


def test_cpu_op_writes_the_log_sum_exp():
    ins = _inputs(2, 8, R, ROPE, 40)
    lse = torch.empty(2, 8)
    torch.ops.repro_torch.mla_decode(*ins, None, 17, 0.1, lse)
    q_abs, q_pe, c_kv, k_pe = (t.double() for t in ins)
    s = (torch.einsum("bthr,bsr->bhs", q_abs, c_kv)
         + torch.einsum("bthk,bsk->bhs", q_pe, k_pe))[:, :, :18] * 0.1
    torch.testing.assert_close(lse.double(), s.logsumexp(-1), rtol=1e-6, atol=1e-5)


def _kernel_width_config(heads=8, layers=2):
    """DeepSeek-V3's smoke model with the kernel's latent widths (kv_lora
    512, rope 64) at ``heads`` heads: 1 dense layer, then MoE; a float32
    residual stream, so that the kernel's roundings are not amplified by
    bf16's."""
    from repro_torch.models import get_smoke_config
    cfg = get_smoke_config("deepseek-v3-671b")
    att = dataclasses.replace(cfg.attention, num_heads=heads, num_kv_heads=heads,
                              kv_lora_rank=R, qk_rope_head_dim=ROPE)
    return dataclasses.replace(cfg, attention=att, num_layers=layers, mtp=False,
                               dtype="float32")


@pytest.mark.parametrize("cache_dtype", [F32, BF16])
def test_decode_step_through_the_op_equals_the_plain_one(cache_dtype):
    """A decode step of a model at the kernel's widths: through the op (the
    CPU's plain version, widened) the same logits to the bit as the plain
    path, one op call a layer."""
    from repro_torch.models import apply_model, init_caches, init_model

    cfg = _kernel_width_config()
    params = init_model(cfg, seed=0, device="cpu")
    logits = {}
    for impl in ("auto", "op"):
        caches = init_caches(cfg, 2, 24, dtype=cache_dtype, device="cpu",
                             device_index=True)
        tok = torch.arange(2 * 10).reshape(2, 10) % cfg.vocab_size
        with torch.no_grad(), ops.use(impl):
            out, caches, _ = apply_model(params, cfg, {"tokens": tok}, mode="prefill",
                                         caches=caches)
            step, _, cc = _count(lambda: apply_model(
                params, cfg, {"tokens": out[:, -1:].argmax(-1)}, mode="decode",
                caches=caches))
        logits[impl] = step[0]
        assert cc.kernel_calls.get("mla_decode", 0) == (cfg.num_layers if impl == "op" else 0)
    assert torch.equal(logits["auto"], logits["op"])


def test_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        MD.mla_decode_cuda(*_inputs(1, 8, R, ROPE, 40), None, 3, 0.1)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


#: the kernel's worst error against float64, over the rounding scale of
#: each quantity: X = scale * sum |q| |k| (the largest over the live slots)
#: for the scores, read through the row's log-sum-exp, and sum p |c| (1 +
#: 2 X) for the context (a score's rounding error d moves its probability by
#: e^d - 1: at X ~ 60 an fp32 score's d ~ 1e-6 moves the context by ~1e-6 of
#: sum p |c| in any fp32 evaluation).  3xTF32 products and fp32 sums read
#: ~1e-8-1e-7 on both scales; TF32 products read ~1e-4
REL_TOL = 1e-6
ROWS = (1, 3, 8, 16)
#: live lengths 1, 17, 1023, 2048, 2432 of 2432 slots, and the ring
POSITIONS = (0, 16, 1022, 2047, 2431, 2431 + 700)


def float64_core(q_abs, q_pe, c_kv, k_pe, pos, scale):
    """(ctx, lse, sum p |c|, the scores' scale X: the largest scale * sum
    |q| |k| over the live slots) in float64."""
    qa, qp, c, kp = (t.double() for t in (q_abs, q_pe, c_kv, k_pe))
    live = torch.arange(c.shape[1], device=c.device) <= pos
    s = (torch.einsum("bthr,bsr->bhs", qa, c) + torch.einsum("bthk,bsk->bhs", qp, kp)) * scale
    s = s.masked_fill(~live, -torch.inf)
    p = torch.softmax(s, -1)
    mag = (torch.einsum("bthr,bsr->bhs", qa.abs(), c.abs())
           + torch.einsum("bthk,bsk->bhs", qp.abs(), kp.abs())) * scale
    return (torch.einsum("bhs,bsr->bhr", p, c), s.logsumexp(-1),
            torch.einsum("bhs,bsr->bhr", p, c.abs()),
            mag.masked_fill(~live, 0).amax(-1))


def kernel_errors(ins, pos, on_device=False):
    """The kernel's (context, scores) errors over their scales at ``pos``,
    given from the host or ``on_device`` as an int64 the kernel reads."""
    B, _, heads, _ = ins[0].shape
    lse = torch.empty(B, heads, device=ins[0].device)
    index = torch.tensor(pos, device=ins[0].device) if on_device else None
    ctx = MD.mla_decode_cuda(*ins, index, 0 if on_device else pos, SCALE, lse=lse)
    want, lse64, pc, x = float64_core(*ins, pos, SCALE)
    ce = ((ctx[:, 0].double() - want).abs() / (pc * (1 + 2 * x[..., None]))).max().item()
    se = ((lse.double() - lse64).abs() / x).max().item()
    return ce, se


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_kernel_against_float64(cuda_device, dtype):
    """H 128, R 512, rope 64, 2432 slots: rows 1 / 3 / 8 / 16, every live
    length of ``POSITIONS`` (the last past the cache: the ring), the
    position once from the host and once from an int64 on the device."""
    ins = _inputs(16, H, R, ROPE, S, dtype, cuda_device)
    for B in ROWS:
        rows = [t[:B] for t in ins]
        for pos in POSITIONS:
            ce, se = kernel_errors(rows, pos)
            assert ce <= REL_TOL and se <= REL_TOL, (B, pos, ce, se)
        assert kernel_errors(rows, 1022, on_device=True) == kernel_errors(rows, 1022)


@pytest.mark.requires_cuda
def test_kernel_masks_a_partial_head_group(cuda_device):
    """40 heads: one CTA of 32 and one holding 8, its other rows masked."""
    for dtype in (F32, BF16):
        ins = _inputs(3, 40, R, ROPE, S, dtype, cuda_device, seed=3)
        for pos in (0, 1000, 2431 + 5):
            ce, se = kernel_errors(ins, pos)
            assert ce <= REL_TOL and se <= REL_TOL, (dtype, pos, ce, se)


@pytest.mark.requires_cuda
def test_graph_replays_read_the_advancing_position(cuda_device):
    """A captured call replayed while the index advances in place (as
    decode's ``pos.add_(1)``) gives, at each position, the bits of an eager
    call there: the live length is read on the device at every replay."""
    ins = _inputs(8, H, R, ROPE, S, F32, cuda_device, seed=1)
    index = torch.tensor(1000, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        MD.mla_decode_cuda(*ins, index, 0, SCALE)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = MD.mla_decode_cuda(*ins, index, 0, SCALE)
        index.add_(1)
    for step in range(60):            # positions 1000, 1033, ..., past the ring at 2431
        graph.replay()
        torch.cuda.synchronize()
        assert int(index) == 1001 + 33 * step
        want = MD.mla_decode_cuda(*ins, None, 1000 + 33 * step, SCALE)
        assert torch.equal(out, want), step
        index.add_(32)


@pytest.mark.requires_cuda
def test_same_bits_on_two_calls(cuda_device):
    for dtype in (F32, BF16):
        ins = _inputs(5, H, R, ROPE, S, dtype, cuda_device, seed=2)
        a = MD.mla_decode_cuda(*ins, None, 1777, SCALE)
        b = MD.mla_decode_cuda(*ins, None, 1777, SCALE)
        assert torch.equal(a, b)


@pytest.mark.requires_cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    q_abs, q_pe, c_kv, k_pe = _inputs(2, H, R, ROPE, 64, F32, cuda_device)
    with pytest.raises(ValueError, match="takes"):
        MD.mla_decode_cuda(q_abs.half(), q_pe, c_kv, k_pe, None, 3, 0.1)
    with pytest.raises(ValueError, match="takes"):
        MD.mla_decode_cuda(q_abs, q_pe, c_kv, k_pe.to(BF16), None, 3, 0.1)
    with pytest.raises(ValueError, match="takes"):
        MD.mla_decode_cuda(q_abs, q_pe, c_kv.transpose(1, 2).contiguous().transpose(1, 2),
                           k_pe, None, 3, 0.1)
    with pytest.raises(ValueError, match="int64"):
        MD.mla_decode_cuda(q_abs, q_pe, c_kv, k_pe, torch.tensor(3.0, device=cuda_device),
                           0, 0.1)
    with pytest.raises(ValueError, match="one CUDA device"):
        MD.mla_decode_cuda(q_abs, q_pe, c_kv.cpu(), k_pe, None, 3, 0.1)


@pytest.mark.requires_cuda
def test_a_decode_step_calls_the_kernel_once_a_layer(cuda_device):
    """A model at the kernel's widths (8 heads: one CTA's heads, the rest
    masked): an eager decode step calls the kernel once a layer, counted as
    ``attn.mla_decode``; its logits match the plain version's; the engine
    calls it once a layer in each capture's warm-up and capture, and never
    on a replay."""
    from repro_torch.models import apply_model, init_caches, init_model
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving.engine import graph_rows

    cfg = _kernel_width_config(layers=3)
    params = init_model(cfg, seed=0, device=cuda_device)
    caches = {impl: init_caches(cfg, 3, 64, dtype=F32, device=cuda_device, device_index=True)
              for impl in ("auto", "reference")}
    tok = torch.randint(0, cfg.vocab_size, (3, 20), device=cuda_device)
    logits = {}
    for impl, c in caches.items():
        with torch.no_grad(), ops.use(impl):
            out, c, _ = apply_model(params, cfg, {"tokens": tok}, mode="prefill", caches=c)
            before = MD.mla_decode_cuda.launches
            tracing.enable()
            try:
                logits[impl] = apply_model(params, cfg, {"tokens": out[:, -1:].argmax(-1)},
                                           mode="decode", caches=c)[0]
            finally:
                tracing.disable()
            torch.cuda.synchronize()
            counters = tracing.drain()["counters"]
            want = cfg.num_layers if impl == "auto" else 0
            assert MD.mla_decode_cuda.launches - before == want
            assert counters.get("attn.mla_decode", 0) == want
    torch.testing.assert_close(logits["auto"], logits["reference"], rtol=1e-4, atol=1e-4)

    engine = ServingEngine(cfg, params, context_len=64, device=cuda_device)
    rng = torch.Generator().manual_seed(0)
    reqs = [Request(prompt=torch.randint(0, cfg.vocab_size, (12,), generator=rng).numpy(),
                    max_new_tokens=6) for _ in range(3)]
    before = MD.mla_decode_cuda.launches
    tracing.enable()
    try:
        engine.run_batch(reqs)
    finally:
        tracing.disable()
    counters = tracing.drain()["counters"]
    calls = 2 * len(graph_rows(3)) * cfg.num_layers
    assert MD.mla_decode_cuda.launches - before == counters["attn.mla_decode"] == calls
    assert counters["engine.graph_replay"] == 5
