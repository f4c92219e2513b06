"""The small-row float32 product (``kernels/small_mm.py``, ``csrc/small_mm.cu``)
and the rule the model's product helpers route by.

On the CPU: which products the rule sends to the kernel, the plain version
against ``torch.bmm`` and ``@``, the cost formula, the plan, and the helpers
unchanged off the card.  On the card (``requires_cuda``): the kernel against
a float64 product at every row count, the same bits on two calls and in a
CUDA graph, its refusals, and which products of a decode step and a
training step take it.  This file imports no JAX:

    PYTHONPATH=src python -m pytest -m requires_cuda tests/test_torch_small_mm.py
"""

import dataclasses

import pytest
import torch

from repro_torch import tracing
from repro_torch.kernels import ops, ref
from repro_torch.kernels import small_mm as SM
from repro_torch.launch import cost_analysis as CA
from repro_torch.models import layers as L
from repro_torch.models import moe

F32, BF16 = torch.float32, torch.bfloat16


def _t(*shape, dtype=F32, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dtype).to(device)


# ---------------------------------------------------------------------------
# the routing rule
# ---------------------------------------------------------------------------

def _transposed(K, N):
    return torch.empty(N, K).T          # (K, N), column-major: embedding.T


def _padded(K, N):
    return torch.empty(K, N + 4)[:, :N]  # row-major, rows 4 floats apart


def _odd_offset(K, N):
    return torch.empty(K * N + 1)[1:].view(K, N)   # off the 16-byte grid


# (id, x, w, grad, whether the kernel takes it)
ROUTES = [
    ("decode-row", lambda: torch.empty(1, 1, 64), lambda: torch.empty(64, 32), False, True),
    ("16-rows", lambda: torch.empty(4, 4, 64), lambda: torch.empty(64, 32), False, True),
    ("17-rows", lambda: torch.empty(17, 1, 64), lambda: torch.empty(64, 32), False, False),
    ("prefill", lambda: torch.empty(2, 128, 64), lambda: torch.empty(64, 32), False, False),
    ("bf16-x", lambda: torch.empty(3, 1, 64, dtype=BF16), lambda: torch.empty(64, 32), False,
     True),
    ("bf16-w", lambda: torch.empty(3, 1, 64), lambda: torch.empty(64, 32, dtype=BF16), False,
     False),
    ("bf16-both", lambda: torch.empty(3, 64, dtype=BF16),
     lambda: torch.empty(64, 32, dtype=BF16), False, False),
    ("fp16-x", lambda: torch.empty(3, 64, dtype=torch.float16), lambda: torch.empty(64, 32),
     False, False),
    ("fp64-w", lambda: torch.empty(3, 64, dtype=torch.float64),
     lambda: torch.empty(64, 32, dtype=torch.float64), False, False),
    ("tied-head", lambda: torch.empty(4, 1, 64), lambda: _transposed(64, 48), False, False),
    ("row-stride", lambda: torch.empty(4, 64), lambda: _padded(64, 32), False, True),
    ("n-not-4", lambda: torch.empty(4, 64), lambda: torch.empty(64, 30), False, False),
    ("k-not-8", lambda: torch.empty(4, 60), lambda: torch.empty(60, 32), False, False),
    ("off-grid", lambda: torch.empty(4, 64), lambda: _odd_offset(64, 32), False, False),
    ("grad-x", lambda: torch.empty(4, 64).requires_grad_(), lambda: torch.empty(64, 32),
     True, False),
    ("grad-w", lambda: torch.empty(4, 64), lambda: torch.empty(64, 32).requires_grad_(),
     True, False),
    ("grad-off", lambda: torch.empty(4, 64).requires_grad_(), lambda: torch.empty(64, 32),
     False, True),
    ("experts", lambda: torch.empty(8, 5, 64), lambda: torch.empty(8, 64, 32), False, True),
    ("experts-shared-x", lambda: torch.empty(5, 64).expand(8, 5, 64),
     lambda: torch.empty(8, 64, 32), False, True),
    ("experts-17", lambda: torch.empty(8, 17, 64), lambda: torch.empty(8, 64, 32), False,
     False),
    ("experts-lead", lambda: torch.empty(8, 2, 8, 64), lambda: torch.empty(8, 64, 32), False,
     True),
    ("experts-mismatch", lambda: torch.empty(4, 5, 64), lambda: torch.empty(8, 64, 32), False,
     False),
]


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("case", ROUTES, ids=[r[0] for r in ROUTES])
def test_routing_rule(case, device):
    """``small_mm.fits`` says which products the kernel takes: float32
    after promotion (x float32 or bfloat16, w float32), 1-16 rows a batch
    entry, w row-major with N contiguous on the 16-byte grid, no gradient
    wanted.  Off the card nothing takes it: ``ops._small_rows`` is false on the
    CPU and the meta device (the JAX parity tests, the dry run) and counts
    nothing."""
    _, make_x, make_w, grad, want = case
    x, w = make_x(), make_w()
    if device == "meta":
        x, w = (torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="meta")
                .requires_grad_(t.requires_grad) for t in (x, w))
    with torch.set_grad_enabled(grad):
        if device == "meta" and case[0] == "off-grid":
            want = True                               # no address on the meta device
        assert SM.fits(x, w) is want
        tracing.enable()
        try:
            assert ops._small_rows(x, w) is False
        finally:
            tracing.disable()
        assert tracing.drain()["counters"] == {}


# ---------------------------------------------------------------------------
# the plain version, the op, the cost and the plan on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [1, 3, 16])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_plain_version_is_bmm_and_matmul_bit_for_bit(M, dtype):
    """``ref.reference_small_mm`` is ``torch.bmm`` of the widened x, and
    for one batch entry ``x @ w``, to the bit; the op's CPU implementation
    and ``ops.small_mm`` on the CPU give the same."""
    x, w = _t(2, M, 40, dtype=dtype), _t(2, 40, 24, seed=1)
    got = ref.reference_small_mm(x, w)
    assert got.dtype == F32
    assert torch.equal(got, torch.bmm(x.float(), w))
    assert torch.equal(torch.ops.repro_torch.small_mm(x, w), got)
    assert torch.equal(ops.small_mm(x, w), got)
    assert torch.equal(ops.small_mm(x[0], w[0]), x[0].float() @ w[0])
    assert torch.equal(ops.small_mm(x[:1], w[:1])[0], got[0])


def test_ops_small_mm_keeps_the_leading_dims():
    x, w = _t(3, 1, 32), _t(32, 8)
    assert ops.small_mm(x, w).shape == (3, 1, 8)
    xe, we = _t(4, 2, 3, 32), _t(4, 32, 8)
    y = ops.small_mm(xe, we)
    assert y.shape == (4, 2, 3, 8)
    assert torch.equal(y[1, 0], xe[1, 0] @ we[1])


def test_small_mm_cost_at_a_known_shape():
    """deepseek-67b's q product at 16 rows: 2 x 16 x 8192 x 8192 FLOPs;
    the 268 MB weight, bf16 x and the fp32 y: bound by bytes, 0.0803 ms at
    3.35 TB/s."""
    c = CA.small_mm_cost((1, 16, 8192), (1, 8192, 8192), BF16)
    assert c.flops == 2 * 16 * 8192 * 8192 and c.peak == "fp32"
    assert c.nbytes == 16 * 8192 * 2 + 4 * 8192 * 8192 + 4 * 16 * 8192
    b = c.bound()
    assert b["bound_by"] == "bytes"
    assert abs(b["bound_ms"] - 0.0803) < 5e-4
    e = CA.small_mm_cost((8, 3, 7168), (8, 7168, 2048))
    assert e.nbytes == 4 * (8 * 3 * 7168 + 8 * 7168 * 2048 + 8 * 3 * 2048)


#: (G, K, N) of the serving cells' decode products and the plan's (bn,
#: split) for them on 132 SMs
CELL_PLANS = [((1, 8192, 8192), (128, 2)), ((1, 8192, 1024), (128, 16)),
              ((1, 8192, 22016), (128, 1)), ((1, 22016, 8192), (128, 2)),
              ((1, 8192, 102400), (128, 1)), ((1, 7168, 1536), (128, 8)),
              ((1, 1536, 24576), (128, 1)), ((1, 7168, 512), (64, 16)),
              ((1, 7168, 64), (32, 16)), ((1, 16384, 7168), (128, 2)),
              ((1, 7168, 18432), (128, 1)), ((1, 18432, 7168), (128, 2)),
              ((1, 7168, 2048), (128, 8)), ((1, 2048, 7168), (128, 2)),
              ((8, 7168, 2048), (128, 1)), ((8, 2048, 7168), (128, 1)),
              ((1, 7168, 129280), (128, 1)), ((1, 8, 4), (128, 1))]


@pytest.mark.parametrize("shape,want", CELL_PLANS)
def test_plan_at_the_cells_shapes(shape, want):
    """The widest tile, split the fewest ways that gives 66 CTAs (half the
    SMs), each CTA of a split two steps of rows; else narrower tiles; else
    the most CTAs."""
    G, K, N = shape
    bn, split = SM.plan(G, K, N)
    assert (bn, split) == want
    assert bn in SM.WIDTHS and split in SM.SPLITS
    if split > 1:
        assert -(-K // split) >= 2 * SM.THREADS * SM.UNROLL * 4 // bn
    assert -(-N // bn) * split * G >= 66 or shape in ((1, 7168, 64), (1, 8, 4))


def test_helpers_off_the_card_are_unchanged():
    """On the CPU ``_mm`` and ``_expert_mm`` compute as before: ``x @ w``
    and one ``bmm`` in the promoted dtype, to the bit, and count
    nothing."""
    x, w = _t(3, 1, 48, dtype=BF16), _t(48, 20)
    xe, we = _t(2, 4, 3, 48, dtype=BF16, seed=2), _t(4, 48, 20, seed=3)
    tracing.enable()
    try:
        got = L._mm(x, w)
        got_e = moe._expert_mm(xe, we)
    finally:
        tracing.disable()
    assert tracing.drain()["counters"] == {}
    assert torch.equal(got, x.float() @ w)
    want_e = torch.bmm(xe.float().movedim(-3, 0).reshape(4, -1, 48), we)
    assert torch.equal(got_e, want_e.reshape(4, 2, 3, 20).movedim(0, -3))


@pytest.mark.parametrize("impl,plain", [("auto", False), ("reference", True)])
def test_reference_run_keeps_every_product_off_the_kernel(impl, plain, monkeypatch):
    """``apply_model`` inside ``ops.use("reference")`` runs every product
    under that choice, so on the card they keep cuBLAS (the kernel's plain
    version); ``auto`` leaves them to the rule.  The choice is ``auto``
    again after the block, and a nested ``use`` gives the outer one back."""
    from repro_torch.models import apply_model, get_smoke_config, init_caches, init_model

    seen = []
    mm = L._mm
    monkeypatch.setattr(L, "_mm",
                        lambda x, w: seen.append(ops.current() == "reference") or mm(x, w))
    cfg = get_smoke_config("glm4-9b")
    params = init_model(cfg, seed=0, device="cpu")
    caches = init_caches(cfg, 2, 16, dtype=F32, device="cpu")
    with ops.use(impl):
        apply_model(params, cfg, {"tokens": torch.zeros(2, 5, dtype=torch.long)},
                    mode="prefill", caches=caches)
    assert seen and set(seen) == {plain}
    assert ops.current() == "auto"
    with ops.use("reference"):
        with ops.use("op"):
            assert ops.current() == "op"
        assert ops.current() == "reference"
    assert ops.current() == "auto"


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        SM.small_mm_cuda(_t(1, 2, 8), _t(1, 8, 4))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


#: the kernel's error against float64 over the rounding scale sum |x| |w|:
#: fp32 sums in a fixed order over K terms, each thread's chain at most
#: K / (1024 / bn) long, read ~1e-8-1e-7 at these K on random data; products
#: taken in TF32 read ~1e-5 there, bf16 weights ~1e-4
REL_TOL = 2e-6

#: (K, N, G) of the serving cells' decode products: deepseek-67b's q / o, k /
#: v, gate / up, down and head; DeepSeek-V3's MLA (w_dq, w_uq, w_dkv, w_kpe,
#: w_o), dense FFN, shared expert, the 8 held experts, head
CARD_SHAPES = [(8192, 8192, 1), (8192, 1024, 1), (8192, 22016, 1), (22016, 8192, 1),
               (8192, 102400, 1), (7168, 1536, 1), (1536, 24576, 1), (7168, 512, 1),
               (7168, 64, 1), (16384, 7168, 1), (7168, 18432, 1), (18432, 7168, 1),
               (7168, 2048, 1), (2048, 7168, 1), (7168, 2048, 8), (2048, 7168, 8),
               (7168, 129280, 1)]


def _card_inputs(G, K, N, dtype, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(G, 16, K, device=dev, generator=gen).to(dtype)
    w = torch.randn(G, K, N, device=dev, generator=gen) / K ** 0.5
    return x, w


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K,N,G", CARD_SHAPES)
def test_kernel_against_float64_at_every_row_count(cuda_device, K, N, G):
    """Every M in 1..16, float32 and bfloat16 x: |y - y64| <= REL_TOL x
    (|x| @ |w|) elementwise, y64 the product in float64."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in (F32, BF16):
        x, w = _card_inputs(G, K, N, dtype, cuda_device)
        y64 = torch.bmm(x.double(), w.double())
        scale = torch.bmm(x.double().abs(), w.double().abs())
        for M in range(1, 17):
            y = SM.small_mm_cuda(x[:, :M], w)
            assert y.shape == (G, M, N) and y.dtype == F32
            err = ((y.double() - y64[:, :M]).abs() / scale[:, :M]).max().item()
            assert err <= REL_TOL, (M, dtype, err)
        del x, w, y64, scale


@pytest.mark.requires_cuda
def test_kernel_takes_a_shared_x_and_strided_w(cuda_device):
    """The held experts' decode: one x for every expert (batch stride 0),
    bf16; w rows 4 floats apart (a padded view); N = 8 (one tile of 32,
    masked columns)."""
    x = torch.randn(5, 1024, device=cuda_device).to(BF16)
    w = torch.randn(8, 1024, 2048, device=cuda_device)
    y = SM.small_mm_cuda(x.expand(8, 5, 1024), w)
    torch.testing.assert_close(y, torch.bmm(x.float().expand(8, 5, 1024), w), rtol=1e-5,
                               atol=1e-4)
    wp = torch.randn(1, 1024, 12, device=cuda_device)[:, :, :8]
    y = SM.small_mm_cuda(x[None, :3].float(), wp)
    torch.testing.assert_close(y, x[None, :3].float() @ wp, rtol=1e-5, atol=1e-4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K,N,G", [(8192, 1024, 1), (7168, 512, 1), (2048, 7168, 8),
                                   (8192, 22016, 1)])
def test_same_bits_on_two_calls_and_in_a_graph(cuda_device, K, N, G):
    """No atomics, a fixed order: two calls give the same bits, and a
    captured graph's replay gives eager's (the cluster's split included:
    1024 and 512 columns split K)."""
    x, w = _card_inputs(G, K, N, F32, cuda_device)
    for M in (1, 7, 16):
        xs = x[:, :M].contiguous()
        a, b = SM.small_mm_cuda(xs, w), SM.small_mm_cuda(xs, w)
        assert torch.equal(a, b)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            SM.small_mm_cuda(xs, w)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = SM.small_mm_cuda(xs, w)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, a)


@pytest.mark.requires_cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    dev = cuda_device
    x, w = torch.randn(1, 4, 64, device=dev), torch.randn(1, 64, 32, device=dev)
    with pytest.raises(TypeError):
        SM.small_mm_cuda(x, w.to(BF16))
    with pytest.raises(TypeError):
        SM.small_mm_cuda(x.half(), w)
    with pytest.raises(ValueError, match="rows"):
        SM.small_mm_cuda(torch.randn(1, 17, 64, device=dev), w)
    with pytest.raises(ValueError, match="rows"):
        SM.small_mm_cuda(torch.randn(1, 0, 64, device=dev), w)
    with pytest.raises(ValueError, match="row-major"):
        SM.small_mm_cuda(x, torch.randn(1, 32, 64, device=dev).transpose(1, 2))
    with pytest.raises(ValueError, match="multiple of 4"):
        SM.small_mm_cuda(x, torch.randn(1, 64, 30, device=dev))
    with pytest.raises(ValueError, match="multiple of 8"):
        SM.small_mm_cuda(torch.randn(1, 4, 60, device=dev), torch.randn(1, 60, 32, device=dev))
    with pytest.raises(ValueError, match="16-byte grid"):
        SM.small_mm_cuda(torch.randn(1, 4, 66, device=dev)[:, :, 2:], w)
    with pytest.raises(ValueError, match="contiguous"):
        SM.small_mm_cuda(torch.randn(1, 64, 4, device=dev).transpose(1, 2), w)
    with pytest.raises(ValueError, match="want x"):
        SM.small_mm_cuda(x[0], w[0])


def _decode_counters(cfg, params, dev):
    """The tracing counters of one eager decode step after a prefill of 3
    rows of 20 tokens."""
    from repro_torch.models import apply_model, init_caches

    caches = init_caches(cfg, 3, 64, dtype=F32, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (3, 20), device=dev)
    with torch.no_grad():
        logits, caches, _ = apply_model(params, cfg, {"tokens": tok}, mode="prefill",
                                        caches=caches)
        tracing.enable()
        try:
            apply_model(params, cfg, {"tokens": logits[:, -1:].argmax(-1)}, mode="decode",
                        caches=caches)
        finally:
            tracing.disable()
    return tracing.drain()["counters"]


@pytest.mark.requires_cuda
def test_every_decode_product_of_the_cells_takes_the_kernel(cuda_device):
    """deepseek-67b (2 of its layers) and DeepSeek-V3 as published (4: 3
    dense, 1 MoE with experts 0-7 held) at full width: every product of a
    decode step that goes through ``_mm`` or ``_expert_mm`` takes the
    kernel, none cuBLAS: 7 a llama layer and the head; 5 an MLA layer, 3 a
    dense FFN, 6 an MoE layer (the held experts' 3, the shared expert's
    3) and the head.  Each MLA layer's attention core takes its own
    kernel (``attn.mla_decode``)."""
    from repro_torch.configs.deepseek_v3_671b import published
    from repro_torch.models import get_config, init_model

    cfg = dataclasses.replace(get_config("deepseek-67b"), num_layers=2, dtype="bfloat16")
    params = init_model(cfg, seed=0, device=cuda_device)
    assert _decode_counters(cfg, params, cuda_device) == {"mm.small_rows": 7 * 2 + 1}
    del params
    cfg = published(num_layers=4, held_experts=(0, 8))
    params = init_model(cfg, seed=0, device=cuda_device)
    assert _decode_counters(cfg, params, cuda_device) == {
        "mm.small_rows": 5 * 4 + 3 * 3 + 6 + 1, "attn.mla_decode": 4}


@pytest.mark.requires_cuda
def test_no_training_product_takes_the_kernel(cuda_device):
    """A training step's products want gradients: every one stays on
    cuBLAS, also at 16 rows."""
    from repro_torch.models import apply_model, get_smoke_config, init_model
    from repro_torch.tree import leaves

    cfg = get_smoke_config("smollm-360m")
    params = init_model(cfg, seed=0, device=cuda_device)
    for t in leaves(params):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            t.requires_grad_()
    tok = torch.randint(0, cfg.vocab_size, (2, 8), device=cuda_device)
    tracing.enable()
    try:
        logits = apply_model(params, cfg, {"tokens": tok}, mode="train")[0]
        logits.float().sum().backward()
    finally:
        tracing.disable()
    counters = tracing.drain()["counters"]
    assert "mm.small_rows" not in counters and counters["mm.library"] > 0
