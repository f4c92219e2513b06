"""The port's Hopper kernels against their plain versions on the card.

Marked ``requires_cuda``: without a CUDA device they skip (a CUDA kernel
has no CPU mode).  This file imports no JAX, so it also runs on a machine
with the card and without JAX:

    PYTHONPATH=src python -m pytest -m requires_cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape,dtype,kw", [
    ((4, 512, 512, 5, 3, 64), torch.float32, {}),
    ((2, 256, 256, 32, 1, 128), torch.bfloat16, {}),
    ((1, 96, 160, 2, 2, 20), torch.float32, dict(causal=False)),
    ((1, 128, 128, 2, 1, 16), torch.float32, dict(window=32, logit_cap=50.0)),
    ((1, 128, 128, 2, 1, 16), torch.float32, dict(prefix_len=8)),
    ((2, 16, 200, 2, 4, 32), torch.float32, dict(q_offset=100, k_valid_len=150)),
    ((2, 2304, 2304, 1, 16, 256), torch.float32, dict(window=2048)),
    ((1, 70, 70, 1, 16, 256), torch.float32, dict(window=33)),
    # the forward's tile edges: one position a CTA (G = 64), hubert's
    # head_dim 80, Tq and Tk off the 64- and 128-row and 32- and 64-key
    # tiles, windowed and prefix, both dtypes
    ((2, 37, 53, 2, 64, 32), torch.float32, {}),
    ((1, 19, 19, 1, 64, 256), torch.bfloat16, dict(window=7)),
    ((2, 100, 100, 2, 4, 80), torch.float32, dict(causal=False)),
    ((2, 100, 100, 2, 4, 80), torch.bfloat16, dict(prefix_len=30)),
    ((1, 97, 131, 3, 3, 64), torch.float32, dict(window=50)),
    ((2, 131, 97, 1, 5, 128), torch.float32, dict(prefix_len=40)),
    ((1, 65, 129, 2, 2, 16), torch.bfloat16, dict(causal=False, window=20)),
    ((1, 300, 300, 1, 16, 256), torch.float32, dict(window=64, prefix_len=20)),
    ((1, 129, 33, 1, 1, 256), torch.float32, dict(logit_cap=30.0)),
    ((2, 8, 300, 2, 8, 128), torch.bfloat16, dict(q_offset=250, k_valid_len=258)),
    # deepseek-v3's MLA prefill: 128 KV heads of one query at head_dim 192
    # (nope 128 + rope 64, v padded to it), on the 256-wide template; off
    # the tiles; a scale other than 1/sqrt(D)
    ((4, 512, 512, 128, 1, 192), torch.float32, dict(scale=192 ** -0.5)),
    ((4, 512, 512, 128, 1, 192), torch.bfloat16, {}),
    ((1, 97, 131, 3, 1, 192), torch.float32, {}),
    ((2, 128, 128, 4, 1, 192), torch.float32, dict(scale=0.05)),
])
def test_flash_attention_kernel_matches_plain(cuda_device, shape, dtype, kw):
    """Tolerance: fp32 atol 1e-4 (summation order), bf16 atol 2e-2."""
    B, tq, tk, KVH, G, D = shape
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((B, tq, KVH, G, D), np.float32))
    k = torch.from_numpy(rng.standard_normal((B, tk, KVH, D), np.float32))
    v = torch.from_numpy(rng.standard_normal((B, tk, KVH, D), np.float32))
    q, k, v = (t.to(cuda_device, dtype) for t in (q, k, v))
    before = ops.launch_counts()["flash_attention"]
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = ref.reference_attention(q, k, v, **kw)
    atol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=atol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape,dtype,kw", [((4, 512, 512, 5, 3, 64), torch.float32, {}),
                                            ((1, 300, 300, 1, 16, 256), torch.float32,
                                             dict(window=64)),
                                            ((2, 256, 256, 32, 1, 128), torch.bfloat16, {})])
def test_flash_attention_forward_is_deterministic(cuda_device, shape, dtype, kw):
    """No cross-CTA sums in the forward: two calls on the same inputs give
    identical output and row log-sum-exp, bit for bit."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    B, tq, tk, KVH, G, D = shape
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q = torch.randn(B, tq, KVH, G, D, device=cuda_device, generator=gen).to(dtype)
    k, v = (torch.randn(B, tk, KVH, D, device=cuda_device, generator=gen).to(dtype)
            for _ in range(2))
    lse = [torch.empty(B, tq, KVH, G, device=cuda_device) for _ in range(2)]
    first, second = (flash_attention_cuda(q, k, v, lse=lse[i], **kw) for i in range(2))
    assert torch.equal(first, second) and torch.equal(lse[0], lse[1])


# the largest merge of the smollm-360m training phase (chip_smoke.py's
# largest_merges(): 3 rows of a whole-buffer step of the embedding's leaf)
LARGEST_MERGE = (3, 13426888)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,m,offset", [(1, 1, 0), (4, 513, 1), (12, 700, 0), (3, 7, 1),
                                        (1024, 37, 0), (1024, 130, 1),
                                        (*LARGEST_MERGE, 0), (*LARGEST_MERGE, 1)])
def test_chunk_combine_kernel_matches_plain(cuda_device, dtype, c, m, offset):
    """Exact: the kernel and the plain version both add in fp32 and round
    once.  ``offset`` starts every row off the 16-byte grid; C = 1024 is
    the most rows the kernel's masks take."""
    rng = np.random.default_rng(c * m)
    flat = torch.from_numpy(rng.standard_normal(2 * c * m + offset, np.float32))
    flat = flat.to(cuda_device, dtype)
    local = flat[offset:offset + c * m].view(c, m)
    recv = flat[offset + c * m:].view(c, m)
    seg, acc = rng.integers(0, 2, c), rng.integers(0, 2, c)
    want = ref.reference_chunk_combine(local, recv, seg, acc)
    before = ops.launch_counts()["chunk_combine"]
    out = ops.chunk_combine(local, recv, seg, acc, out=local)
    torch.cuda.synchronize()
    assert out is local
    assert ops.launch_counts()["chunk_combine"] == before + 1
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def _bwd_cases():
    """(shape, dtype, kw) for the backward: the main paths' shapes, then
    lengths at and around the 64-row / 64-key tiles, ragged Tq != Tk, every
    head_dim tile and group size up to 64, each mask kind, both dtypes."""
    cases = [((2, 512, 512, 5, 3, 64), torch.float32, {}),
             ((2, 256, 256, 32, 1, 128), torch.bfloat16, {}),
             ((1, 96, 160, 2, 2, 20), torch.float32, dict(causal=False)),
             ((1, 128, 128, 2, 1, 16), torch.float32, dict(window=32, logit_cap=50.0)),
             ((1, 128, 128, 2, 1, 16), torch.float32, dict(prefix_len=8))]
    masks = [{}, dict(causal=False), dict(window=16), dict(prefix_len=8),
             dict(logit_cap=20.0)]
    for i, t in enumerate((1, 63, 64, 65, 129)):
        for dtype in (torch.float32, torch.bfloat16):
            cases.append(((1, t, t, 2, 3, 64), dtype, masks[i % len(masks)]))
    for tq, tk in ((65, 129), (129, 63), (1, 70)):
        for kw in ({}, dict(causal=False)):
            cases.append(((2, tq, tk, 1, 2, 20), torch.float32, kw))
    for D in (16, 20, 64, 128, 160, 192, 200, 256):
        for G in (1, 3, 16, 64):
            for dtype in (torch.float32, torch.bfloat16):
                kw = masks[(D + G) % len(masks)]
                cases.append(((1, 33 if G >= 16 else 97, 97, 2, G, D), dtype, kw))
    # above head_dim 128 (the column halves): paligemma-3b's and hubert's
    # training shapes, off the tiles with a window and softcap, a prefix,
    # bf16, and MLA's head_dim 192 with its scale
    cases += [((2, 512, 512, 1, 8, 256), torch.float32, dict(prefix_len=256)),
              ((2, 512, 512, 16, 1, 80), torch.float32, dict(causal=False)),
              ((1, 97, 131, 3, 2, 256), torch.float32, dict(window=40, logit_cap=30.0)),
              ((1, 97, 131, 3, 2, 192), torch.float32, dict(window=40, logit_cap=30.0)),
              ((1, 128, 128, 2, 1, 256), torch.float32, dict(prefix_len=40)),
              ((2, 512, 512, 1, 8, 256), torch.bfloat16, dict(prefix_len=256)),
              ((1, 97, 131, 3, 2, 192), torch.bfloat16, dict(causal=False)),
              ((2, 256, 256, 8, 1, 192), torch.float32, dict(scale=192 ** -0.5))]
    return cases


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape,dtype,kw", _bwd_cases())
def test_flash_attention_backward_matches_plain(cuda_device, shape, dtype, kw):
    """Gradients through ``ops.flash_attention`` (the backward kernel)
    against autograd through the plain version.  Tolerance relative to
    max(1, max |grad|): fp32 1e-3 (a dK entry sums over up to Tq * G rows),
    bf16 3e-2."""
    B, tq, tk, KVH, G, D = shape
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((B, tq, KVH, G, D), np.float32))
    k = torch.from_numpy(rng.standard_normal((B, tk, KVH, D), np.float32))
    v = torch.from_numpy(rng.standard_normal((B, tk, KVH, D), np.float32))
    do = torch.from_numpy(rng.standard_normal((B, tq, KVH, G, D), np.float32))
    q, k, v, do = (t.to(cuda_device, dtype) for t in (q, k, v, do))
    grads = {}
    for impl in ("auto", "reference"):
        qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
        with ops.use(impl):
            out = ops.flash_attention(qa, ka, va, **kw)
            grads[impl] = torch.autograd.grad(out, (qa, ka, va), do)
    torch.cuda.synchronize()
    rtol = 3e-2 if dtype == torch.bfloat16 else 1e-3
    for a, b in zip(grads["auto"], grads["reference"]):
        assert torch.isfinite(a).all()
        scale = max(1.0, b.float().abs().max().item())
        assert (a.float() - b.float()).abs().max().item() <= rtol * scale


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape,dtype", [((2, 512, 512, 5, 3, 64), torch.float32),
                                         ((2, 256, 256, 32, 1, 128), torch.bfloat16),
                                         ((1, 200, 200, 2, 16, 20), torch.float32),
                                         ((2, 512, 512, 1, 8, 256), torch.float32),
                                         ((1, 200, 200, 4, 2, 192), torch.bfloat16)])
def test_flash_attention_backward_is_deterministic(cuda_device, shape, dtype):
    """No atomics on gradients: two calls of the backward kernel on the same
    inputs give identical bits, and so does the autograd path through
    ``ops.flash_attention``."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda, flash_attention_cuda
    B, tq, tk, KVH, G, D = shape
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q, do = (torch.randn(B, tq, KVH, G, D, device=cuda_device, generator=gen).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, tk, KVH, D, device=cuda_device, generator=gen).to(dtype)
            for _ in range(2))
    lse = torch.empty(B, tq, KVH, G, device=cuda_device)
    out = flash_attention_cuda(q, k, v, lse=lse)
    first = flash_attention_bwd_cuda(q, k, v, out, do, lse)
    second = flash_attention_bwd_cuda(q, k, v, out, do, lse)
    qa, ka, va = (t.detach().requires_grad_() for t in (q, k, v))
    via = torch.autograd.grad(ops.flash_attention(qa, ka, va), (qa, ka, va), do)
    for a, b, c in zip(first, second, via):
        assert torch.equal(a, b) and torch.equal(a, c)


def _scan_inputs(shapes, seed, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device)
            for s in shapes]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,t,w,decay", [
    (2, 2304, 4096, "gates"), (3, 37, 100, "gates"), (1, 1, 5, "gates"),
    # the kernel's 128-step tiles and 16-step sub-chunks +-1, W - 3 (off the
    # 32 channels a CTA and the 16-byte copies), B = 1
    (2, 127, 4096, "gates"), (1, 129, 4093, "gates"), (2, 15, 4096, "gates"),
    (1, 17, 4093, "gates"),
    # a = 0 (each h is its x), a = 1 (h a running sum of |x|, growing to ~1800)
    (2, 257, 4096, "zero"), (1, 129, 4093, "zero"), (2, 2304, 4096, "one"),
    (1, 127, 4093, "one"),
])
def test_lru_scan_kernel_matches_plain(cuda_device, b, t, w, decay):
    """a from the model's gate distribution (exp of a negative), or exactly
    0 or 1; nonzero h0; T and B * W off every tile.  Tolerance 1e-5 of
    max(1, |h|): both run the recurrence in fp32 in time order, the kernel
    with fused multiply-adds and each sub-chunk's start folded from the
    sub-chunks before it.  Two calls give the same bits."""
    z, x, h0 = _scan_inputs([(b, t, w), (b, t, w), (b, w)], t + w, cuda_device)
    if decay == "gates":
        a = torch.exp(-8.0 * torch.sigmoid(z) * 0.05)
    else:
        a = torch.full_like(z, 0.0 if decay == "zero" else 1.0)
        x = x.abs() if decay == "one" else x
    before = ops.launch_counts()["lru_scan"]
    out = ops.lru_scan(a, x, h0)
    torch.cuda.synchronize()
    assert ops.launch_counts()["lru_scan"] == before + 1
    want = ref.reference_lru_scan(a, x, h0)
    tol = 1e-5 * max(1.0, want.abs().max().item())
    torch.testing.assert_close(out, want, rtol=0, atol=tol)
    assert torch.equal(out, ops.lru_scan(a, x, h0))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,t,h,k", [(4, 512, 32, 64), (3, 37, 5, 32), (1, 1, 2, 16)])
def test_wkv_scan_kernel_matches_plain(cuda_device, b, t, h, k):
    """w = exp(-exp(dec)) as the model makes it, nonzero s0, T off the
    kernel's 16-step chunk; output and final state.  Tolerance 1e-5 of
    max(1, |value|): fp32, the sum over k in another order."""
    r, kk, v, dec, u, s0 = _scan_inputs(
        [(b, t, h, k)] * 4 + [(h, k), (b, h, k, k)], t * h + k, cuda_device)
    w = torch.exp(-torch.exp(dec - 3.0))
    before = ops.launch_counts()["wkv_scan"]
    out, s_t = ops.wkv_scan(r, kk, v, w, u, s0)
    torch.cuda.synchronize()
    assert ops.launch_counts()["wkv_scan"] == before + 1
    for got, want in zip((out, s_t), ref.reference_wkv(r, kk, v, w, u, s0)):
        tol = 1e-5 * max(1.0, want.abs().max().item())
        torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,t,h,k", [(4, 512, 32, 64), (3, 37, 5, 64), (1, 77, 3, 32),
                                     (5, 19, 1, 16), (2, 33, 7, 64)])
def test_wkv_scan_kernel_matches_plain_at_hard_decays(cuda_device, b, t, h, k):
    """The decays at the ends of what the model makes: dec up to +3, so w
    down to exp(-e^3) ~ 2e-9, and every fifth step's rows w = 1 exactly;
    B * H and T off the kernel's 16-step chunks and its CTAs per (b, h).
    Same tolerance, 1e-5 of max(1, |value|)."""
    r, kk, v, dec, u, s0 = _scan_inputs(
        [(b, t, h, k)] * 4 + [(h, k), (b, h, k, k)], t * h + k + 1, cuda_device)
    w = torch.exp(-torch.exp(torch.clamp(3.0 * dec, -9.0, 3.0)))
    w[:, 2::5] = 1.0
    out, s_t = ops.wkv_scan(r, kk, v, w, u, s0)
    torch.cuda.synchronize()
    for got, want in zip((out, s_t), ref.reference_wkv(r, kk, v, w, u, s0)):
        tol = 1e-5 * max(1.0, want.abs().max().item())
        torch.testing.assert_close(got, want, rtol=0, atol=tol)


GRAD_RTOL = 1e-4    # of max(1, max |grad|): the CPU block gradient tests' bound


def _grad_close(got, want, what=""):
    tol = GRAD_RTOL * max(1.0, want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=0, atol=tol, msg=what)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("family", ["rglru", "rwkv"])
def test_recurrent_block_gradients_match_plain_on_the_card(cuda_device, family):
    """A recurrent block trained on the card runs its scan kernel under
    autograd and the scan's backward kernel, and its gradients with respect
    to every weight and the input match the same block through the plain
    scan (fp32, 1e-4 of max(1, max |grad|)).  T = 40 is off the backward's
    tiles and chunks.  (On the CPU the blocks are held to ``jax.grad``:
    ``test_torch_recurrent.py``.)"""
    from repro_torch.models import rglru, rwkv6
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(2, 40, 64, device=cuda_device, generator=gen)
    dy = torch.randn(2, 40, 64, device=cuda_device, generator=gen)
    if family == "rglru":
        params = rglru.init_rglru_block(gen, 64, 48, 4)
        block = lambda p, x: rglru.rglru_block(p, x, conv_width=4)
    else:
        params = rwkv6.init_rwkv_block(gen, 64, 16, 8, 4)
        block = lambda p, x: rwkv6.rwkv_block(p, x, head_size=16)
    kernel = "lru_scan" if family == "rglru" else "wkv_scan"
    names = sorted(params)
    grads = {}
    for impl in ("auto", "reference"):
        leaves = [params[n].detach().clone().requires_grad_() for n in names]
        xi = x.clone().requires_grad_()
        before = ops.launch_counts()
        with ops.use(impl):
            y, _ = block(dict(zip(names, leaves)), xi)
            grads[impl] = torch.autograd.grad((y * dy).sum(), leaves + [xi])
        torch.cuda.synchronize()
        after = ops.launch_counts()
        ran = {n: after[n] - before[n] for n in after}
        want = {kernel: 1, f"{kernel}_bwd": 1} if impl == "auto" else {}
        assert {n: c for n, c in ran.items() if c} == want
    for n, a, b in zip(names + ["x"], grads["auto"], grads["reference"]):
        _grad_close(a, b, n)


def _lru_grad_inputs(b, t, w, seed, device):
    z, x, h0, gh = _scan_inputs([(b, t, w), (b, t, w), (b, w), (b, t, w)], seed, device)
    a = torch.exp(-8.0 * torch.sigmoid(z) * 0.05)
    return a, x, h0, gh


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,t,w", [
    (2, 512, 4096),                          # recurrentgemma-9b's training shape
    (2, 2304, 4096),                         # its serving prompt
    # the kernel's 128-step tiles and 16-step sub-chunks +-1, W - 3 (off the
    # 32 channels a CTA and the 16-byte copies), T = 1, B = 1
    (1, 129, 4093), (2, 127, 4096), (1, 17, 100), (3, 15, 37), (1, 1, 5), (2, 1, 4096),
])
@pytest.mark.parametrize("want_gh0", [True, False])
def test_lru_scan_bwd_kernel_matches_plain(cuda_device, b, t, w, want_gh0):
    """The backward kernel against autograd through the plain scan, from
    the forward's own output: gx, ga and (when asked) gh0, fp32, 1e-4 of
    max(1, max |grad|).  Through ``ops.lru_scan`` under autograd the forward
    and backward kernels each launch once; two calls give the same bits."""
    from repro_torch.kernels.lru_scan import lru_scan_bwd_cuda
    a, x, h0, gh = _lru_grad_inputs(b, t, w, t + w, cuda_device)
    ins = [a.requires_grad_(), x.requires_grad_(), h0.requires_grad_(want_gh0)]
    want = torch.autograd.grad(ref.reference_lru_scan(*ins), [x, a] + ins[2:][:want_gh0], gh)
    before = ops.launch_counts()
    got = torch.autograd.grad(ops.lru_scan(*ins), [x, a] + ins[2:][:want_gh0], gh)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert (after["lru_scan"] - before["lru_scan"],
            after["lru_scan_bwd"] - before["lru_scan_bwd"]) == (1, 1)
    for name, g, r in zip(("gx", "ga", "gh0"), got, want):
        _grad_close(g, r, name)
    h = ref.reference_lru_scan(a.detach(), x.detach(), h0.detach()).contiguous()
    first = lru_scan_bwd_cuda(a.detach(), h, h0.detach(), gh, want_gh0=want_gh0)
    second = lru_scan_bwd_cuda(a.detach(), h, h0.detach(), gh, want_gh0=want_gh0)
    assert (first[2] is None) == (not want_gh0)
    for f, s in zip(first, second):
        assert f is None or torch.equal(f, s)


def _wkv_grad_inputs(b, t, h, k, hard, seed, device):
    r, kk, v, dec, u, s0, gy, gs = _scan_inputs(
        [(b, t, h, k)] * 4 + [(h, k), (b, h, k, k), (b, t, h, k), (b, h, k, k)],
        seed, device)
    if hard:
        w = torch.exp(-torch.exp(torch.clamp(3.0 * dec, -9.0, 3.0)))
        w[:, 2::5] = 1.0
    else:
        w = torch.exp(-torch.exp(dec - 3.0))
    return [r, kk, v, w, 0.1 * u, s0], gy, gs


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,t,h,k,hard", [
    (2, 512, 32, 64, False),                 # rwkv6-1.6b's training shape
    (2, 512, 32, 64, True),
    # every head size, T off the 16-step chunks, T = 1, B * H odd
    (3, 37, 5, 32, False), (1, 77, 3, 32, True), (5, 19, 1, 16, True),
    (2, 33, 7, 64, True), (1, 1, 2, 16, False), (2, 1, 3, 64, True), (1, 16, 2, 32, False),
    # each head size's cluster (K / min(32, K) CTAs: 1, 1, 2) with B = 1 and
    # B = 3, u's gradient summed over b; a B * H far below a wave (one
    # cluster, 14)
    (1, 40, 3, 16, True), (3, 40, 3, 16, False), (1, 40, 3, 32, False), (3, 40, 3, 32, True),
    (1, 40, 3, 64, True), (3, 40, 3, 64, False), (1, 300, 1, 64, False), (2, 100, 7, 64, True),
])
@pytest.mark.parametrize("with_gs", [False, True])
def test_wkv_scan_bwd_kernel_matches_plain(cuda_device, b, t, h, k, hard, with_gs):
    """The backward kernel (from the forward kernel's per-chunk states)
    against autograd through the plain recurrence: gradients of r, k, v, w,
    u and s0 for the gradient of the output alone (training never reads
    s_T) and with one of s_T too; the model's decays and the hard ones
    (w down to exp(-e^3) ~ 2e-9, every fifth step's rows w = 1).  fp32, 1e-4
    of max(1, max |grad|).  Each kernel launches once; two calls give the
    same bits (no float atomics)."""
    from repro_torch.kernels.wkv_scan import CHUNK, wkv_scan_bwd_cuda, wkv_scan_cuda
    ins, gy, gs = _wkv_grad_inputs(b, t, h, k, hard, t * h + k, cuda_device)
    ins = [x.requires_grad_() for x in ins]
    cot = (gy, gs if with_gs else None)

    def grads(out):        # at T = 1 without gs, w reaches neither output: zeros
        outs = [o for o, c in zip(out, cot) if c is not None]
        gs_ = torch.autograd.grad(outs, ins, [c for c in cot if c is not None],
                                  allow_unused=True)
        return [torch.zeros_like(x) if g is None else g for x, g in zip(ins, gs_)]
    want = grads(ref.reference_wkv(*ins))
    before = ops.launch_counts()
    got = grads(ops.wkv_scan(*ins))
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert (after["wkv_scan"] - before["wkv_scan"],
            after["wkv_scan_bwd"] - before["wkv_scan_bwd"]) == (1, 1)
    for name, g, r in zip(("gr", "gk", "gv", "gw", "gu", "gs0"), got, want):
        _grad_close(g, r, name)
    plain = [x.detach() for x in ins]
    ckpt = torch.empty((b, h, -(-t // CHUNK), k, k), device=cuda_device)
    wkv_scan_cuda(*plain, ckpt)
    first = wkv_scan_bwd_cuda(*plain[:5], ckpt, gy, cot[1])
    second = wkv_scan_bwd_cuda(*plain[:5], ckpt, gy, cot[1])
    for f, s in zip(first, second):
        assert torch.equal(f, s)


@pytest.mark.requires_cuda
def test_wkv_scan_bwd_allocates_only_its_outputs_and_a_small_scratch(cuda_device):
    """At rwkv6-1.6b's training shape the backward's peak memory above its
    inputs is its outputs (gr, gk, gv, gw, gu) plus a scratch of B * H * K
    scale (u's gradient before its sum over b, and H integer tickets): the
    sums over the cluster's columns stay on chip, with no (3, K / 16, B, T,
    H, K) partials (100.7 MB here)."""
    from repro_torch.kernels.wkv_scan import CHUNK, wkv_scan_bwd_cuda, wkv_scan_cuda
    b, t, h, k = 2, 512, 32, 64
    ins, gy, _ = _wkv_grad_inputs(b, t, h, k, False, 0, cuda_device)
    ckpt = torch.empty((b, h, -(-t // CHUNK), k, k), device=cuda_device)
    wkv_scan_cuda(*ins, ckpt)
    wkv_scan_bwd_cuda(*ins[:5], ckpt, gy, None, want_gs0=False)    # built and loaded
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    outs = wkv_scan_bwd_cuda(*ins[:5], ckpt, gy, None, want_gs0=False)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    out_bytes = sum(o.numel() * o.element_size() for o in outs if o is not None)
    assert out_bytes == 4 * (4 * b * t * h * k + h * k)
    assert extra - out_bytes <= 4 * 8 * b * h * k, (extra, out_bytes)


@pytest.mark.requires_cuda
def test_mla_training_gradients_match_plain(cuda_device):
    """MLA at deepseek-v3's widths attends at head_dim 192 (nope 128 + rope
    64): a train step on the card runs the forward kernel under autograd and
    the backward kernel (the 192-wide template), and its gradients match
    the same step through the plain attention, under the backward's fp32
    tolerance (1e-3 of max(1, max |grad|))."""
    from repro_torch.models import mla
    dims = dict(num_heads=2, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = mla.init_mla(gen, 64, 2, q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=128,
                          qk_rope_head_dim=64, v_head_dim=128)
    x = torch.randn(2, 16, 64, device=cuda_device, generator=gen)
    dy = torch.randn(2, 16, 64, device=cuda_device, generator=gen)
    names = sorted(params)
    grads = {}
    for impl in ("auto", "reference"):
        leaves = {n: params[n].detach().clone().requires_grad_() for n in names}
        before = ops.launch_counts()
        with ops.use(impl):
            y, _ = mla.mla_attention(leaves, x, mode="train", **dims)
            grads[impl] = torch.autograd.grad(y, [leaves[n] for n in names], dy)
        after = ops.launch_counts()
        want = 1 if impl == "auto" else 0
        assert after["flash_attention"] == before["flash_attention"] + want
        assert after["flash_attention_bwd"] == before["flash_attention_bwd"] + want
    for n, a, b in zip(names, grads["auto"], grads["reference"]):
        assert torch.isfinite(a).all(), n
        assert (a - b).abs().max().item() <= 1e-3 * max(1.0, b.abs().max().item()), n


@pytest.mark.requires_cuda
def test_backward_above_head_dim_256_raises(cuda_device):
    """head_dim 320 is past the backward kernel's widest template: the
    wrapper raises, naming the limit, and launches nothing; no fallback."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    q = torch.randn(1, 8, 1, 1, 320, device=cuda_device)
    k = torch.randn(1, 8, 1, 320, device=cuda_device)
    lse = torch.zeros(1, 8, 1, 1, device=cuda_device)
    before = ops.launch_counts()["flash_attention_bwd"]
    with pytest.raises(ValueError, match="head_dim <= 256"):
        flash_attention_bwd_cuda(q, k, k, q, q, lse)
    assert ops.launch_counts()["flash_attention_bwd"] == before
