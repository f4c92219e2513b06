"""The serving engine's decode step on static buffers, replayed as one CUDA
graph on the card.

On the CPU: GQA decode, which reads its position on the device, against the
host-index algorithm it replaced (bit for bit, with a ring buffer that
wraps); the engine's static buffers and padding through a capture seam that
calls the step, against the plain oracle (``_torch_serve_oracle.py``); the
counters.  On the card (``requires_cuda``): a real capture against eager
calls on the same static buffers and the plain oracle.  This file imports
no JAX:

    PYTHONPATH=src python -m pytest -m requires_cuda tests/test_torch_decode_graph.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_serve_oracle import plain_tokens
from repro_torch import tracing
from repro_torch.configs.deepseek_v3_671b import published
from repro_torch.models import apply_model, get_config, get_smoke_config, init_caches, init_model
from repro_torch.models import layers as L
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.engine import graph_rows


def calls_step(step):
    """The capture seam on the CPU: a warm-up call, as ``cuda_graph`` makes
    one, then each replay calls ``step``."""
    step()
    return step


def _host_index_decode(params, x, *, num_kv_heads, num_heads, head_dim, rope_theta=10_000.0,
                       use_rope=True, window=None, logit_cap=None, cache=None, **_):
    """GQA decode as it was before the position moved to the device: the
    cache's Python ``index`` for RoPE, the ring slot and the mask."""
    B, T, d = x.shape
    G = num_heads // num_kv_heads
    q = L._project(x, params["wq"])
    k = L._project(x, params["wk"])
    v = L._project(x, params["wv"])
    wo = params["wo"].reshape(num_heads * head_dim, d)
    pos = cache.index
    if use_rope:
        p = torch.full((B, 1), pos, device=x.device)
        q = L.apply_rope(q, p, rope_theta)
        k = L.apply_rope(k, p, rope_theta)
    S = cache.k.shape[1]
    slot = pos % S
    cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
    cache.positions[:, slot] = pos
    qg = q.reshape(B, 1, num_kv_heads, G, head_dim)
    out = L.decode_attention(qg, cache.k, cache.v, q_position=pos, window=window,
                             logit_cap=logit_cap, k_positions=cache.positions[0])
    y = L._mm(out.reshape(B, 1, num_heads * head_dim), wo)
    return y, L.KVCache(cache.k, cache.v, cache.positions, pos + 1)


def _prefill_and_decode(cfg, params, prompts, steps):
    caches = init_caches(cfg, prompts.shape[0], 64, dtype=torch.float32, device="cpu")
    logits, caches, _ = apply_model(params, cfg, {"tokens": prompts}, mode="prefill",
                                    caches=caches)
    out = [logits]
    tok = logits[:, -1].argmax(-1)
    for _ in range(steps):
        logits, caches, _ = apply_model(params, cfg, {"tokens": tok[:, None]},
                                        mode="decode", caches=caches)
        out.append(logits)
        tok = logits[:, -1].argmax(-1)
    return out, caches


@pytest.mark.parametrize("arch,prompt_len", [("glm4-9b", 12), ("gemma2-27b", 24),
                                             ("recurrentgemma-9b", 24)])
def test_device_position_decode_equals_host_index_decode(arch, prompt_len, monkeypatch):
    """Logits and caches equal to the bit over 20 decode steps: GQA, and the
    16-slot windows of gemma2-smoke and recurrentgemma-smoke, which prefill
    wraps and decode wraps again."""
    cfg = get_smoke_config(arch)
    params = init_model(cfg, seed=0, device="cpu")
    prompts = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size,
                                                                (3, prompt_len)))
    got, got_caches = _prefill_and_decode(cfg, params, prompts, 20)
    gqa = L.gqa_attention

    def host_index(params, x, *, mode, **kw):
        if mode == "decode":
            return _host_index_decode(params, x, **kw)
        return gqa(params, x, mode=mode, **kw)

    monkeypatch.setattr(L, "gqa_attention", host_index)
    want, want_caches = _prefill_and_decode(cfg, params, prompts, 20)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for name, group in want_caches.items():
        for g, w in zip(got_caches[name], group):
            for f in dataclasses.fields(w):
                a, b = getattr(g, f.name), getattr(w, f.name)
                assert torch.equal(a, b) if isinstance(b, torch.Tensor) else a == b


def _requests(cfg, n, plen, new, seed):
    rng = np.random.default_rng(seed)
    # prompt lengths differ inside a batch: the engine left-pads to the longest
    return [Request(prompt=rng.integers(0, cfg.vocab_size, plen - i % 3), max_new_tokens=new)
            for i in range(n)]


def _tokens(engine, reqs):
    return [r.tokens for r in engine.run_batch(reqs)]


@pytest.mark.parametrize("G,rows", [(1, [1]), (2, [1, 2]), (3, [1, 2, 3]), (6, [1, 2, 4, 6]),
                                    (16, [1, 2, 4, 8, 16]), (20, [1, 2, 4, 8, 16, 20])])
def test_graph_rows(G, rows):
    assert graph_rows(G) == rows


@pytest.mark.parametrize("arch", ["glm4-9b", "gemma2-27b", "recurrentgemma-9b", "rwkv6-1.6b",
                                  "deepseek-v3-671b"])
def test_one_set_of_captures_serves_smaller_batches(arch):
    """B 16, then 5 (in the 8-row graph), then 1, from the captures made at
    16 rows, the padded rows holding what the earlier batches left
    (gemma2-smoke's and recurrentgemma-smoke's 24-token prompts wrap their
    16-slot windows; the recurrent states start from zero again): each
    batch's tokens equal the plain oracle's.  The counters read one
    capture a row count of ``graph_rows(16)`` and one replay a decode
    step."""
    cfg = get_smoke_config(arch)
    params = init_model(cfg, seed=0, device="cpu")
    graph = ServingEngine(cfg, params, context_len=64, device="cpu", capture=calls_step)
    batches = [_requests(cfg, 16, 24, 6, 1), _requests(cfg, 5, 12, 9, 2),
               _requests(cfg, 1, 20, 4, 3)]
    tracing.enable()
    try:
        got = [_tokens(graph, reqs) for reqs in batches]
    finally:
        tracing.disable()
        rec = tracing.drain()
    for reqs, tokens in zip(batches, got):
        assert tokens == plain_tokens(cfg, params, reqs, context_len=64)
    steps = sum(max(r.max_new_tokens for r in reqs) - 1 for reqs in batches)
    assert rec["counters"] == {"engine.graph_capture": 5, "engine.graph_replay": steps}
    assert graph._graph_rows == 16 and sorted(graph._replays) == [1, 2, 4, 8, 16]


def test_a_larger_batch_captures_again():
    """B 3 (captured at 1, 2 and 3 rows), then 6 (buffers of 6 rows, captured
    again at 1, 2, 4 and 6), then 2: tokens as the plain oracle's."""
    cfg = get_smoke_config("glm4-9b")
    params = init_model(cfg, seed=0, device="cpu")
    graph = ServingEngine(cfg, params, context_len=64, device="cpu", capture=calls_step)
    batches = [_requests(cfg, n, 10, 5, seed) for n, seed in ((3, 4), (6, 5), (2, 6))]
    tracing.enable()
    try:
        got = [_tokens(graph, reqs) for reqs in batches]
    finally:
        tracing.disable()
        rec = tracing.drain()
    for reqs, tokens in zip(batches, got):
        assert tokens == plain_tokens(cfg, params, reqs, context_len=64)
    assert rec["counters"] == {"engine.graph_capture": 7, "engine.graph_replay": 12}


def test_mla_serves_through_the_capture_seam():
    """The engine's MLA caches hold their position on the device
    (``init_caches(device_index=True)``), so the captured step reads
    nothing from the host: two batches through the seam, tokens equal to
    the plain oracle's, one replay a step."""
    cfg = get_smoke_config("deepseek-v3-671b")
    params = init_model(cfg, seed=0, device="cpu")
    engine = ServingEngine(cfg, params, context_len=64, device="cpu", capture=calls_step)
    assert engine.capture is calls_step
    batches = [_requests(cfg, 2, 12, 4, 7), _requests(cfg, 3, 10, 6, 8)]
    tracing.enable()
    try:
        got = [_tokens(engine, reqs) for reqs in batches]
    finally:
        tracing.disable()
        rec = tracing.drain()
    assert rec["counters"] == {"engine.graph_capture": 2 + 3, "engine.graph_replay": 3 + 5}
    for reqs, tokens in zip(batches, got):
        assert tokens == plain_tokens(cfg, params, reqs, context_len=64)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.requires_cuda
def test_cuda_graph_equals_eager_decode(cuda_device):
    """smollm-360m's widths at 4 of its 32 layers, fp32 cache of 128
    positions: the captured engine serves B 16, 7, 1, then 7 again, and its
    tokens equal those of eager calls of the step on the same static
    buffers (the CPU's seam on the card), to the bit; B 16 equals the plain
    oracle's (the same shapes); the B 7 served after B 1 equals B 7
    served right after another B 16.  One capture a row count of
    ``graph_rows(16)``, one replay a step; the layers' products of every
    captured step take the small-row kernel (4 layers x 7, in the warm-up
    call and the capture of each of the 5 row counts), the tied head
    cuBLAS."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=4)
    params = init_model(cfg, seed=0, device="cuda")

    def engine(**kw):
        return ServingEngine(cfg, params, context_len=128, cache_dtype=torch.float32,
                             device="cuda", **kw)

    graph, stepped = engine(), engine(capture=calls_step)
    batches = [_requests(cfg, 16, 64, 24, 11), _requests(cfg, 7, 48, 24, 12),
               _requests(cfg, 1, 40, 24, 13), _requests(cfg, 7, 56, 24, 14)]
    tracing.enable()
    try:
        got = [_tokens(graph, reqs) for reqs in batches]
    finally:
        tracing.disable()
        rec = tracing.drain()
    engine_counts = {k: v for k, v in rec["counters"].items() if k.startswith("engine.")}
    assert engine_counts == {"engine.graph_capture": 5, "engine.graph_replay": 4 * 23}
    assert rec["counters"]["mm.small_rows"] == 5 * 2 * 4 * 7
    for reqs, tokens in zip(batches, got):
        assert tokens == _tokens(stepped, reqs)
    assert got[0] == plain_tokens(cfg, params, batches[0], context_len=128, device="cuda")
    fresh = engine()
    fresh.run_batch(_requests(cfg, 16, 64, 8, 15))
    assert got[3] == _tokens(fresh, batches[3])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["smollm-360m", "paper-7b", "glm4-9b", "gemma2-27b",
                                  "deepseek-67b", "dbrx-132b", "recurrentgemma-9b",
                                  "rwkv6-1.6b", "deepseek-v3-671b"])
def test_cuda_graph_captures_every_family(cuda_device, arch):
    """Each family the engine captures, at its smoke size: B 4 then B 3 (24
    tokens wrap the 16-slot windows), tokens equal to eager calls of the step
    on the same static buffers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    params = init_model(cfg, seed=0, device="cuda")
    graph, stepped = (ServingEngine(cfg, params, context_len=64, device="cuda", capture=c)
                      for c in (None, calls_step))
    for reqs in (_requests(cfg, 4, 24, 10, 21), _requests(cfg, 3, 16, 12, 22)):
        assert _tokens(graph, reqs) == _tokens(stepped, reqs)
    assert graph._graph_rows == 4


@pytest.mark.requires_cuda
def test_mla_graph_decode_equals_eager_at_the_cells_widths(cuda_device):
    """DeepSeek-V3 as published at full width (d 7168, 128 MLA heads with
    the latent norms and YaRN, the sigmoid router over 256 experts, experts
    0-7 held), 5 of its layers (3 dense, 2 MoE: a stacked group of two),
    fp32 cache of 512 positions, one batch of 6 rows (captured at 1, 2, 4
    and 6): the captured engine's tokens equal eager calls of the step on
    the same static buffers and the plain oracle's, to the bit; one
    capture a row count, one replay a decode step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = published(num_layers=5, held_experts=(0, 8))
    params = init_model(cfg, seed=0, device="cuda")

    def engine(**kw):
        return ServingEngine(cfg, params, context_len=512, cache_dtype=torch.float32,
                             device="cuda", **kw)

    graph, stepped = engine(), engine(capture=calls_step)
    reqs = _requests(cfg, 6, 200, 12, 31)
    tracing.enable()
    try:
        got = _tokens(graph, reqs)
    finally:
        tracing.disable()
        rec = tracing.drain()
    engine_counts = {k: v for k, v in rec["counters"].items() if k.startswith("engine.")}
    assert engine_counts == {"engine.graph_capture": 4, "engine.graph_replay": 11}
    assert sorted(graph._replays) == [1, 2, 4, 6]
    assert got == _tokens(stepped, reqs) == plain_tokens(cfg, params, reqs, context_len=512,
                                                         device="cuda")


@pytest.mark.requires_cuda
def test_gqa_graph_decode_equals_eager_at_the_cells_widths(cuda_device):
    """deepseek-67b at full width (d 8192, 64 / 8 heads, d_ff 22016, the
    untied head of 102400), 2 of its layers, the bf16 residual, fp32 cache
    of 256 positions, one batch of 6 rows (captured at 1, 2, 4 and 6):
    every product of a captured step takes the small-row kernel (2 layers
    x 7 and the head, in the warm-up call and the capture of each row
    count; the prefill's head at 6 rows too), and the captured engine's
    tokens equal eager calls of the step on the same static buffers and the
    plain oracle's, to the bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("deepseek-67b"), num_layers=2, dtype="bfloat16")
    params = init_model(cfg, seed=0, device="cuda")

    def engine(**kw):
        return ServingEngine(cfg, params, context_len=256, cache_dtype=torch.float32,
                             device="cuda", **kw)

    graph, stepped = engine(), engine(capture=calls_step)
    reqs = _requests(cfg, 6, 120, 12, 41)
    tracing.enable()
    try:
        got = _tokens(graph, reqs)
    finally:
        tracing.disable()
        rec = tracing.drain()
    assert rec["counters"]["engine.graph_replay"] == 11
    assert rec["counters"]["mm.small_rows"] == 4 * 2 * (2 * 7 + 1) + 1
    assert got == _tokens(stepped, reqs) == plain_tokens(cfg, params, reqs, context_len=256,
                                                         device="cuda")
