"""DeepSeek-V3 as published in the port, past what the JAX package runs:
the sigmoid group-limited router against a line-by-line transcription of the
published gate (DeepSeek-V3's ``inference/model.py``, ``Gate.forward``),
YaRN's frequencies and scales against a transcription of
``DeepseekV3YarnRotaryEmbedding``, the latent norms, one chip's share of the
expert layer (all shares' parts plus the shared expert once make the uncut
layer), and the whole model against the benchmark's plain reference
(``r2bench/reference/deepseek_v3.py``) on seeded random weights at a small
size: prefill logits, prefill then decode through the latent cache against
the full forward, and the engine's captured decode against its eager one.

Tolerances: float32 residual, products and caches on both sides, so the
gaps are summation order only (atol 1e-4 on logits of order 1); where the
residual is bfloat16 (the engine), tokens are compared, each side its own
run.
"""

import dataclasses
import math
import os
import sys

import numpy as np
import pytest
import torch

from _torch_serve_oracle import plain_tokens
from repro_torch import tracing
from repro_torch.configs.base import YaRNConfig
from repro_torch.configs.deepseek_v3_671b import YARN, published
from repro_torch.models import apply_model, get_smoke_config, init_caches, init_model
from repro_torch.models import mla, moe
from repro_torch.serving import Request, ServingEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
from r2bench.reference import deepseek_v3 as ref  # noqa: E402
from r2bench.reference.llama import Precision  # noqa: E402

ATOL = 1e-4


def gate(x, weight, bias, topk, n_groups, topk_groups, route_scale):
    """DeepSeek-V3's ``inference/model.py`` ``Gate.forward`` for
    ``score_func="sigmoid"`` with a bias, line by line (``weight`` (E, d))."""
    scores = torch.nn.functional.linear(x, weight)
    scores = scores.sigmoid()
    original_scores = scores
    scores = scores + bias
    if n_groups > 1:
        scores = scores.view(x.size(0), n_groups, -1)
        group_scores = scores.topk(2, dim=-1)[0].sum(dim=-1)
        indices = group_scores.topk(topk_groups, dim=-1)[1]
        mask = scores.new_ones(x.size(0), n_groups, dtype=bool).scatter_(1, indices, False)
        scores = scores.masked_fill_(mask.unsqueeze(-1), float("-inf")).flatten(1)
    indices = torch.topk(scores, topk, dim=-1)[1]
    weights = original_scores.gather(1, indices)
    weights /= weights.sum(dim=-1, keepdim=True)
    weights *= route_scale
    return weights.type_as(x), indices


def hf_gate(x, weight, bias, top_k, n_group, topk_group, scale):
    """HF ``modeling_deepseek.py``'s ``MoEGate`` (``noaux_tc``): masked
    groups filled with 0.0, unsorted top-k; the same choice wherever no
    kept expert scores at or below 0 and no score ties."""
    n = x.shape[0]
    scores = torch.nn.functional.linear(x.float(), weight.float()).sigmoid()
    choice = scores + bias[None]
    group_scores = choice.view(n, n_group, -1).topk(2, dim=-1)[0].sum(dim=-1)
    group_idx = torch.topk(group_scores, k=topk_group, dim=-1, sorted=False)[1]
    group_mask = torch.zeros_like(group_scores).scatter_(1, group_idx, 1)
    score_mask = group_mask.unsqueeze(-1).expand(n, n_group, scores.shape[1] // n_group)
    score_mask = score_mask.reshape(n, -1)
    tmp = choice.masked_fill(~score_mask.bool(), 0.0)
    _, idx = torch.topk(tmp, k=top_k, dim=-1, sorted=False)
    w = scores.gather(1, idx)
    return w / (w.sum(-1, keepdim=True) + 1e-20) * scale, idx


def _router(seed, n, d, E, bias_std=0.1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g)
    w = torch.randn(d, E, generator=g) * d ** -0.5
    b = torch.randn(E, generator=g) * bias_std
    return x, {"router": w, "router_bias": b}


@pytest.mark.parametrize("E,n_group,topk_group,k", [(256, 8, 4, 8), (64, 8, 3, 6),
                                                     (32, 4, 2, 4), (16, 1, 1, 2)])
def test_router_equals_the_published_gate(E, n_group, topk_group, k):
    """Random scores: the same experts in the same order and the same
    weights as ``Gate.forward``; the same sets as HF's ``MoEGate``."""
    x, p = _router(E + k, 300, 48, E)
    _, w, i = moe.route(p, x, k, "sigmoid", n_group, topk_group, 2.5)
    gw, gi = gate(x, p["router"].T, p["router_bias"], k, n_group, topk_group, 2.5)
    assert torch.equal(i, gi)
    torch.testing.assert_close(w, gw, rtol=1e-6, atol=0)
    hw, hi = hf_gate(x, p["router"].T, p["router_bias"], k, n_group, topk_group, 2.5)
    assert torch.equal(i.sort(-1).values, hi.sort(-1).values)
    torch.testing.assert_close(w.gather(1, i.argsort(-1)).sort(-1).values,
                               hw.sort(-1).values, rtol=1e-6, atol=0)


def test_router_group_masking_and_ties():
    """Scores that tie: a zero router (every score 0.5) and a bias with
    repeated values, so groups tie on their two best and experts tie inside
    the kept groups; the choice is the published gate's, tie for tie.  Only
    kept groups' experts are chosen, and a group whose best experts would
    win globally is dropped when its two best sum lower."""
    E, G, TG, k = 32, 4, 2, 4
    x = torch.randn(5, 16)
    bias = torch.tensor([0.3, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,      # group 0: one high
                         0.2, 0.2, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,      # group 1: two ties
                         0.2, 0.2, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,      # group 2: the same
                         0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1])     # group 3: all tied
    p = {"router": torch.zeros(16, E), "router_bias": bias}
    _, w, i = moe.route(p, x, k, "sigmoid", G, TG, 2.5)
    gw, gi = gate(x, p["router"].T, bias, k, G, TG, 2.5)
    assert torch.equal(i, gi) and torch.equal(w, gw)
    # groups 1 and 2 (0.4 + 1.0 each) beat group 0 (0.3 + 1.0) and 3 (0.2 + 1.0)
    assert set(i[0].tolist()) >= {8, 9, 16, 17} and not (i < 8).any() and not (i >= 24).any()
    torch.testing.assert_close(w, torch.full_like(w, 2.5 / k))


def _hf_yarn(dim, base, factor, orig, beta_fast, beta_slow, mscale, mscale_all_dim):
    """HF ``DeepseekV3YarnRotaryEmbedding``: (inv_freq, cos/sin multiplier)
    and the attention's softmax multiplier."""
    def find_dim(num_rot):
        return (dim * math.log(orig / (num_rot * 2 * math.pi))) / (2 * math.log(base))
    low = max(math.floor(find_dim(beta_fast)), 0)
    high = min(math.ceil(find_dim(beta_slow)), dim - 1)

    def get_mscale(scale=1, m=1):
        return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    freq_inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    hi = high + 0.001 if low == high else high
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (hi - low), 0, 1)
    inv_freq_mask = 1.0 - ramp
    inv_freq = freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask
    rope_m = get_mscale(factor, mscale) / get_mscale(factor, mscale_all_dim)
    soft = get_mscale(factor, mscale_all_dim) ** 2 if mscale_all_dim else 1.0
    return inv_freq, rope_m, soft


@pytest.mark.parametrize("yarn", [YARN, YaRNConfig(factor=40.0, mscale=0.707,
                                                   mscale_all_dim=0.707),
                                  YaRNConfig(factor=4.0, original_max_position_embeddings=128,
                                             beta_fast=8.0, mscale=1.0, mscale_all_dim=0.5)],
                         ids=["v3", "v2", "other"])
def test_yarn_frequencies_and_scales(yarn):
    """The port's YaRN frequencies, rotary mscale and softmax scale are HF's
    (V3's: the softmax scale 192**-0.5 times (0.1 ln 40 + 1)**2 = 1.8739);
    rope at those frequencies is the split-half rotation of each pair."""
    inv, rope_m, soft = _hf_yarn(64, 10_000.0, yarn.factor, yarn.original_max_position_embeddings,
                                 yarn.beta_fast, yarn.beta_slow, yarn.mscale,
                                 yarn.mscale_all_dim)
    torch.testing.assert_close(mla.yarn_frequencies(64, 10_000.0, yarn), inv, rtol=0, atol=0)
    assert mla.softmax_scale(192, yarn) == pytest.approx(192 ** -0.5 * soft, rel=1e-12)
    if yarn is YARN:
        assert soft == pytest.approx(1.8739, abs=1e-4)
    x = torch.randn(2, 7, 3, 64)
    pos = torch.arange(7)[None]
    got = mla._rope(x, pos, 10_000.0, yarn)
    ang = pos[0, :, None].float() * inv
    cos, sin = torch.cos(ang)[:, None] * rope_m, torch.sin(ang)[:, None] * rope_m
    x1, x2 = x.chunk(2, dim=-1)
    torch.testing.assert_close(got, torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(mla._rope(x, pos, 10_000.0, None),
                       mla.apply_rope(x, pos, 10_000.0))


def _mla_params(latent_norms):
    gen = torch.Generator().manual_seed(4)
    p = mla.init_mla(gen, 64, 4, q_lora_rank=24, kv_lora_rank=16, qk_nope_head_dim=16,
                     qk_rope_head_dim=8, v_head_dim=16, latent_norms=latent_norms)
    if latent_norms:
        p["q_norm"] = torch.randn(24, generator=gen) * 0.1
        p["kv_norm"] = torch.randn(16, generator=gen) * 0.1
    return p


DIMS = dict(num_heads=4, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)


def test_latent_norms():
    """With ``q_norm`` and ``kv_norm`` the latents are RMS-normed (float32,
    eps 1e-6, times 1 + scale) before their up-projections, and the cache
    holds the normed kv latent; without them MLA is the JAX package's.
    Train mode equals MLA on params whose W_uq and W_uk/W_uv take the norm
    of a latent that is already unit-RMS."""
    p = _mla_params(True)
    x = torch.randn(2, 9, 64)
    cache = mla.init_mla_cache(2, 12, 16, 8, dtype=torch.float32)
    y, cache = mla.mla_attention(p, x, cache=cache, mode="prefill", **DIMS)
    ckv = x @ p["w_dkv"]
    normed = ckv * torch.rsqrt(ckv.square().mean(-1, keepdim=True) + 1e-6) * (1 + p["kv_norm"])
    torch.testing.assert_close(cache.c_kv[:, :9], normed, rtol=1e-6, atol=1e-6)
    c = {"num_attention_heads": 4, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
         "v_head_dim": 16, "kv_lora_rank": 16, "q_lora_rank": 24, "rms_norm_eps": 1e-6,
         "rope_theta": 10_000.0,
         "rope_scaling": {"factor": 1, "original_max_position_embeddings": 4096,
                          "beta_fast": 32, "beta_slow": 1, "mscale": 1, "mscale_all_dim": 0}}
    want = ref.mla(p, x, c, Precision(residual="float32"), block=4)
    torch.testing.assert_close(y, want, rtol=0, atol=ATOL)
    plain = {k: v for k, v in p.items() if k not in ("q_norm", "kv_norm")}
    y0, _ = mla.mla_attention(plain, x, mode="train", **DIMS)
    assert not torch.allclose(y0, y, atol=1e-3)
    assert set(_mla_params(False)) == set(mla.MLA_AXES)


def _experts(seed, E, d, ff, shared=True):
    g = torch.Generator().manual_seed(seed)
    p = moe.init_moe(g, d, ff, E, 1 if shared else 0, "swiglu", router_bias=True)
    p["router_bias"] = torch.randn(E, generator=g) * 0.1
    return p


def _share(p, first, count):
    """Chip ``first // count``'s params: the router whole, its experts, the
    shared expert left out (added once over the shares)."""
    return {k: (v[first:first + count] if k in ("wg", "wu", "wd") else v)
            for k, v in p.items() if not k.startswith("shared_")}


@pytest.mark.parametrize("decode", [False, True], ids=["prefill", "decode"])
def test_shares_of_the_expert_layer_add_up_to_the_uncut_layer(decode):
    """64 experts in 8 groups (top-4 groups, top-8 experts) over 32 chips of
    2 experts each: every chip routes over all 64 and computes its own
    experts' part; the 32 parts plus the shared expert once equal the layer
    holding all 64, the plain reference's uncut layer, and in prefill the
    dropless dense oracle over the same routing."""
    E, d, ff, n = 64, 32, 16, 2
    p = _experts(1, E, d, ff)
    x = torch.randn(3, 1 if decode else 11, d)
    kw = dict(num_experts=E, top_k=8, activation="swiglu", scoring="sigmoid", n_group=8,
              topk_group=4, routed_scaling_factor=2.5, decode=decode)
    parts = [moe.moe_ffn_held(_share(p, s * n, n), x, held=(s * n, n), **kw)
             for s in range(E // n)]
    shared = moe._shared_experts(p, x.reshape(-1, d), "swiglu").view_as(x)
    total = torch.stack(parts).sum(0) + shared
    whole = moe.moe_ffn_held(p, x, held=(0, E), **kw)
    torch.testing.assert_close(total, whole, rtol=0, atol=1e-5)
    c = {"n_group": 8, "topk_group": 4, "num_experts_per_tok": 8, "routed_scaling_factor": 2.5,
         "first_held_expert": 0, "n_routed_experts": E}
    want = ref.moe(p, x, c, Precision(residual="float32"))
    torch.testing.assert_close(whole, want, rtol=0, atol=1e-5)
    # a share computes only what its experts are routed: zero where none is
    _, _, top_i = moe.route(p, x.reshape(-1, d), 8, "sigmoid", 8, 4, 2.5)
    for s, part in enumerate(parts):
        mine = ((top_i >= s * n) & (top_i < s * n + n)).any(-1).view(x.shape[:2])
        assert not part[~mine].any()


def test_held_layer_counts_what_it_computes():
    """Prefill counts its slots on the host and records its two spans;
    decode counts nothing and launches nothing for it; the route log keeps
    both calls' choices, decode's in its ring on the device."""
    E, d = 32, 16
    p = _share(_experts(2, E, d, 8), 8, 8)
    kw = dict(num_experts=E, top_k=4, held=(8, 8), scoring="sigmoid", n_group=4, topk_group=2)
    x = torch.randn(4, 6, d)
    _, _, top_i = moe.route(p, x.reshape(-1, d), 4, "sigmoid", 4, 2)
    held = int(((top_i >= 8) & (top_i < 16)).sum())
    moe.log_routes("cpu", rows=4, top_k=4, calls=2)
    tracing.enable()
    try:
        moe.moe_ffn_held(p, x, **kw)
        moe.moe_ffn_held(p, x[:, :1], decode=True, **kw)
        pre, dec = moe.take_routes("cpu")
    finally:
        tracing.disable()
        rec = tracing.drain()
        moe.stop_routes("cpu")
    assert rec["counters"] == {"moe.tokens": 24, "moe.held_slots": held,
                               "moe.expert_rows": held, "moe.dropped": 0}
    assert [s.name for s in rec["spans"]] == ["moe.route", "moe.experts"]
    assert len(pre) == 1 and torch.equal(pre[0], top_i)
    assert dec.shape == (1, 4, 4)
    assert torch.equal(dec[0].long(), top_i.view(4, 6, 4)[:, 0])


# ---------------------------------------------------------------------------
# the model against the plain reference
# ---------------------------------------------------------------------------

def tiny(dtype="float32"):
    """deepseek-v3-smoke's widths, 32 experts in 4 groups (2 kept, top-4),
    experts 8..15 held, 4 layers (1 dense), as published otherwise."""
    s = get_smoke_config("deepseek-v3-671b")
    s = dataclasses.replace(s, moe=dataclasses.replace(s.moe, num_experts=32, top_k=4))
    return published(s, held_experts=(8, 8), n_group=4, topk_group=2, num_layers=4, dtype=dtype)


def ref_config(cfg):
    a, m = cfg.attention, cfg.moe
    y = a.yarn
    return {"num_attention_heads": a.num_heads, "q_lora_rank": a.q_lora_rank,
            "kv_lora_rank": a.kv_lora_rank, "qk_nope_head_dim": a.qk_nope_head_dim,
            "qk_rope_head_dim": a.qk_rope_head_dim, "v_head_dim": a.v_head_dim,
            "rms_norm_eps": 1e-6, "rope_theta": a.rope_theta,
            "rope_scaling": {"factor": y.factor, "beta_fast": y.beta_fast,
                             "beta_slow": y.beta_slow, "mscale": y.mscale,
                             "mscale_all_dim": y.mscale_all_dim,
                             "original_max_position_embeddings":
                                 y.original_max_position_embeddings},
            "n_group": m.n_group, "topk_group": m.topk_group, "num_experts_per_tok": m.top_k,
            "routed_scaling_factor": m.routed_scaling_factor,
            "first_held_expert": m.held_experts[0], "n_routed_experts": m.held_experts[1]}


@pytest.fixture(scope="module")
def model():
    """Weights with every norm scale and the router bias drawn (the port
    initialises them at 0)."""
    cfg = tiny()
    params = init_model(cfg, seed=3, device="cpu")
    g = torch.Generator().manual_seed(9)

    def draw(tree):
        for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
            if isinstance(v, torch.Tensor):
                if k in ("scale", "q_norm", "kv_norm", "router_bias"):
                    v.copy_(torch.randn(v.shape, generator=g) * 0.1)
            else:
                draw(v)
    draw(params)
    return cfg, params


def _routes(cfg, params, tokens):
    """The port's prefill logits and each MoE layer's chosen experts."""
    routes, route = [], moe.route

    def recording(*a, **kw):
        out = route(*a, **kw)
        routes.append(out[2])
        return out
    moe.route = recording
    try:
        caches = init_caches(cfg, tokens.shape[0], tokens.shape[1], dtype=torch.float32,
                             device="cpu")
        logits, caches, _ = apply_model(params, cfg, {"tokens": tokens}, mode="prefill",
                                        caches=caches)
    finally:
        moe.route = route
    return logits, routes


def test_prefill_logits_match_the_reference(model):
    """The last position's logits of a batch of 2, each MoE layer routed as
    the reference routes it itself."""
    cfg, params = model
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 13)))
    got, routes = _routes(cfg, params, tokens)
    own = []
    p = Precision(residual="float32")
    xn = ref.hidden(params, ref_config(cfg), tokens, p, routes=own)
    assert all(torch.equal(a, b) for a, b in zip(routes, own, strict=True))
    torch.testing.assert_close(got[:, -1], ref.logits(params, xn[:, -1], p), rtol=0, atol=ATOL)


@pytest.mark.parametrize("device_index", [False, True])
def test_decode_through_the_latent_cache_matches_the_full_forward(model, device_index):
    """Prefill 9 tokens, then decode 7 given tokens one at a time through
    the cache (its position a host int, or on the device): each step's
    logits equal the reference's full forward at that position."""
    cfg, params = model
    seq = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)))
    caches = init_caches(cfg, 2, 24, dtype=torch.float32, device="cpu",
                         device_index=device_index)
    logits, caches, _ = apply_model(params, cfg, {"tokens": seq[:, :9]}, mode="prefill",
                                    caches=caches)
    got = [logits[:, -1]]
    for t in range(9, 16):
        logits, caches, _ = apply_model(params, cfg, {"tokens": seq[:, t:t + 1]},
                                        mode="decode", caches=caches)
        got.append(logits[:, -1])
    p = Precision(residual="float32")
    want = ref.logits(params, ref.hidden(params, ref_config(cfg), seq, p), p)
    torch.testing.assert_close(torch.stack(got, 1), want[:, 8:], rtol=0, atol=ATOL)
    index = caches["blocks"][0].index
    assert (index.tolist() == [16] * 3) if device_index else index == 16


def _requests(cfg, n, plen, new, seed):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, plen - i % 3), max_new_tokens=new)
            for i in range(n)]


def calls_step(step):
    step()
    return step


def test_captured_decode_equals_eager_decode():
    """The engine at the bfloat16 residual: B 4, 3 and 1 through the capture
    seam (static buffers, the device position, the padded rows of the
    4-row graph) give the plain oracle's tokens; one capture a row count,
    one replay a decode step; the route log holds the same choices for the
    real rows either way, the graph's at its 4 rows."""
    cfg = tiny("bfloat16")
    params = init_model(cfg, seed=5, device="cpu")
    graph = ServingEngine(cfg, params, context_len=48, device="cpu", capture=calls_step)
    assert graph.capture is calls_step
    batches = [_requests(cfg, 4, 20, 6, 1), _requests(cfg, 3, 14, 9, 2),
               _requests(cfg, 1, 11, 5, 3)]
    moe.log_routes("cpu", rows=4, top_k=cfg.moe.top_k, calls=64)
    tracing.enable()
    try:
        got, logged = [], []
        for reqs in batches:
            got.append([r.tokens for r in graph.run_batch(reqs)])
            logged.append(moe.take_routes("cpu"))
    finally:
        tracing.disable()
        rec = tracing.drain()
    try:
        for reqs, tokens, (pre, dec) in zip(batches, got, logged):
            assert tokens == plain_tokens(cfg, params, reqs, context_len=48)
            epre, edec = moe.take_routes("cpu")
            B, n = len(reqs), len(pre)
            # 3 MoE layers; the first batch's log also holds the seam's
            # call at each capture (1, 2 and 4 rows) before its steps
            assert n == 3 and all(torch.equal(a, b) for a, b in zip(pre, epre))
            assert torch.equal(dec[dec.shape[0] - edec.shape[0]:, :B], edec[:, :B])
    finally:
        moe.stop_routes("cpu")
    steps = [5, 8, 4]
    assert [dec.shape[0] for _, dec in logged] == [3 * (3 + 5), 3 * 8, 3 * 4]
    engine_counts = {k: v for k, v in rec["counters"].items() if k.startswith("engine.")}
    assert engine_counts == {"engine.graph_capture": 3, "engine.graph_replay": sum(steps)}
