"""The port's dense layers held against the JAX package's on the same numpy
inputs and weights.

Everything here computes in float32 (the bf16 residual stream enters as
exactly representable values), so atol 1e-5 covers the different summation
orders of the two frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as L

ATOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _both(a, dtype="f32"):
    if dtype == "bf16":
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def _params(rng, shapes):
    arrays = {k: (rng.standard_normal(s) * 0.2).astype(np.float32)
              for k, s in shapes.items()}
    return ({k: jnp.asarray(a) for k, a in arrays.items()},
            {k: torch.from_numpy(a) for k, a in arrays.items()})


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms(norm, dtype):
    rng = np.random.default_rng(0)
    jx, tx = _both(rng.standard_normal((2, 5, 24)).astype(np.float32), dtype)
    shapes = {"scale": (24,)} if norm == "rmsnorm" else {"scale": (24,), "bias": (24,)}
    jp, tp = _params(rng, shapes)
    out = getattr(L, norm)(tp, tx)
    want = getattr(JL, norm)(jp, jx)
    assert out.dtype == tx.dtype
    np.testing.assert_allclose(_np(out), _np(want),
                               atol=ATOL if dtype == "f32" else 1e-2)


def test_rope():
    rng = np.random.default_rng(1)
    jx, tx = _both(rng.standard_normal((2, 9, 3, 16)).astype(np.float32))
    pos = np.arange(9)[None, :] + 5
    out = L.apply_rope(tx, torch.from_numpy(pos), 10_000.0)
    want = JL.apply_rope(jx, jnp.asarray(pos), 10_000.0)
    np.testing.assert_allclose(_np(out), _np(want), atol=ATOL)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp(act):
    rng = np.random.default_rng(2)
    jx, tx = _both(rng.standard_normal((2, 4, 32)).astype(np.float32), "bf16")
    shapes = {"wu": (32, 48), "wd": (48, 32)}
    if act != "gelu":
        shapes["wg"] = (32, 48)
    jp, tp = _params(rng, shapes)
    out = L.mlp(tp, tx, act)
    want = JL.mlp(jp, jx, act)
    assert out.dtype == torch.float32          # bf16 x fp32 promotes, as in JAX
    np.testing.assert_allclose(_np(out), _np(want), atol=ATOL)


@pytest.mark.parametrize("tie", [True, False])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_embed_unembed(tie, cap):
    rng = np.random.default_rng(3)
    shapes = {"embedding": (40, 16)}
    if not tie:
        shapes["unembed"] = (16, 40)
    jp, tp = _params(rng, shapes)
    tokens = rng.integers(0, 40, (2, 6))
    emb = L.embed(tp, torch.from_numpy(tokens), scale_by_dim=True)
    jemb = JL.embed(jp, jnp.asarray(tokens), scale_by_dim=True)
    np.testing.assert_allclose(_np(emb), _np(jemb), atol=ATOL)
    x = jemb.astype(jnp.bfloat16)
    out = L.unembed(tp, torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16),
                    logit_cap=cap)
    np.testing.assert_allclose(_np(out), _np(JL.unembed(jp, x, logit_cap=cap)),
                               atol=ATOL)


# ---------------------------------------------------------------------------
# GQA attention with the KV cache
# ---------------------------------------------------------------------------

D_MODEL, H, KVH, HD = 32, 4, 2, 16


def _gqa_params(seed):
    rng = np.random.default_rng(seed)
    s = 1 / np.sqrt(D_MODEL)
    arrays = {
        "wq": rng.standard_normal((D_MODEL, H, HD)) * s,
        "wk": rng.standard_normal((D_MODEL, KVH, HD)) * s,
        "wv": rng.standard_normal((D_MODEL, KVH, HD)) * s,
        "wo": rng.standard_normal((H, HD, D_MODEL)) / np.sqrt(H * HD),
    }
    arrays = {k: a.astype(np.float32) for k, a in arrays.items()}
    return ({k: jnp.asarray(a) for k, a in arrays.items()},
            {k: torch.from_numpy(a) for k, a in arrays.items()})


def _assert_cache(tc, jc, atol=ATOL):
    np.testing.assert_allclose(_np(tc.k), _np(jc.k), atol=atol)
    np.testing.assert_allclose(_np(tc.v), _np(jc.v), atol=atol)
    np.testing.assert_array_equal(tc.positions.numpy(), np.asarray(jc.positions))
    assert tc.index == int(jc.index)


@pytest.mark.parametrize("size,window", [
    (32, None),      # cache larger than the prompt: tail in slots [:T], rest -1
    (8, None),       # ring buffer smaller than the prompt, T % size = 4: rolled
    (6, None),       # T % size = 0
    (8, 5),          # sliding window in prefill and decode
])
@pytest.mark.parametrize("cache_dtype", ["f32", "bf16"])
def test_gqa_prefill_then_decode(size, window, cache_dtype):
    B, T = 2, 12
    rng = np.random.default_rng(4)
    jp, tp = _gqa_params(5)
    kw = dict(num_kv_heads=KVH, num_heads=H, head_dim=HD, window=window)
    jdt = jnp.bfloat16 if cache_dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if cache_dtype == "bf16" else torch.float32
    cache_atol = 1e-2 if cache_dtype == "bf16" else ATOL

    jx, tx = _both(rng.standard_normal((B, T, D_MODEL)).astype(np.float32), "bf16")
    jy, jc = JL.gqa_attention(jp, jx, cache=JL.init_kv_cache(B, size, KVH, HD, jdt),
                              mode="prefill", **kw)
    ty, tc = L.gqa_attention(tp, tx, cache=L.init_kv_cache(B, size, KVH, HD, tdt),
                             mode="prefill", **kw)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=ATOL)
    _assert_cache(tc, jc, cache_atol)

    for _ in range(3):            # decode wraps the ring buffer when size < 15
        jx, tx = _both(rng.standard_normal((B, 1, D_MODEL)).astype(np.float32), "bf16")
        jy, jc = JL.gqa_attention(jp, jx, cache=jc, mode="decode", **kw)
        ty, tc = L.gqa_attention(tp, tx, cache=tc, mode="decode", **kw)
        np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-2 if cache_dtype == "bf16" else ATOL)
        _assert_cache(tc, jc, cache_atol)


def test_decode_attention_ring_positions():
    """Empty slots (-1) and slots beyond the query position are masked."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((1, 1, 2, 2, 16)).astype(np.float32)
    k = rng.standard_normal((1, 8, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 8, 2, 16)).astype(np.float32)
    pos = np.array([8, 9, 2, 3, -1, -1, 6, 7], np.int32)
    for window in (None, 4):
        want = JL.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   q_position=8, k_positions=jnp.asarray(pos),
                                   window=window)
        out = L.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), q_position=8,
                                 k_positions=torch.from_numpy(pos), window=window)
        np.testing.assert_allclose(_np(out), _np(want), atol=ATOL)


def test_gqa_train_mode_matches_jax():
    """Train mode attends over the full sequence like the JAX layer and
    keeps no cache; an unknown mode raises."""
    jp, tp = _gqa_params(7)
    kw = dict(num_kv_heads=KVH, num_heads=H, head_dim=HD, window=5)
    jx, tx = _both(np.random.default_rng(8).standard_normal(
        (2, 9, D_MODEL)).astype(np.float32), "bf16")
    jy, jc = JL.gqa_attention(jp, jx, mode="train", **kw)
    ty, tc = L.gqa_attention(tp, tx, mode="train", **kw)
    assert tc is None and jc is None
    np.testing.assert_allclose(_np(ty), _np(jy), atol=ATOL)
    with pytest.raises(ValueError, match="mode"):
        L.gqa_attention(tp, tx, mode="bogus", **kw)


def test_init_distributions():
    """Same distributions as the JAX package's ``dense_init`` / ``embed_init``
    (the draws differ: a torch.Generator is not a JAX key)."""
    gen = torch.Generator().manual_seed(0)
    w = L.dense_init(gen, (256, 512), 256)
    e = L.embed_init(gen, (512, 256))
    jw = JL.dense_init(jax.random.PRNGKey(0), (256, 512), 256)
    assert w.dtype == torch.float32
    assert abs(float(w.std()) - float(jnp.std(jw))) < 2e-3
    assert abs(float(e.std()) - 0.02) < 5e-4
