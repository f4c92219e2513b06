"""The port's Multi-head Latent Attention (``models/mla.py``) against the JAX
package's ``models/mla.py`` on the same numpy inputs and JAX-initialised
weights, at deepseek-v3-smoke's widths (d 128, 4 heads, q_lora 48, kv_lora
32, nope 32, rope 16), with v narrower than the query/key width (32 < 48,
padded for the kernel) and as wide (48).

Tolerance: fp32 atol 1e-4.  Both sides run in float32 (inputs, weights
and caches), so the gap is summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_flash_plan import check_forward_plan
from repro.models import mla as jmla
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import fwd_tiles
from repro_torch.models import layers as L
from repro_torch.models import mla
from repro_torch.models.convert import params_from_jax

ATOL = 1e-4
D_MODEL, HEADS, Q_LORA, KV_LORA, NOPE, ROPE = 128, 4, 48, 32, 32, 16
B, T = 2, 10


def _dims(v_head_dim):
    return dict(num_heads=HEADS, qk_nope_head_dim=NOPE, qk_rope_head_dim=ROPE,
                v_head_dim=v_head_dim)


def _params(v_head_dim):
    jp, _ = jmla.init_mla(jax.random.PRNGKey(3), D_MODEL, HEADS, q_lora_rank=Q_LORA,
                          kv_lora_rank=KV_LORA, qk_nope_head_dim=NOPE,
                          qk_rope_head_dim=ROPE, v_head_dim=v_head_dim)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _x(seed, t):
    return np.random.default_rng(seed).standard_normal((B, t, D_MODEL)).astype(np.float32)


def _close(got, want, name=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("v_head_dim", [32, NOPE + ROPE])
def test_train_matches_jax(v_head_dim):
    jp, tp = _params(v_head_dim)
    x = _x(0, T)
    want, _ = jmla.mla_attention(jp, jnp.asarray(x), mode="train", **_dims(v_head_dim))
    got, cache = mla.mla_attention(tp, torch.from_numpy(x), mode="train",
                                   **_dims(v_head_dim))
    assert cache is None and got.shape == (B, T, D_MODEL)
    _close(got, want)


@pytest.mark.parametrize("v_head_dim", [32, NOPE + ROPE])
@pytest.mark.parametrize("size", [24, 8], ids=["fits", "keeps-last-8"])
def test_prefill_and_decode_match_jax(v_head_dim, size):
    """Prefill fills the latent cache (a cache of 8 slots keeps the last 8
    of the 10 prompt tokens, as the JAX package keeps them), then 5 decode
    steps of the absorbed form; outputs and cache leaves agree each step."""
    jp, tp = _params(v_head_dim)
    dims = _dims(v_head_dim)
    jc = jmla.init_mla_cache(B, size, KV_LORA, ROPE, dtype=jnp.float32)
    tc = mla.init_mla_cache(B, size, KV_LORA, ROPE, dtype=torch.float32)
    x = _x(1, T)
    want, jc = jmla.mla_attention(jp, jnp.asarray(x), cache=jc, mode="prefill", **dims)
    got, tc = mla.mla_attention(tp, torch.from_numpy(x), cache=tc, mode="prefill", **dims)
    _close(got, want, "prefill")
    for step in range(5):
        for name in ("c_kv", "k_pe"):
            _close(getattr(tc, name), getattr(jc, name), f"{name} before step {step}")
        assert tc.index == int(jc.index) == T + step
        x = _x(10 + step, 1)
        want, jc = jmla.mla_attention(jp, jnp.asarray(x), cache=jc, mode="decode", **dims)
        got, tc = mla.mla_attention(tp, torch.from_numpy(x), cache=tc, mode="decode",
                                    **dims)
        _close(got, want, f"decode step {step}")


@pytest.mark.parametrize("v_head_dim", [32, NOPE + ROPE])
def test_absorbed_decode_equals_decompressed_attention(v_head_dim):
    """Decode at position T (W_uk folded into the query, W_uv into the
    output, attention against the latents) gives the last row of train-mode
    attention over the T + 1 tokens (K and V decompressed per head)."""
    _, tp = _params(v_head_dim)
    dims = _dims(v_head_dim)
    x = torch.from_numpy(_x(2, T + 1))
    full, _ = mla.mla_attention(tp, x, mode="train", **dims)
    cache = mla.init_mla_cache(B, 16, KV_LORA, ROPE, dtype=torch.float32)
    _, cache = mla.mla_attention(tp, x[:, :T], cache=cache, mode="prefill", **dims)
    last, cache = mla.mla_attention(tp, x[:, T:], cache=cache, mode="decode", **dims)
    assert cache.index == T + 1
    torch.testing.assert_close(last[:, 0], full[:, T], atol=ATOL, rtol=0)


def test_prefill_without_cache_makes_a_bf16_cache_of_the_prompt():
    """As in the JAX package: prefill with no cache keeps all T tokens'
    latents in a new bfloat16 cache (equal within one bf16 ulp, 2^-7
    relative: both round the same float32 values, summed in another
    order)."""
    jp, tp = _params(32)
    x = _x(4, T)
    _, jc = jmla.mla_attention(jp, jnp.asarray(x), mode="prefill", **_dims(32))
    _, tc = mla.mla_attention(tp, torch.from_numpy(x), mode="prefill", **_dims(32))
    assert tc.c_kv.dtype == torch.bfloat16 and tc.c_kv.shape == jc.c_kv.shape == (B, T, KV_LORA)
    assert tc.index == int(jc.index) == T
    for name in ("c_kv", "k_pe"):
        np.testing.assert_allclose(getattr(tc, name).float().numpy(),
                                   np.asarray(getattr(jc, name), np.float32),
                                   rtol=2 ** -7, atol=0)


def test_mla_passes_its_scale_to_the_attention_kernel(monkeypatch):
    """MLA calls the attention kernel's entry with q/k of width nope + rope,
    v padded to it, and the scale 1/sqrt(nope + rope) given explicitly (not
    the kernel's default 1/sqrt(D), which agrees only while v is padded to
    the same width)."""
    calls = []
    real = L.ops.flash_attention

    def recording(q, k, v, **kw):
        calls.append((q.shape, k.shape, v.shape, kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(L.ops, "flash_attention", recording)
    _, tp = _params(32)
    mla.mla_attention(tp, torch.from_numpy(_x(5, T)), mode="train", **_dims(32))
    (qs, ks, vs, kw), = calls
    qk = NOPE + ROPE
    assert qs == (B, T, HEADS, 1, qk) and ks == vs == (B, T, HEADS, qk)
    assert kw["scale"] == pytest.approx(qk ** -0.5) and kw["causal"]


def test_blockwise_attention_takes_a_scale():
    """A scale other than 1/sqrt(D) reaches the plain version: the result is
    the oracle's at that scale, and differs from the default's."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((1, 12, 2, 1, 24), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 12, 2, 24), np.float32))
            for _ in range(2))
    got = L.blockwise_attention(q, k, v, scale=0.3)
    torch.testing.assert_close(got, ref.reference_attention(q, k, v, scale=0.3),
                               rtol=0, atol=0)
    assert (got - L.blockwise_attention(q, k, v)).abs().max() > 1e-2


def test_forward_plan_at_the_mla_shape():
    """deepseek-v3's prefill gives the forward kernel head_dim 192 with one
    query per KV head: the 256-wide template's tiles (128 rows, 32 keys),
    and a walk that meets every visible pair once, at the card phase's
    512 tokens and off the tiles."""
    assert fwd_tiles(192) == (128, 32)
    check_forward_plan(512, 512, 1, 192, {})
    check_forward_plan(97, 131, 1, 192, {})
