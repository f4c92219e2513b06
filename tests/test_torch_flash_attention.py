"""The port's flash attention (plain version on the CPU, Hopper kernel on the
card) held against the JAX package's oracle and its Pallas kernel in
interpret mode, on the same numpy inputs.

Tolerances are the JAX package's own (``tests/test_kernels.py``): fp32
atol 2e-5, bf16 atol 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_flash_plan import check_backward_plan, check_forward_plan
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.layers import blockwise_attention as jax_blockwise
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (BWD_MAX_SPLIT, bwd_plan, flash_attention_cuda,
                                                 fwd_plan)
from repro_torch.models.layers import blockwise_attention


def _inputs(seed, B, tq, tk, KVH, G, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, tq, KVH, G, D)).astype(np.float32)
    k = rng.standard_normal((B, tk, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, tk, KVH, D)).astype(np.float32)
    return q, k, v


def _pair(arrays, dtype):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("tq,tk", [(64, 64), (128, 256), (96, 160)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_jax_shapes_dtypes(tq, tk, dtype):
    (jq, jk, jv), (tq_, tk_, tv) = _pair(_inputs(0, 2, tq, tk, 2, 2, 32), dtype)
    out = ops.flash_attention(tq_, tk_, tv)
    assert out.dtype == tq_.dtype and out.shape == tq_.shape
    atol = 2e-2 if dtype == "bf16" else 2e-5
    np.testing.assert_allclose(_np(out), _np(jref.reference_attention(jq, jk, jv)),
                               atol=atol)
    if dtype == "f32":      # the Pallas body in interpret mode, as its tests run it
        interp = jops.flash_attention(jq, jk, jv, q_block=32, kv_block=64,
                                      impl="interpret")
        np.testing.assert_allclose(_np(out), _np(interp), atol=atol)


@pytest.mark.parametrize("kw", [
    dict(window=16), dict(prefix_len=8), dict(logit_cap=20.0),
    dict(causal=False), dict(window=32, logit_cap=50.0),
])
def test_plain_matches_jax_mask_variants(kw):
    (jq, jk, jv), (q, k, v) = _pair(_inputs(1, 1, 128, 128, 2, 1, 16), "f32")
    out = ops.flash_attention(q, k, v, **kw)
    np.testing.assert_allclose(
        _np(out), _np(jref.reference_attention(jq, jk, jv, **kw)), atol=2e-5)
    interp = jops.flash_attention(jq, jk, jv, q_block=32, kv_block=32,
                                  impl="interpret", **kw)
    np.testing.assert_allclose(_np(out), _np(interp), atol=2e-5)


@pytest.mark.parametrize("kw", [
    dict(q_offset=40, k_valid_len=56),
    dict(q_offset=40, k_valid_len=56, window=24),
    dict(q_offset=0, k_valid_len=20, prefix_len=6),
    dict(q_offset=48, k_valid_len=64, causal=False, logit_cap=30.0),
])
def test_blockwise_offset_and_valid_len_match_jax(kw):
    """q_offset / k_valid_len (decode-style queries against a partly filled
    cache) are not in the Pallas kernel; the port's kernel takes them, and
    the model-level function agrees with the JAX blockwise attention."""
    (jq, jk, jv), (q, k, v) = _pair(_inputs(2, 2, 16, 64, 2, 2, 16), "f32")
    want = jax_blockwise(jq, jk, jv, q_block=8, kv_block=16, **kw)
    np.testing.assert_allclose(_np(blockwise_attention(q, k, v, **kw)),
                               _np(want), atol=2e-5)


def test_ragged_noncausal_keys_masked_by_true_length():
    """Non-causal attention over a key length that is not a block multiple.
    The JAX wrapper pads keys and passes the padded length as ``kv_len``
    (``repro/kernels/ops.py:54-60`` with ``flash_attention.py:120``), so the
    zero keys enter its softmax; the port masks by the true length and
    agrees with the oracle.  The JAX-side error is asserted too: it is the
    reference fault logged in ROADMAP.md queue 3."""
    (jq, jk, jv), (q, k, v) = _pair(_inputs(3, 1, 96, 160, 2, 2, 16), "f32")
    want = _np(jref.reference_attention(jq, jk, jv, causal=False))
    port_err = np.abs(_np(ops.flash_attention(q, k, v, causal=False)) - want).max()
    assert port_err <= 2e-5
    jax_err = np.abs(_np(jops.flash_attention(jq, jk, jv, causal=False,
                                              kv_block=64, impl="interpret"))
                     - want).max()
    assert jax_err > 1e-2                      # 0.061 on these inputs
    causal_err = np.abs(_np(jops.flash_attention(jq, jk, jv, kv_block=64,
                                                 impl="interpret"))
                        - _np(jref.reference_attention(jq, jk, jv))).max()
    assert causal_err <= 2e-5                  # causal masking hides the pad


def test_cpu_tensor_takes_plain_path_without_counting():
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, 1, 32, 32, 2, 2, 16))
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 0 and not any(counts.values())
    torch.testing.assert_close(out, ref.reference_attention(q, k, v),
                               rtol=0, atol=0)
    with ops.use("reference"):
        torch.testing.assert_close(ops.flash_attention(q, k, v), out, rtol=0, atol=0)


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_impl():
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, 1, 8, 8, 1, 1, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="impl"), ops.use("pallas"):
        ops.flash_attention(q, k, v)
    with pytest.raises(TypeError):
        flash_attention_cuda(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_cuda(torch.zeros(1, 2, 1, 1, 300), torch.zeros(1, 2, 1, 300),
                             torch.zeros(1, 2, 1, 300))


def test_fully_masked_rows_give_zeros():
    """A query that sees no key yields zeros (the kernel's 0 / max(l, 1e-30)
    guard), as the JAX blockwise attention does."""
    (jq, jk, jv), (q, k, v) = _pair(_inputs(6, 1, 4, 16, 1, 2, 16), "f32")
    out = ops.flash_attention(q, k, v, q_offset=0, k_valid_len=0)
    assert float(out.abs().max()) == 0.0
    want = jax_blockwise(jq, jk, jv, k_valid_len=0, q_block=4, kv_block=16)
    np.testing.assert_allclose(_np(out), _np(want), atol=2e-5)


@pytest.mark.parametrize("tq,tk,kw", [
    (64, 64, {}), (64, 64, dict(causal=False)), (64, 64, dict(window=16)),
    (64, 64, dict(prefix_len=8)), (64, 64, dict(logit_cap=20.0)),
    (64, 64, dict(window=32, logit_cap=50.0)), (48, 80, {}),
])
def test_backward_matches_jax_vjp(tq, tk, kw):
    """The gradient the backward kernel replaces: autograd through
    ``ops.flash_attention`` (the plain version on the CPU) against
    ``jax.vjp`` of the JAX package's ``blockwise_attention``, on the same
    cotangent.  fp32, atol 2e-5 (the forward's tolerance)."""
    import jax

    q, k, v = _inputs(3, 2, tq, tk, 2, 3, 16)
    do = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jax_blockwise(a, b, c, q_block=16, kv_block=32, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq_, tk_, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = torch.autograd.grad(ops.flash_attention(tq_, tk_, tv, **kw),
                              (tq_, tk_, tv), torch.from_numpy(do))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), atol=2e-5)


def test_backward_refuses_decode_arguments():
    """The backward kernel takes no q_offset / k_valid_len: on the card,
    asking for a gradient with them raises before any launch."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, 1, 8, 8, 1, 1, 16))
    if torch.cuda.is_available():
        q, k, v = (t.cuda().requires_grad_() for t in (q, k, v))
        with pytest.raises(ValueError, match="q_offset"):
            ops.flash_attention(q, k, v, q_offset=2)
    # on the CPU the plain version differentiates any mask
    qc = torch.from_numpy(_inputs(5, 1, 8, 8, 1, 1, 16)[0]).requires_grad_()
    out = ops.flash_attention(qc, k.detach().cpu(), v.detach().cpu(), q_offset=2,
                              k_valid_len=6)
    out.sum().backward()
    assert torch.isfinite(qc.grad).all()


_PLAN_MASKS = [dict(), dict(causal=False), dict(window=16), dict(prefix_len=8),
               dict(window=32, causal=False), dict(window=40, prefix_len=24)]


@pytest.mark.parametrize("kw", _PLAN_MASKS, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "causal")
@pytest.mark.parametrize("tq,tk,G,D,dtype,n_sm", [
    (512, 512, 3, 64, torch.float32, 132),       # the training shape
    (1, 1, 1, 16, torch.float32, 132), (63, 63, 2, 20, torch.float32, 132),
    (65, 65, 1, 128, torch.float32, 1000), (129, 129, 16, 64, torch.float32, 1000),
    (96, 160, 2, 20, torch.bfloat16, 1000), (160, 96, 4, 128, torch.bfloat16, 132),
    (70, 70, 64, 16, torch.float32, 1000),
])
def test_backward_plan_covers_every_visible_pair_once(tq, tk, G, D, dtype, n_sm, kw):
    """The backward kernel's work split (``bwd_plan``, the same arithmetic
    as the kernel's): the dK/dV CTAs and, separately, the dQ CTAs meet every
    (query row, key) pair that ``ref.attention_mask`` leaves visible exactly
    once, for every mask kind, ragged lengths and cluster sizes 1 to 8."""
    check_backward_plan(tq, tk, G, D, dtype, n_sm, kw)


_WIDE_PLAN_MASKS = _PLAN_MASKS + [dict(prefix_len=256), dict(window=40, causal=False)]


@pytest.mark.parametrize("kw", _WIDE_PLAN_MASKS, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "causal")
@pytest.mark.parametrize("tq,tk,G,D,dtype,n_sm", [
    (512, 512, 8, 256, torch.float32, 132),      # paligemma-3b's training shape
    (512, 512, 8, 256, torch.bfloat16, 132),
    (512, 512, 1, 192, torch.float32, 132),      # MLA's head_dim
    (97, 131, 2, 256, torch.float32, 1000), (131, 97, 3, 192, torch.bfloat16, 1000),
    (70, 70, 64, 256, torch.float32, 132), (1, 1, 1, 129, torch.float32, 132),
])
def test_backward_plan_above_head_dim_128_covers_every_visible_pair_once(
        tq, tk, G, D, dtype, n_sm, kw):
    """Above head_dim 128 the kernel keeps its 64-key and 64-row CTAs
    (their warps split the columns in two halves) and fp32 steps 16 keys in
    the dQ pass: the walk still meets every visible (query row, key) pair
    once, under causal, prefix (paligemma's 256 image positions among
    them), window and non-causal masks."""
    plan = check_backward_plan(tq, tk, G, D, dtype, n_sm, kw)
    step = 16 if dtype == torch.float32 else 32
    assert all((hi - lo) % step == 0 for _, _, lo, hi in plan.dq)


def test_backward_plan_fills_the_card_longest_first():
    """At the training shape (B=2, T=512, KVH=5, G=3, D=64, causal) the
    dK/dV pass runs 640 CTAs in clusters of 8 and the dQ pass 960 in
    clusters of 4, both starting with their longest CTAs, and no CTA has
    more 32-wide steps than an even share of the pass over 3 CTAs on each
    of 132 SMs unless its cluster is at the largest size, 8; at paper-7b's
    heads in bf16 the passes need no split."""
    plan = bwd_plan(2, 512, 512, 5, 3, 64)
    assert (plan.split_dkdv, len(plan.dkdv) * 2 * 5) == (8, 640)
    assert (plan.split_dq, len(plan.dq) * 2 * 5) == (4, 960)
    for split, steps in ((plan.split_dkdv, [(end - first) // 32 for _, _, first, end in plan.dkdv]),
                         (plan.split_dq, [(hi - lo) // 32 for _, _, lo, hi in plan.dq])):
        assert steps[0] == max(steps)
        assert max(steps) <= sum(steps) * 10 / (3 * 132) or split == BWD_MAX_SPLIT
    plan = bwd_plan(2, 256, 256, 32, 1, 128, dtype=torch.bfloat16)
    assert (plan.split_dkdv, plan.split_dq) == (1, 1)


_FWD_MASKS = _PLAN_MASKS + [dict(q_offset=100, k_valid_len=150), dict(k_valid_len=40, causal=False),
                            dict(window=2048), dict(prefix_len=70)]


@pytest.mark.parametrize("kw", _FWD_MASKS, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "causal")
@pytest.mark.parametrize("tq,tk,G,D", [
    (512, 512, 3, 64),                       # smollm-360m prefill
    (1, 1, 1, 16), (63, 63, 2, 20), (65, 129, 1, 128), (129, 65, 16, 80),
    (70, 70, 16, 256), (33, 200, 64, 32), (97, 97, 64, 256), (16, 200, 4, 32),
])
def test_forward_plan_covers_every_visible_pair_once(tq, tk, G, D, kw):
    """The forward kernel's walk (``fwd_plan``, the same arithmetic as the
    kernel's ``key_tiles`` and ``classify``): its CTAs meet every (query row,
    key) pair that ``ref.attention_mask`` leaves visible exactly once, a warp
    skips a key tile only where none of its pairs is visible, and it leaves
    the mask out only where every pair of the block is visible; for every
    mask kind, ragged lengths, G up to 64 and both tile shapes."""
    check_forward_plan(tq if "q_offset" not in kw else min(tq, 16), tk, G, D, kw)


def test_forward_plan_shares_key_tiles_and_goes_longest_first():
    """At recurrentgemma-9b's local attention (T=2304, G=16, D=256, window
    2048) a CTA holds 128 rows, 8 positions of all 16 heads, and 32-key
    tiles; at smollm-360m's prefill (G=3, D=64) 64 rows and 64-key tiles.
    Under the causal mask the CTAs go out longest first, and most blocks
    of a long row need no mask."""
    plan = fwd_plan(2304, 2304, 16, 256, window=2048)
    assert (plan.rows, plan.keys, len(plan.ctas)) == (128, 32, 288)
    walks = [len(classes) for _, _, classes in plan.ctas]
    assert walks[0] == max(walks) == 2048 // 32 + 1 and walks == sorted(walks, reverse=True)
    plan = fwd_plan(512, 512, 3, 64)
    assert (plan.rows, plan.keys, len(plan.ctas)) == (64, 64, 24)
    _, _, classes = plan.ctas[0]
    flat = [c for per_warp in classes for c in per_warp]
    assert flat.count("full") > flat.count("masked") > 0
