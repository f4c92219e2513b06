"""Shared parity check for the port's dense model against the JAX package's
``apply_model`` (see ``test_torch_model.py`` for the tolerance's reason).
Split over two test files so that each stays short under ``--dist
loadfile``: the op-by-op JAX reference compiles every op anew per shape."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import apply_model as jax_apply
from repro.models import get_smoke_config as jax_smoke
from repro.models import init_caches as jax_init_caches
from repro.models import init_model as jax_init_model
from repro_torch.models import apply_model, get_smoke_config, init_caches
from repro_torch.models.convert import params_from_jax

ATOL = 3e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def smoke_configs(arch, first_k_dense=0):
    """(JAX, port) smoke configs of ``arch``; ``first_k_dense`` > 0 gives an
    MoE config that many leading dense-FFN layers on both sides."""
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    if first_k_dense:
        jcfg, tcfg = (dataclasses.replace(
            c, moe=dataclasses.replace(c.moe, first_k_dense=first_k_dense))
            for c in (jcfg, tcfg))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def converted_params(arch, first_k_dense=0):
    """(jax cfg, jax params, port params) from JAX ``init_model``, once per
    arch (and ``first_k_dense``) and process."""
    cfg = smoke_configs(arch, first_k_dense)[0]
    jp = jax.jit(lambda key: jax_init_model(key, cfg)[0])(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def assert_tokens_match(tlogits, jlogits):
    """Greedy tokens agree wherever the reference's top-1 / top-2 margin
    exceeds the logit tolerance (a closer tie may flip either way)."""
    jl = _np(jlogits)
    top2 = np.sort(jl, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * ATOL
    same = _np(tlogits).argmax(-1) == jl.argmax(-1)
    assert np.all(same[decided])


def _cache_leaves(caches):
    """(name, array) of every tensor in a cache tree, JAX or port, with the
    port's Python-int ``index`` and the JAX package's stacked one dropped."""
    out = []

    def walk(node, name):
        if isinstance(node, (tuple, list)):
            for i, c in enumerate(node):
                walk(c, f"{name}/{i}")
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{name}/{k}")
        else:
            for f in dataclasses.fields(node):
                if f.name != "index":
                    out.append((f"{name}/{f.name}", _np(getattr(node, f.name))))
    walk(caches, "")
    return out


def check_prefill_and_decode(arch, T=10, first_k_dense=0, window_override=None):
    """Prefill T tokens (a RecurrentGemma or Gemma-2 smoke prompt of 20 wraps
    its 16-slot local-attention ring buffer), then 4 decode steps; logits,
    and at the end every cache and recurrent state, against the JAX model,
    both run with ``window_override``."""
    cfg, jp, tp = converted_params(arch, first_k_dense)
    tcfg = smoke_configs(arch, first_k_dense)[1]
    B, ctx = 2, 24
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, T))

    wo = dict(window_override=window_override)
    jc = jax_init_caches(cfg, B, ctx, dtype=jnp.float32, **wo)
    tc = init_caches(tcfg, B, ctx, dtype=torch.float32, device="cpu", **wo)
    with jax.disable_jit():
        jl, jc, _ = jax_apply(jp, cfg, {"tokens": jnp.asarray(tokens)},
                              mode="prefill", caches=jc, **wo)
    tl, tc, _ = apply_model(tp, tcfg, {"tokens": torch.from_numpy(tokens)},
                            mode="prefill", caches=tc, **wo)
    assert tl.shape == jl.shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
    assert_tokens_match(tl[:, -1], jl[:, -1])

    # 4 decode steps fed the reference's greedy tokens, so a tie cannot make
    # the two runs diverge
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
        with jax.disable_jit():
            jl, jc, _ = jax_apply(jp, cfg, {"tokens": jnp.asarray(nxt)[:, None]},
                                  mode="decode", caches=jc, **wo)
        tl, tc, _ = apply_model(tp, tcfg, {"tokens": torch.tensor(nxt)[:, None]},
                                mode="decode", caches=tc, **wo)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
        assert_tokens_match(tl[:, -1], jl[:, -1])
    for (name, got), (jname, want) in zip(_cache_leaves(tc), _cache_leaves(jc),
                                          strict=True):
        assert name == jname
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL, err_msg=name)
    for c, jc_ in zip(tc["blocks"], jc["blocks"]):
        if hasattr(c, "index"):
            assert c.index == int(jc_.index[0]) == T + 4
