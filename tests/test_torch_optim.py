"""The port's AdamW, global-norm clipping and learning-rate schedule held
against the JAX package's ``repro.optim`` on the same numpy inputs (the
counterparts of ``tests/test_training.py``'s optimizer tests).

Tolerance: rtol 1e-6 / atol 1e-7 — both compute in float32 in the same
order; only the summation order of the global norm differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_update as jadamw_update
from repro.optim import global_norm as jglobal_norm
from repro.optim import init_opt_state as jinit_opt_state
from repro.optim.schedules import cosine_with_warmup as jcosine
from repro_torch.optim import AdamWConfig, adamw_update, global_norm, init_opt_state
from repro_torch.optim.schedules import cosine_with_warmup

RTOL, ATOL = 1e-6, 1e-7


def _tree(rng, scale=1.0):
    shapes = {"a": (4, 3), "b": {"c": (7,), "d": (2, 2, 5)}, "e": ((3,), (6, 2))}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        if isinstance(s[0], tuple):
            return tuple(make(v) for v in s)
        return (rng.normal(size=s) * scale).astype(np.float32)
    return make(shapes)


def _map(fn, t):
    if isinstance(t, dict):
        return {k: _map(fn, v) for k, v in t.items()}
    if isinstance(t, tuple):
        return tuple(_map(fn, v) for v in t)
    return fn(t)


def _flat(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _flat(t[k])]
    if isinstance(t, tuple):
        return [x for v in t for x in _flat(v)]
    return [np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor) else t)]


@pytest.mark.parametrize("clip,grad_scale", [(None, 1.0), (1.0, 10.0), (1.0, 0.01)])
def test_adamw_steps_match_jax(clip, grad_scale):
    """Five steps under the cosine schedule with warm-up: step 0 has lr
    scale 0, so the later steps are the ones that move the params."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jcfg = JAdamWConfig(lr=1e-2, b1=0.9, b2=0.99, weight_decay=0.1, grad_clip_norm=clip)
    tcfg = AdamWConfig(lr=1e-2, b1=0.9, b2=0.99, weight_decay=0.1, grad_clip_norm=clip)
    jp = _map(jnp.asarray, params)
    tp = _map(lambda a: torch.from_numpy(a.copy()), params)
    js, ts = jinit_opt_state(jp), init_opt_state(tp)
    for step in range(5):
        grads = _tree(rng, grad_scale)
        scale_j = jcosine(jnp.asarray(step), warmup_steps=2, total_steps=10)
        scale_t = cosine_with_warmup(step, warmup_steps=2, total_steps=10)
        assert float(scale_t) == pytest.approx(float(scale_j), rel=1e-7)
        jp, js, jn = jadamw_update(jcfg, jp, _map(jnp.asarray, grads), js, lr_scale=scale_j)
        tp, ts, tn = adamw_update(tcfg, tp, _map(torch.from_numpy, grads), ts,
                                  lr_scale=scale_t)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        for a, b in zip(_flat(tp), _flat(jp)):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        for key in ("mu", "nu"):
            for a, b in zip(_flat(ts[key]), _flat(js[key])):
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        assert ts["count"] == int(js["count"]) == step + 1


def test_adamw_matches_reference():
    """One AdamW step vs a hand-rolled numpy reference (the JAX package's
    ``test_adamw_matches_reference``)."""
    cfg = AdamWConfig(lr=1e-2, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.1,
                      grad_clip_norm=None)
    rng = np.random.default_rng(0)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    g = rng.normal(size=(4, 3)).astype(np.float32)
    p = {"w": torch.from_numpy(w.copy())}
    new_p, st, _ = adamw_update(cfg, p, {"w": torch.from_numpy(g)}, init_opt_state(p))
    m, v = 0.1 * g, 0.01 * np.square(g)
    want = w - 1e-2 * ((m / 0.1) / (np.sqrt(v / 0.01) + 1e-8) + 0.1 * w)
    np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-5)
    assert st["count"] == 1


def test_grad_clipping_reports_the_unclipped_norm():
    p = {"w": torch.ones(10)}
    g = {"w": torch.full((10,), 100.0)}
    _, _, gnorm = adamw_update(AdamWConfig(grad_clip_norm=1.0), p, g, init_opt_state(p))
    assert float(gnorm) == pytest.approx(float(global_norm(g)))
    assert float(global_norm(g)) == pytest.approx(float(jglobal_norm({"w": jnp.full((10,), 100.0)})))


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (1, 4)])
def test_cosine_schedule_matches_jax(warmup, total):
    for step in range(0, total + 3):
        a = cosine_with_warmup(step, warmup_steps=warmup, total_steps=total)
        b = jcosine(jnp.asarray(step), warmup_steps=warmup, total_steps=total)
        assert np.float32(a) == pytest.approx(float(b), rel=1e-6, abs=1e-7)
    # step 0 has scale 0 even without warm-up (step / max(warmup, 1))
    assert float(cosine_with_warmup(0, warmup_steps=warmup, total_steps=total)) == 0.0
    end = float(cosine_with_warmup(total, warmup_steps=warmup, total_steps=total))
    assert end == pytest.approx(0.1, abs=1e-6)
