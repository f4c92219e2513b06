"""The port's MoE feed-forward held against the JAX package's ``moe_ffn``
from the same params (``init_moe`` in JAX, moved by ``params_from_jax``)
and the same inputs (numpy seed): every dispatch layout, capacity factors
that drop most slots, drop none or sit at the usual 1.25, token counts
below, at and above the dispatch group (a padded group), one token (the
decode shape), top-1 and top-2, each activation, with and without a shared
expert, and a bfloat16 ``x``.

Tolerances: ``y`` within 1e-5 and the aux loss within 1e-6 in float32 —
both frameworks make the same float32 products and drop the same slots;
only the order of a few float32 sums differs.  With a bfloat16 ``x`` the
inputs and the combine weights are rounded to bfloat16 at the same points
in both, and the products are float32 after promotion, so the same 1e-5
holds (``BF16_ATOL`` names it).  A dropped or misrouted slot moves ``y`` by
the size of an expert's output, of order one.  ``top_k`` ties would make
the frameworks choose differently; random routers make them improbable.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro_torch.models import moe as M
from repro_torch.models.convert import params_from_jax

ATOL, AUX_ATOL, BF16_ATOL = 1e-5, 1e-6, 1e-5
D, FF, E = 16, 24, 4
LAYOUTS = {"einsum": dict(dispatch="einsum", per_example_dispatch=True),
           "scatter": dict(dispatch="scatter", per_example_dispatch=True),
           "global": dict(dispatch="einsum", per_example_dispatch=False)}
GROUP = 8                       # dispatch_group of the einsum layout here


def _params(activation="swiglu", shared=0, seed=0):
    jp, _ = JM.init_moe(jax.random.PRNGKey(seed), D, FF, E, num_shared=shared,
                        activation=activation)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jp, tp


def _x(B, T, seed=1):
    return np.random.default_rng(seed).normal(size=(B, T, D)).astype(np.float32)


def _both(jp, tp, x, dtype=None, **kw):
    """(port y, port aux, JAX y, JAX aux) as float32 numpy."""
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    jy, jaux = JM.moe_ffn(jp, jx, **kw)
    ty, taux = M.moe_ffn(tp, tx, **kw)
    assert ty.shape == tuple(jy.shape) and ty.dtype == torch.float32
    return (ty.float().numpy(), float(taux), np.asarray(jy, np.float32), float(jaux))


@pytest.mark.parametrize("T", [5, GROUP, 13, 1])
@pytest.mark.parametrize("cf", [0.1, 1.25, 16.0])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_moe_ffn_matches_jax(layout, cf, T):
    """T = 13 is one full group of 8 and one padded group of 5."""
    jp, tp = _params()
    ty, taux, jy, jaux = _both(jp, tp, _x(3, T), num_experts=E, top_k=2,
                               capacity_factor=cf, dispatch_group=GROUP,
                               **LAYOUTS[layout])
    np.testing.assert_allclose(ty, jy, atol=ATOL, rtol=0)
    assert abs(taux - jaux) <= AUX_ATOL


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_moe_ffn_activations_match_jax(activation, top_k, shared):
    """The default layout at dbrx's capacity factor and dispatch group over
    a 600-token row: a full group of 512 and a padded one."""
    jp, tp = _params(activation, shared)
    ty, taux, jy, jaux = _both(jp, tp, _x(2, 600), num_experts=E, top_k=top_k,
                               capacity_factor=1.25, activation=activation)
    np.testing.assert_allclose(ty, jy, atol=ATOL, rtol=0)
    assert abs(taux - jaux) <= AUX_ATOL


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_moe_ffn_bf16_matches_jax(layout):
    jp, tp = _params(shared=1)
    ty, taux, jy, jaux = _both(jp, tp, _x(2, 11), "bfloat16", num_experts=E,
                               top_k=2, capacity_factor=1.0, dispatch_group=GROUP,
                               **LAYOUTS[layout])
    np.testing.assert_allclose(ty, jy, atol=BF16_ATOL, rtol=0)
    assert abs(taux - jaux) <= AUX_ATOL


def test_capacity_drops_tokens():
    """The cases above bind: a capacity factor of 0.1 changes the output."""
    jp, tp = _params()
    x = torch.from_numpy(_x(1, 32))
    tight, _ = M.moe_ffn(tp, x, num_experts=E, top_k=1, capacity_factor=0.1)
    loose, _ = M.moe_ffn(tp, x, num_experts=E, top_k=1, capacity_factor=8.0)
    assert torch.isfinite(tight).all()
    assert (tight - loose).abs().max().item() > 1e-3


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_dense_reference_matches_jax(activation, shared):
    jp, tp = _params(activation, shared)
    x = _x(2, 9)
    want = JM.moe_ffn_dense_reference(jp, jnp.asarray(x), num_experts=E, top_k=2,
                                      activation=activation)
    got = M.moe_ffn_dense_reference(tp, torch.from_numpy(x), num_experts=E, top_k=2,
                                    activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("top_k,T,shared", [(1, 4, 0), (2, 17, 1), (3, 32, 0)])
def test_matches_dense_oracle_when_nothing_drops(layout, top_k, T, shared):
    """``tests/test_moe.py``'s oracle case on the port: with capacity factor
    16 no slot drops, and every layout equals the dense reference."""
    _, tp = _params(shared=shared, seed=T)
    x = torch.from_numpy(_x(2, T, seed=T))
    y, aux = M.moe_ffn(tp, x, num_experts=E, top_k=top_k, capacity_factor=16.0,
                       **LAYOUTS[layout])
    want = M.moe_ffn_dense_reference(tp, x, num_experts=E, top_k=top_k)
    torch.testing.assert_close(y, want, atol=1e-4, rtol=1e-4)
    assert aux.item() >= 0


def test_expert_sharding_is_not_ported():
    _, tp = _params()
    with pytest.raises(NotImplementedError, match="queue 1, item 8"):
        M.moe_ffn(tp, torch.from_numpy(_x(1, 4)), num_experts=E, top_k=2,
                  expert_sharding="model")


def test_init_moe_layout_matches_jax():
    """``init_moe`` from a torch.Generator: the JAX names, shapes, dtypes
    and scales (1/sqrt(fan-in)), with a leading stacked axis."""
    for activation, shared in (("swiglu", 1), ("gelu", 0), ("geglu", 2)):
        jp, _ = JM.init_moe(jax.random.PRNGKey(0), 64, 96, 8, num_shared=shared,
                            activation=activation)
        tp = M.init_moe(torch.Generator().manual_seed(0), 64, 96, 8, shared,
                        activation, lead=(3,))
        assert set(tp) == set(jp)
        for k, v in jp.items():
            assert tuple(tp[k].shape) == (3, *v.shape) and tp[k].dtype == torch.float32
            np.testing.assert_allclose(tp[k].std().item(), float(jnp.std(v)), rtol=0.1)
