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


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_expert_sharding_keeps_the_values(layout):
    """On plain tensors the expert-axis constraint is the identity: every
    layout gives the same ``y`` and aux loss, to the bit, with and without
    it (the einsum layout does not read it at all)."""
    _, tp = _params(shared=1)
    x = torch.from_numpy(_x(3, 13))
    kw = dict(num_experts=E, top_k=2, capacity_factor=1.0, dispatch_group=GROUP,
              **LAYOUTS[layout])
    y, aux = M.moe_ffn(tp, x, **kw)
    ye, auxe = M.moe_ffn(tp, x, expert_sharding="model", **kw)
    assert torch.equal(y, ye) and torch.equal(aux, auxe)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_expert_sharding_shards_the_dispatch_buffers(layout, monkeypatch):
    """On DTensors over a fake (4, 2) ``("data", "model")`` mesh the two
    scatter layouts constrain ``buf`` and ``out_buf`` to ``Shard`` on the
    expert dim over ``model`` (and ``Replicate`` over ``data``), where the
    JAX package puts ``P(None, axis, None, None)``; the einsum layout
    constrains nothing, as the JAX package's does not."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import MeshShape

    seen = []

    def spy(t, spec):
        out = SH.constrain(t, spec)
        if spec is not None:
            seen.append((spec, tuple(out.placements), tuple(out.shape)))
        return out
    monkeypatch.setattr(M, "constrain", spy)
    _, tp = _params()
    mesh_shape = MeshShape(("data", "model"), {"data": 4, "model": 2})
    with SH.fake_mesh(mesh_shape) as mesh, implicit_replication():
        p = {k: distribute_tensor(v.to("meta"), mesh, [Replicate(), Replicate()])
             for k, v in tp.items()}
        x = distribute_tensor(torch.empty(4, 8, D, device="meta"), mesh,
                              [Shard(0), Replicate()])
        y, _ = M.moe_ffn(p, x, num_experts=E, top_k=2, dispatch_group=GROUP,
                         expert_sharding="model", **LAYOUTS[layout])
        assert tuple(y.shape) == (4, 8, D)
    if layout == "einsum":
        assert seen == []
        return
    rows = 4 if layout == "scatter" else 1
    assert [s[0] for s in seen] == [(None, "model", None, None)] * 2
    for _, placements, shape in seen:
        assert placements == (Replicate(), Shard(1)) and shape[:2] == (rows, E)


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


DBRX_MESH = """
import dataclasses, functools
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
import repro.launch.sharding as SH
import repro.models.moe as MOE
from repro.launch.mesh import rules_for
from repro.models import apply_model, get_smoke_config, init_model

MOE.moe_ffn = functools.partial(MOE.moe_ffn, dispatch="scatter")
cfg = get_smoke_config("dbrx-132b")
cfg = dataclasses.replace(cfg, dtype="float32",
                          moe=dataclasses.replace(cfg.moe, expert_axis="model"))
mesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
holder = {{}}
def init(key):
    p, a = init_model(key, cfg)
    holder["axes"] = a
    return p
params = jax.jit(init)(jax.random.PRNGKey(0))
pspecs = SH.param_pspecs(mesh, rules_for(cfg, "tp"), holder["axes"], params)
params = jax.device_put(params, SH.named(mesh, pspecs))
tokens = jax.device_put(jnp.asarray(np.load({inp!r})), NamedSharding(mesh, P("data", None)))
with jax.set_mesh(mesh):
    logits = jax.jit(lambda p, t: apply_model(p, cfg, {{"tokens": t}}, mode="train")[0])(
        params, tokens)
np.save({out!r}, np.asarray(logits, np.float32))
print("DBRX_MESH_OK")
"""


def test_dbrx_expert_axis_logits_match_jax_on_a_mesh(multidevice, tmp_path, monkeypatch):
    """dbrx-smoke with ``expert_axis="model"`` and the scatter dispatch in
    every MoE layer (so that the constraint is present at all): the port's
    logits on plain tensors against JAX's ``apply_model`` jitted on a (4, 2)
    ``("data", "model")`` mesh of 8 virtual devices, with the params placed
    by the tensor-parallel rules and the constraint on the dispatch
    buffers, within ``tests/_torch_model_parity.py``'s tolerance.  Both in
    a float32 residual stream: in the config's bfloat16 the compiled XLA
    run keeps excess precision (the reason the op-by-op parity tests run
    JAX un-jitted), and that flips the top-k routing of enough tokens to
    move 1.9% of the logits by up to 3.4 (a whole expert's share)."""
    import dataclasses
    import functools

    from _torch_model_parity import ATOL, converted_params, smoke_configs
    from repro_torch.models import apply_model

    tokens = np.random.default_rng(0).integers(0, 256, (8, 16)).astype(np.int32)
    inp, out = tmp_path / "tokens.npy", tmp_path / "logits.npy"
    np.save(inp, tokens)
    assert "DBRX_MESH_OK" in multidevice(DBRX_MESH.format(inp=str(inp), out=str(out)))
    want = np.load(out)
    _, _, tp = converted_params("dbrx-132b")
    tcfg = smoke_configs("dbrx-132b")[1]
    tcfg = dataclasses.replace(tcfg, dtype="float32",
                               moe=dataclasses.replace(tcfg.moe, expert_axis="model"))
    monkeypatch.setattr(M, "moe_ffn", functools.partial(M.moe_ffn, dispatch="scatter"))
    with torch.no_grad():
        got = apply_model(tp, tcfg, {"tokens": torch.from_numpy(tokens)}, mode="train")[0]
    assert got.shape == want.shape == (8, 16, tcfg.vocab_size)
    np.testing.assert_allclose(got.float().numpy(), want, atol=ATOL, rtol=0)
