"""The port's mesh and sharding rules (``launch/mesh.py``,
``launch/sharding.py``, ``models.model_axes``) held to the JAX package's.

Each case of ``tests/test_sharding.py`` is run through both packages on the
same fake mesh, then every parameter's, cache leaf's and batch leaf's spec
is compared for all 11 archs (smoke and full configs), on the (16, 16)
``("data", "model")`` and (2, 16, 16) ``("pod", "data", "model")`` meshes, in
the rule modes ``auto``, ``tp``, ``fsdp_tp`` and ``ep2d``.  A port spec is
the tuple of JAX's ``PartitionSpec`` entries; equality is exact.  Full
configs are reckoned from shapes alone: JAX's params and caches under
``jax.eval_shape``, the port's caches on the ``meta`` device.  Last, 4 gloo
CPU ranks place a smoke model's weights on a (2, 2) DeviceMesh and gather
them back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from _torch_ranks import sharding_rank
from repro.configs.base import FSDP_TP_RULES as J_FSDP_TP_RULES
from repro.configs.base import ShardingConfig as JShardingConfig
from repro.launch import mesh as jmesh
from repro.launch import sharding as jshard
from repro.models import get_config as jax_get_config
from repro.models import get_smoke_config as jax_smoke
from repro.models import init_caches as jax_init_caches
from repro.models import init_model as jax_init_model
from repro.models import list_architectures
from repro_torch.configs.base import FSDP_TP_RULES, ShardingConfig
from repro_torch.data import make_batch
from repro_torch.launch import ranks
from repro_torch.launch.dryrun import mesh_order
from repro_torch.launch.mesh import (MeshShape, data_axis_names, production_mesh_shape,
                                     rules_for)
from repro_torch.launch.sharding import (batch_specs, cache_specs, param_spec,
                                         param_specs, placements)
from repro_torch.models import (get_config, get_smoke_config, init_caches, init_model,
                                model_axes)
from repro_torch.tree import tree_map

ARCHS = list_architectures()
MODES = ("auto", "tp", "fsdp_tp", "ep2d")


class FakeMesh:
    """Spec-level mesh stand-in with production extents (the JAX tests')."""
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class FakePodMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


MESHES = {"16x16": FakeMesh, "2x16x16": FakePodMesh}


def _t(spec: P) -> tuple:
    return tuple(spec)


def _is_p(x):
    return isinstance(x, P)


# ---- the cases of tests/test_sharding.py, through both packages ------------

@pytest.mark.parametrize("logical,shape", [
    (("embed", "heads", None), (4096, 32, 128)),      # test_param_pspec_divisible
    (("embed", "heads", None), (960, 15, 64)),        # ..._fallback_on_indivisible
])
def test_param_spec_tp_rules_match_jax(logical, shape):
    got = param_spec(FakeMesh(), ShardingConfig().lookup(), logical, shape)
    want = jshard.param_pspec(FakeMesh(), JShardingConfig().lookup(), logical, shape)
    assert got == _t(want)
    assert got == ((None, "model", None) if shape[1] == 32 else (None, None, None))


@pytest.mark.parametrize("logical,shape", [
    (("vocab", "embed"), (256000, 4096)),             # test_no_double_axis_use
    (("embed", "mlp"), (8192, 22016)),                # test_fsdp_rules_shard_embed_over_data
    (("embed", "embed"), (4096, 4096)),               # an axis used twice in one array
])
def test_param_spec_fsdp_rules_match_jax(logical, shape):
    for mesh in MESHES.values():
        got = param_spec(mesh(), dict(FSDP_TP_RULES), logical, shape)
        want = jshard.param_pspec(mesh(), dict(J_FSDP_TP_RULES), logical, shape)
        assert got == _t(want), (mesh.axis_names, logical)
    flat = [a for e in param_spec(FakeMesh(), dict(FSDP_TP_RULES), ("embed", "mlp"),
                                  (8192, 22016)) for a in ((e,) if isinstance(e, str) else e)]
    assert "data" in flat and "model" in flat


def test_cache_specs_kv_heads_vs_seq_match_jax():
    """``test_cache_specs_kv_heads_vs_seq``: glm4-9b's smoke caches, batch 32
    sharded on the dim after the stacked group dim."""
    caches = init_caches(get_smoke_config("glm4-9b"), 32, 64, device="meta")
    specs = cache_specs(FakeMesh(), caches, ("data",))
    jspecs = jshard.cache_pspecs(
        FakeMesh(), jax.eval_shape(lambda: jax_init_caches(jax_smoke("glm4-9b"), 32, 64)),
        ("data",))
    assert _cache_table(specs) == _jax_cache_table(jspecs)
    k = specs["blocks"][0].k
    assert k[0] is None and k[1] == "data"


def test_batch_specs_match_jax():
    batch = {"tokens": np.zeros((256, 4096), np.int32), "odd": np.zeros((7, 3), np.float32)}
    specs = batch_specs(FakeMesh(), batch, ("data",))
    jspecs = jshard.batch_pspecs(FakeMesh(), batch, ("data",))
    assert specs == {k: _t(v) for k, v in jspecs.items()}
    assert specs == {"tokens": ("data", None), "odd": (None, None)}


def test_every_arch_gets_a_spec_per_param():
    """``test_all_archs_get_valid_specs``: one spec per param leaf for
    every smoke config, from the port's own params and ``model_axes``."""
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        params = init_model(cfg, seed=0, device="cpu")
        specs = param_specs(FakeMesh(), ShardingConfig().lookup(), model_axes(cfg), params)
        rows = []
        tree_map(lambda p, s: rows.append(len(s) == p.dim()), params, specs)
        assert rows and all(rows), arch


# ---- every arch, both meshes, every mode --------------------------------

def _jax_axes(cfg):
    holder = {}

    def capture():
        p, a = jax_init_model(jax.random.PRNGKey(0), cfg)
        holder["a"] = a
        return p
    shapes = jax.eval_shape(capture)
    return shapes, holder["a"]


def _port_leaves(params, specs) -> list:
    rows = []
    tree_map(lambda p, s: rows.append(s), params, specs)
    return rows


def _cache_table(specs) -> dict:
    return {(group, i, f): getattr(c, f)
            for group, caches in specs.items() for i, c in enumerate(caches)
            for f in c.__dataclass_fields__}


def _jax_cache_table(jspecs) -> dict:
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=_is_p)[0]:
        group, i, field = path[0].key, path[1].idx, path[-1].name
        out[(group, i, field)] = _t(spec)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax_for_every_leaf(arch):
    """For the smoke and the full config: ``model_axes`` equals the axes
    JAX's ``init_model`` returns; every param's spec under every mode's
    rules, every cache leaf's (two batch and context sizes) and every batch
    leaf's (a batch the data axes divide and one they do not) equals JAX's,
    on both fake meshes.  The smoke config's params are the port's own."""
    for smoke in (True, False):
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
        jcfg = jax_smoke(arch) if smoke else jax_get_config(arch)
        jshapes, jaxes = _jax_axes(jcfg)
        axes = model_axes(cfg)
        assert axes == jaxes
        params = init_model(cfg, seed=0, device="cpu") if smoke else jshapes
        caches = {bc: init_caches(cfg, *bc, device="meta") for bc in ((32, 64), (7, 40))}
        jcaches = {bc: jax.eval_shape(lambda bc=bc: jax_init_caches(jcfg, *bc))
                   for bc in caches}
        batches = [make_batch(cfg, seq_len=300, batch_size=n, step=0) for n in (32, 7)]
        for mname, mesh in MESHES.items():
            mesh = mesh()
            assert data_axis_names(mesh) == jmesh.data_axis_names(mesh)
            for mode in MODES:
                rules = rules_for(cfg, mode)
                assert rules == jmesh.rules_for(jcfg, mode)
                got = _port_leaves(params, param_specs(mesh, rules, axes, params))
                want = jax.tree_util.tree_leaves(
                    jshard.param_pspecs(mesh, rules, jaxes, jshapes), is_leaf=_is_p)
                assert got == [_t(s) for s in want], (cfg.name, mname, mode)
            ba = data_axis_names(mesh)
            for bc in caches:
                assert _cache_table(cache_specs(mesh, caches[bc], ba)) == \
                    _jax_cache_table(jshard.cache_pspecs(mesh, jcaches[bc], ba)), \
                    (cfg.name, mname, bc)
            for batch in batches:
                assert batch_specs(mesh, batch, ba) == {
                    k: _t(v) for k, v in jshard.batch_pspecs(mesh, batch, ba).items()}


def test_mesh_shapes_and_placements():
    """The production mesh's names and extents; DTensor placements from a
    spec, in mesh order, and the refusal of ``ep2d``'s expert spec, whose
    names are not in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    pod = production_mesh_shape(multi_pod=True)
    assert pod == MeshShape(("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16})
    assert MeshShape.of(FakeMesh()) == production_mesh_shape()
    assert placements(pod, (("pod", "data"), None, "model")) == [Shard(0), Shard(0), Shard(2)]
    assert placements(pod, (None, None)) == [Replicate()] * 3
    # deepseek-v3's 256 experts over the 16 x 16 mesh's model and data axes
    mesh = production_mesh_shape()
    spec = param_spec(mesh, rules_for(get_config("deepseek-v3-671b"), "ep2d"),
                      ("experts", "expert_embed", "expert_mlp"), (256, 7168, 2048))
    assert spec == (("model", "data"), None, None)
    with pytest.raises(ValueError, match="not in mesh order"):
        placements(mesh, spec)
    # the dry run places it on the mesh with its dims permuted to that order
    order = mesh_order(mesh, [spec, (("data",), None)])
    assert order == ("model", "data")
    assert placements(MeshShape(order, mesh.shape), spec) == [Shard(0), Shard(0)]


def test_params_placed_on_4_gloo_ranks():
    """4 CPU ranks, a (2, 2) ``("data", "model")`` DeviceMesh: each rank's
    local shard of smollm-360m's smoke params has the shape its spec gives
    (each named mesh axis divides its dim by 2), and ``full_tensor()`` gives
    the weights back bit for bit, under the tensor-parallel rules and under
    FSDP+TP (which shards the embed dims over data as well)."""
    modes = ("tp", "fsdp_tp")
    out = ranks.run(sharding_rank, 4, "cpu", args=("smollm-360m", modes), timeout=300)
    for mode in modes:
        used = set()
        for r in out:
            for name, (spec, local, whole, same) in r[mode].items():
                want = list(whole)
                for d, e in enumerate(spec):
                    for a in () if e is None else (e,) if isinstance(e, str) else e:
                        want[d] //= 2
                        used.add(a)
                assert local == tuple(want) and same, (mode, name, spec)
        assert used == ({"model"} if mode == "tp" else {"data", "model"})
