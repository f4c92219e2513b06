"""Sharding specs: logical axes -> per-dimension mesh axes -> DTensor placements.

The port of the JAX package's ``launch/sharding.py``.  A spec is a tuple
with one entry per tensor dimension: ``None`` (replicated), a mesh axis
name, or a tuple of names: the content of JAX's ``PartitionSpec``.

  * Params carry logical-axis tuples (``models.model_axes``);
    :func:`param_specs` maps them onto the mesh with the JAX package's
    fallbacks: a logical axis whose mesh extent does not divide the
    dimension is replicated (the MaxText rule), and a mesh axis shards at
    most one dimension of an array.
  * Caches get structural specs by field name (:func:`cache_specs`): batch
    on the data axes, KV heads on ``model`` (else the sequence, so that
    long caches fit), the recurrent states' widths on ``model``; a stacked
    ``blocks`` cache leads with ``None`` for its group axis.
  * :func:`distribute` places a params tree on a ``DeviceMesh`` (the
    counterpart of ``named`` and ``device_put``), :func:`distribute_caches`
    a cache dict, each tensor by ``placements`` (one DTensor placement per
    mesh dimension).  ``placements``, ``constrain`` (JAX's
    ``with_sharding_constraint``) and ``rows_local`` live in
    ``core/sharding.py``, below the model layer that calls them, and are
    re-exported here.  The model runs on DTensors in the dry run's count of
    the collectives (``launch/dryrun.py``), under :func:`counting_rules`.

A mesh here is a ``DeviceMesh`` or a ``mesh.MeshShape`` (names and extents
alone).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.sharding import constrain, placements, rows_local  # noqa: F401
from repro_torch.tree import tree_map
from .mesh import MeshShape

#: cache fields the rules know by name
CACHE_FIELDS = ("k", "v", "positions", "index", "c_kv", "k_pe", "h", "conv_tail",
                "s", "shift_tm", "shift_cm")


def _extent(mesh: MeshShape, axes) -> int:
    if axes is None:
        return 1
    ext = 1
    for a in (axes,) if isinstance(axes, str) else axes:
        ext *= mesh.shape[a]
    return ext


def _spec_entry(mesh: MeshShape, rules: dict, logical, dim_size: int):
    mesh_axes = rules.get(logical)
    if mesh_axes is None:
        return None
    if isinstance(mesh_axes, str):
        mesh_axes = (mesh_axes,)
    mesh_axes = tuple(a for a in mesh_axes if a in mesh.axis_names)
    if not mesh_axes or dim_size % _extent(mesh, mesh_axes) != 0:
        return None                       # absent, or the divisibility fallback
    return mesh_axes if len(mesh_axes) > 1 else mesh_axes[0]


def param_spec(mesh, rules: dict, logical_axes: tuple, shape) -> tuple:
    """One array's spec from its logical axes and shape."""
    mesh = MeshShape.of(mesh)
    if len(logical_axes) != len(shape):
        raise ValueError(f"logical axes {logical_axes} do not match shape {tuple(shape)}")
    used: set[str] = set()
    entries = []
    for ax, dim in zip(logical_axes, shape):
        e = _spec_entry(mesh, rules, ax, dim) if ax is not None else None
        flat = (e,) if isinstance(e, str) else (e or ())
        if any(a in used for a in flat):
            e = None                      # one mesh axis shards one dim of an array
        used.update(flat if e is not None else ())
        entries.append(e)
    return tuple(entries)


def param_specs(mesh, rules: dict, axes_tree, params_tree):
    """The params' specs, in their tree's structure, from ``model_axes``.
    ``params_tree``'s leaves need only a ``shape``."""
    mesh = MeshShape.of(mesh)
    return tree_map(lambda p, ax: param_spec(mesh, rules, ax, tuple(p.shape)),
                    params_tree, axes_tree)


def _cache_leaf_spec(mesh: MeshShape, field: str, shape, batch_axes, stacked: bool):
    """Spec of one cache field; ``stacked``: a leading group axis."""
    lead = (None,) if stacked else ()
    if field == "index":                  # a Python int in the port: no dims of its own
        return lead
    core = tuple(shape[1:] if stacked else shape)
    model = mesh.shape["model"]
    ba = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    b = ba if core and core[0] % _extent(mesh, batch_axes) == 0 else None
    if field in ("k", "v"):                       # (B, S, KVH, D)
        _, s, kvh, _ = core
        if kvh % model == 0:
            return (*lead, b, None, "model", None)
        return (*lead, b, "model" if s % model == 0 else None, None, None)
    if field == "positions":                      # (B, S): replicated over S
        return (*lead, b, None)
    if field in ("c_kv", "k_pe"):                 # (B, S, R)
        return (*lead, b, "model" if core[1] % model == 0 else None, None)
    if field in ("h", "shift_tm", "shift_cm"):    # (B, W), (B, d)
        return (*lead, b, "model" if core[1] % model == 0 else None)
    if field == "conv_tail":                      # (B, cw - 1, W)
        return (*lead, b, None, "model" if core[2] % model == 0 else None)
    if field == "s":                              # (B, H, K, V)
        return (*lead, b, "model" if core[1] % model == 0 else None, None, None)
    return (*lead, b, *([None] * (len(core) - 1))) if core else lead


def cache_specs(mesh, caches: dict, batch_axes: tuple[str, ...]) -> dict:
    """The specs of an ``init_caches`` dict: the same structure, each cache
    dataclass holding its fields' specs (``index``'s is the group axis's
    ``None`` or empty, as the JAX package's scalar index)."""
    mesh = MeshShape.of(mesh)

    def one(cache, stacked: bool):
        return type(cache)(**{
            f.name: _cache_leaf_spec(
                mesh, f.name if f.name in CACHE_FIELDS else "",
                tuple(getattr(getattr(cache, f.name), "shape", ())), batch_axes, stacked)
            for f in dataclasses.fields(cache)})

    return {name: type(group)(one(c, name == "blocks") for c in group)
            for name, group in caches.items()}


def batch_specs(mesh, batch: dict, batch_axes: tuple[str, ...]) -> dict:
    """Each batch leaf sharded over the data axes on its first dim when they
    divide it, else replicated."""
    mesh = MeshShape.of(mesh)
    ba = batch_axes if len(batch_axes) > 1 else batch_axes[0]

    def spec(leaf):
        shape = tuple(leaf.shape)
        if shape and shape[0] % _extent(mesh, batch_axes) == 0:
            return (ba, *([None] * (len(shape) - 1)))
        return (None,) * len(shape)

    return {k: spec(v) for k, v in batch.items()}


def distribute(params, mesh, specs):
    """Place a params tree on a ``DeviceMesh`` by its specs: each tensor a
    DTensor (rank 0's values, scattered or broadcast)."""
    from torch.distributed.tensor import distribute_tensor

    def one(t: torch.Tensor, spec: tuple) -> Any:
        return distribute_tensor(t, mesh, placements(mesh, spec))

    return tree_map(one, params, specs)


@contextlib.contextmanager
def fake_mesh(mesh, order: tuple[str, ...] | None = None) -> Iterator:
    """A ``DeviceMesh`` of ``mesh``'s names and extents over a ``fake``
    process group of that many ranks in this one process (``torch.testing``'s
    ``FakeStore``): the collectives DTensor issues on it move nothing and
    return at once, so a step on meta DTensors shows which it would issue.
    The mesh's device type is "cuda", as the cards': on a "cpu" mesh DTensor
    replaces an all-to-all by an all-gather (gloo has none), and a "meta"
    mesh has no device count for DTensor's cost model.  That model reads the
    host's CUDA device count (0 or 1 where this runs), so every mesh dim
    counts as crossing hosts.  ``order`` permutes the mesh dims (every group
    keeps its size).  The group is destroyed on exit; the process must have
    no default group of its own."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    mesh = MeshShape.of(mesh)
    names = tuple(order or mesh.axis_names)
    if dist.is_initialized():
        raise RuntimeError("a fake mesh needs a process with no default process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(mesh.shape.values()))
    try:
        yield init_device_mesh("cuda", tuple(mesh.shape[a] for a in names),
                               mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def _gather_partial(op_schema):
    """``aten.gather``'s strategies as DTensor's, with a plain ``Partial``
    where DTensor's own take a masked one on the gathered dim."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._ops.utils import expand_to_full_mesh_op_strategy

    inp, dim, index = op_schema.args_schema[:3]
    dim %= inp.ndim
    found = [[Replicate()] * 3, [Shard(dim), Replicate(), Shard(dim)]]
    if index.shape[dim] == 1:
        found.append([Partial(), Shard(dim), Replicate()])
    if inp.ndim == index.ndim:
        found += [[Shard(d)] * 3 for d in range(inp.ndim) if d != dim]
    return expand_to_full_mesh_op_strategy(op_schema.get_mesh_from_args(), op_schema,
                                           found, input_index=1)


def _index_put(op_schema):
    """``aten.index_put`` (the backward of indexing a weight by tokens: a
    ``(V, d)`` gradient accumulated from ``(B, T, d)`` values at ``(B, T)``
    indices), the same in every release: over a mesh dim that splits the
    values and every index on one batch dim, each shard accumulates its own
    rows into a ``Partial`` sum; over one that splits the values on a dim
    past the indexed ones, the gradient is split on that dim; else all is
    replicated.  (torch 2.11's rule maps a batch split of the values to a
    negative dim of ``self`` and fails.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor._ops.utils import generate_redistribute_costs

    inp, indices, values = op_schema.args_schema[:3]
    accumulate = bool(op_schema.args_schema[3]) if len(op_schema.args_schema) > 3 else False
    kids = list(indices.children)
    mesh = values.mesh
    vspec = values.strategies[0].output_spec
    ispecs = [k.strategies[0].output_spec for k in kids]
    n_idx, b_nd = len(kids), max(s.ndim for s in ispecs)
    out_pl, in_pl, idx_pl, val_pl = [], [], [[] for _ in kids], []
    for i, p in enumerate(vspec.placements):
        if (isinstance(p, Shard) and p.dim < b_nd and accumulate
                and all(s.placements[i] == p for s in ispecs)):
            out_pl.append(Partial()), in_pl.append(Partial()), val_pl.append(p)
            for pl in idx_pl:
                pl.append(p)
        elif isinstance(p, Shard) and p.dim >= b_nd:
            d = Shard(p.dim - b_nd + n_idx)
            out_pl.append(d), in_pl.append(d), val_pl.append(p)
            for pl in idx_pl:
                pl.append(Replicate())
        else:
            for pl in (out_pl, in_pl, val_pl, *idx_pl):
                pl.append(Replicate())

    def spec(strategy, placements):
        return DTensorSpec(mesh, tuple(placements),
                           tensor_meta=strategy.strategies[0].output_spec.tensor_meta)

    ins = [spec(inp, in_pl), *(spec(k, pl) for k, pl in zip(kids, idx_pl)),
           spec(values, val_pl)]
    costs = [generate_redistribute_costs(s, t)
             for s, t in zip([inp, *kids, values], ins)]
    return OpStrategy([OpSpec(output_specs=spec(inp, out_pl), input_specs=tuple(ins),
                              redistribute_cost=costs)])


def _index_write(op_schema):
    """``aten.index_put_`` writing whole slots in place at 1-D indices (a
    decode step's ``cache[:, slot] = values``, ``slot`` on the device), the same in
    every release: ``self`` keeps its placements; over a mesh dim that splits
    it on a dim the write does not index, the values are split the same way;
    over one that splits an indexed dim (a cache split on its positions),
    they are replicated and the slot's owner writes them, as GSPMD lowers a
    dynamic-update-slice of a split dim; the indices are replicated."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor._ops.utils import generate_redistribute_costs

    inp, indices, values = op_schema.args_schema[:3]
    kids = list(getattr(indices, "children", indices))   # a list, None where unindexed
    in_spec = inp.strategies[0].output_spec
    # 1-D indices keep self's rank; the values align to its last dims (a
    # setitem drops their leading ones)
    off = in_spec.ndim - values.strategies[0].output_spec.ndim
    indexed = {d for d, k in enumerate(kids) if k is not None}
    mesh = values.mesh
    val_pl = [Shard(p.dim - off) if isinstance(p, Shard) and p.dim not in indexed
              and p.dim >= off else Replicate() for p in in_spec.placements]

    def spec(strategy, placements):
        return DTensorSpec(mesh, tuple(placements),
                           tensor_meta=strategy.strategies[0].output_spec.tensor_meta)

    idx = [k for k in kids if k is not None]
    ins = [in_spec, *(spec(k, [Replicate()] * mesh.ndim) for k in idx), spec(values, val_pl)]
    costs = [generate_redistribute_costs(s, t) for s, t in zip([inp, *idx, values], ins)]
    return OpStrategy([OpSpec(output_specs=in_spec, input_specs=tuple(ins),
                              redistribute_cost=costs)])


def _per_mesh_dim(op_schema, found):
    """``found`` (a list of [output, *inputs] placements over one mesh dim)
    expanded over every mesh dim, each combination costed from the inputs'
    placements, as DTensor's own single-dim rules are."""
    from torch.distributed.tensor._ops.utils import expand_to_full_mesh_op_strategy

    return expand_to_full_mesh_op_strategy(op_schema.get_mesh_from_args(), op_schema,
                                           found, input_index=1)


def _roll(op_schema):
    """``aten.roll`` (a prefill's ring-buffer cache fill): split on a dim it
    does not roll, a ``Partial`` sum kept (roll is linear), or replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    inp = op_schema.args_schema[0]
    dims = op_schema.args_schema[2] if len(op_schema.args_schema) > 2 else []
    rolled = {d % inp.ndim for d in dims} or set(range(inp.ndim))
    return _per_mesh_dim(op_schema, [[Replicate()] * 2, [Partial()] * 2]
                         + [[Shard(d)] * 2 for d in range(inp.ndim) if d not in rolled])


def _constant_pad_nd(op_schema):
    """``aten.constant_pad_nd`` (``F.pad``: the einsum dispatch's token
    groups, MLA's value width): split on a dim it does not pad, a ``Partial``
    sum kept where the pad value is 0, or replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    inp, pad = op_schema.args_schema[:2]
    value = op_schema.args_schema[2] if len(op_schema.args_schema) > 2 else 0
    padded = {inp.ndim - 1 - i for i in range(len(pad) // 2) if pad[2 * i] or pad[2 * i + 1]}
    found = [[Replicate()] * 2] + [[Shard(d)] * 2 for d in range(inp.ndim) if d not in padded]
    if not padded or value == 0:
        found.append([Partial()] * 2)
    return _per_mesh_dim(op_schema, found)


def _add(op_schema):
    """``aten.add.Tensor``'s placements, as torch 2.13's single-dim rule
    gives them: the output split on any dim, each operand split on its
    broadcast dim or replicated where it was broadcast; two ``Partial``
    sums add into one; or replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._op_schema import OpStrategy
    from torch.distributed.tensor._ops.utils import infer_broadcast_dims_map

    tensors = [a for a in op_schema.args_schema if isinstance(a, OpStrategy)]
    shape = torch.broadcast_shapes(*(t.shape for t in tensors))
    found = [[Replicate()] * (1 + len(tensors))]
    for d in range(len(shape)):
        found.append([Shard(d)] + [
            Shard(m[d]) if (m := infer_broadcast_dims_map(shape, t.shape))[d] >= 0
            else Replicate() for t in tensors])
    if len(tensors) == 2:
        found.append([Partial()] * 3)
    return _per_mesh_dim(op_schema, found)


def _reachable(own, fallback):
    """``own``'s strategy unless no placement it offers can be reached from
    the inputs' (each has an infinite redistribute cost), then
    ``fallback``'s.  (torch 2.11's pointwise rule follows the operand with
    more shards and asks the other for its placement: a row-parallel
    product's ``Partial`` plus a bias split over the same mesh dim asks the
    bias for a ``Partial`` it cannot reach.)"""
    def rule(op_schema):
        strategy = own(op_schema)
        if all(any(math.isinf(c) for costs in spec.redistribute_cost for c in costs)
               for spec in strategy.strategies):
            return fallback(op_schema)
        return strategy
    return rule


class _LocalViews(TorchDispatchMode):
    """Runs a shard's ``view`` that its layout cannot take as a copy, as
    ``reshape`` runs it.  ``reshape`` on a DTensor picks ``view`` from the
    DTensor's strides, which come from the op's meta propagation on the
    global tensor; after a redistribute (whose collective writes a
    contiguous shard) the shard's own layout can differ (torch 2.11: the
    experts' product in ``moe.py``)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if func is torch.ops.aten.view.default:
            x, size = args
            try:
                return func(x, size)
            except RuntimeError:
                return torch.ops.aten._unsafe_view(x.contiguous(), size)
        return func(*args, **kwargs)


@contextlib.contextmanager
def counting_rules() -> Iterator[None]:
    """DTensor's rules, changed for a count of a sharded step on meta
    tensors (put back on exit).  Each rule below is one that a release's
    own propagation could not run on the port's model; every op but
    ``add`` gets the same rule in every release (the release's single-dim
    rule, where it has one, is set aside):

      * the kernels' ops get their rules (``kernels.library.
        register_shardings``);
      * ``aten.gather`` on a dim split over a mesh axis (the loss's pick of
        the label's logit from vocab-split logits) gives a plain ``Partial``
        sum: the same all-reduce as DTensor's masked partial, whose mask
        bookkeeping meta tensors cannot run (``torch.equal``, and a mask of
        another rank than the value once the value is indexed);
      * ``view`` and ``_unsafe_view`` gather what they cannot keep split, as
        ``reshape`` does, where DTensor's raise: its rules split a dim
        unevenly (an ``(H * D)`` projection over more ranks than ``H``),
        which GSPMD pads instead;
      * ``index_put`` (an embedding lookup's backward, :func:`_index_put`;
        torch 2.11's maps a batch split of the values to a negative dim of
        ``self``), ``index_put_`` (a decode step's cache write at a slot on
        the device, :func:`_index_write`; 2.13's cannot keep a cache split
        on its positions), ``roll`` (:func:`_roll`; 2.11 has none),
        ``constant_pad_nd`` (:func:`_constant_pad_nd`; 2.11's places a 1-D
        mesh only);
      * a shard's ``view`` its layout cannot take runs as a copy
        (:class:`_LocalViews`);
      * ``add.Tensor``, where the release's own rule is not a single-dim
        one (torch 2.11), falls back to :func:`_add` when it offers no
        placement the inputs can reach (:func:`_reachable`)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops._view_ops import register_op_strategy_map

    from repro_torch.kernels import library

    library.register_shardings()
    prop = DTensor._op_dispatcher.sharding_propagator
    aten = torch.ops.aten
    tables = (prop.op_strategy_funcs, prop.op_to_schema_info,
              prop.op_single_dim_strategy_funcs,
              prop.op_to_schema_info_for_single_dim_strategy)
    rules = {aten.gather.default: (_gather_partial,
                                   prop.op_to_schema_info.get(aten.gather.default)),
             aten.index_put.default: (_index_put, RuntimeSchemaInfo(needs_pytree=True)),
             aten.index_put_.default: (_index_write, RuntimeSchemaInfo(needs_pytree=True)),
             aten.roll.default: (_roll, RuntimeSchemaInfo(1)),
             aten.constant_pad_nd.default: (_constant_pad_nd, RuntimeSchemaInfo(1))}
    add = aten.add.Tensor
    if add in prop.op_strategy_funcs and add not in prop.op_single_dim_strategy_funcs:
        rules[add] = (_reachable(prop.op_strategy_funcs[add], _add),
                      prop.op_to_schema_info.get(add))
    views = (aten.view.default, aten._unsafe_view.default)
    before = [{op: t[op] for op in (*rules, *views) if op in t} for t in tables]
    for op in (*rules, *views):
        for t in tables[2:]:
            t.pop(op, None)
    for op, (fn, info) in rules.items():
        prop.register_op_strategy(op, fn, info)
    for op in views:
        register_op_strategy_map(op, torch.Tensor.view, schema_info=before[1].get(op))
    prop.propagate_op_sharding.cache_clear()
    try:
        with _LocalViews():
            yield
    finally:
        for t, saved in zip(tables, before):
            for op in (*rules, *views):
                t.pop(op, None)
            t.update(saved)
        prop.propagate_op_sharding.cache_clear()


def distribute_caches(caches: dict, mesh, specs: dict) -> dict:
    """An ``init_caches`` dict placed on a ``DeviceMesh`` by its
    :func:`cache_specs`: each tensor field a DTensor, the rest as they are."""
    from torch.distributed.tensor import distribute_tensor

    def one(cache, spec):
        return type(cache)(**{
            f.name: (distribute_tensor(v, mesh, placements(mesh, getattr(spec, f.name)))
                     if isinstance(v := getattr(cache, f.name), torch.Tensor) else v)
            for f in dataclasses.fields(cache)})

    return {name: type(group)(one(c, sp) for c, sp in zip(group, specs[name]))
            for name, group in caches.items()}
