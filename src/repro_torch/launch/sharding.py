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
  * :func:`placements` turns a spec into DTensor ``Shard`` / ``Replicate``
    placements, one per mesh dimension; :func:`distribute` places a params
    tree on a ``DeviceMesh`` (the counterpart of ``named`` and
    ``device_put``).  Running the model on the shards is later work (ROADMAP
    queue 1, item 8).

A mesh here is a ``DeviceMesh`` or a ``mesh.MeshShape`` (names and extents
alone).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

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


def placements(mesh, spec: tuple) -> list:
    """DTensor placements, one per mesh dimension in mesh order: ``Shard(d)``
    where the spec names that mesh axis at tensor dim ``d``, else
    ``Replicate()``.  A dim sharded over several mesh axes is split in mesh
    order, so its names must come in mesh order (JAX's major-to-minor);
    ``ep2d``'s ``("model", "pod", "data")`` does not, and raises: DTensor
    cannot place it, and running such a layout is ROADMAP queue 1, item 8."""
    from torch.distributed.tensor import Replicate, Shard

    names = MeshShape.of(mesh).axis_names
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec entry {entry} of dim {d} is not in mesh order {names}: DTensor "
                "shards a dim over several mesh axes only in mesh order (placing "
                "such a layout is ROADMAP queue 1, item 8)")
        for i in idx:
            out[i] = Shard(d)
    return out


def distribute(params, mesh, specs):
    """Place a params tree on a ``DeviceMesh`` by its specs: each tensor a
    DTensor (rank 0's values, scattered or broadcast)."""
    from torch.distributed.tensor import distribute_tensor

    def one(t: torch.Tensor, spec: tuple) -> Any:
        return distribute_tensor(t, mesh, placements(mesh, spec))

    return tree_map(one, params, specs)
