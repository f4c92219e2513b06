"""Sharding constraints on DTensors, the counterpart of JAX's
``with_sharding_constraint`` that the model layer calls (``models/moe.py``),
below the launch layer that builds meshes and specs (``launch/sharding.py``
re-exports these).

A spec is a tuple with one entry per tensor dim: ``None`` (replicated), a
mesh axis name, or a tuple of names: the content of JAX's
``PartitionSpec``.  A mesh is a ``DeviceMesh``, or anything with
``axis_names`` (``launch.mesh.MeshShape``).

  * :func:`placements` turns a spec into DTensor placements, one per mesh
    dimension;
  * :func:`constrain` redistributes a DTensor to a spec, and leaves a plain
    tensor as it is;
  * :func:`rows_local` runs a function on each shard's rows, as ``vmap``
    over a batch split over the data axes runs under GSPMD.
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def placements(mesh, spec: tuple) -> list:
    """DTensor placements, one per mesh dimension in mesh order: ``Shard(d)``
    where the spec names that mesh axis at tensor dim ``d``, else
    ``Replicate()``.  A dim sharded over several mesh axes is split in mesh
    order, so its names must come in mesh order (JAX's major-to-minor);
    ``ep2d``'s ``("model", "pod", "data")`` does not, and raises: the dry
    run places it on a mesh whose dims are permuted to that order
    (``launch/dryrun.py``), where every group keeps its size."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(getattr(mesh, "mesh_dim_names", None) or mesh.axis_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec entry {entry} of dim {d} is not in mesh order {names}: DTensor "
                "shards a dim over several mesh axes only in mesh order")
        for i in idx:
            out[i] = Shard(d)
    return out


def rows_local(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` on each shard's rows, as ``jax.vmap`` over a
    batch split over the data axes runs under GSPMD: DTensor ``args`` keep a
    split of their dim 0 and are replicated over every other mesh dim, ``fn``
    runs on the local tensors, and its outputs (rows first) come back as
    DTensors so split.  On plain tensors, ``fn(*args, **kwargs)``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args, **kwargs)
    mesh = dts[0].device_mesh
    rows = [Shard(0) if any(t.placements[i] == Shard(0) for t in dts) else Replicate()
            for i in range(mesh.ndim)]
    local = [a.redistribute(mesh, rows).to_local() if isinstance(a, DTensor) else a
             for a in args]
    return tree_map(lambda o: DTensor.from_local(o, mesh, rows, run_check=False),
                    fn(*local, **kwargs))


def constrain(t: torch.Tensor, spec: tuple | None) -> torch.Tensor:
    """JAX's ``with_sharding_constraint(t, PartitionSpec(*spec))``: a DTensor
    redistributed to ``spec``'s placements on its own mesh (a mesh axis the
    spec does not name is ``Replicate()``); a plain tensor, or a ``None``
    spec, as it is."""
    from torch.distributed.tensor import DTensor

    if spec is None or not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, placements(t.device_mesh, spec))
