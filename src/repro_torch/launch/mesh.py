"""Device meshes and the logical-axis sharding rules.

The port of the JAX package's ``launch/mesh.py``.  A mesh is a
``torch.distributed`` ``DeviceMesh`` with named dimensions: ``("data",
"model")`` on a host, ``("data", "model")`` of (16, 16) or ``("pod", "data",
"model")`` of (2, 16, 16) in production.  Building one needs a process group
of exactly that many ranks; :class:`MeshShape` carries the names and extents
alone, so that ``launch/sharding.py`` computes specs without a process group
(as the JAX package's tests do with a fake mesh).  Nothing here touches a
device or a process group when the module is imported.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import FSDP_TP_RULES, ModelConfig, ShardingConfig

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's dimension names, in mesh order, and their extents: what the
    sharding rules read of a mesh."""

    axis_names: tuple[str, ...]
    shape: dict[str, int]

    @classmethod
    def of(cls, mesh) -> MeshShape:
        """A ``DeviceMesh`` (or anything with ``axis_names`` and a ``shape``
        mapping, as a ``MeshShape``) as a ``MeshShape``."""
        names = getattr(mesh, "mesh_dim_names", None)
        if names is None:
            return cls(tuple(mesh.axis_names), dict(mesh.shape))
        return cls(tuple(names), {n: mesh.size(i) for i, n in enumerate(names)})


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """The production mesh's names and extents (no process group needed)."""
    shape, names = PRODUCTION[multi_pod]
    return MeshShape(names, dict(zip(names, shape)))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production ``DeviceMesh``: (16, 16) ``("data", "model")``, or
    (2, 16, 16) ``("pod", "data", "model")`` with ``multi_pod``.  It needs an
    initialised default process group of 256 (512) ranks, one a device, and
    raises otherwise; for specs alone, :func:`production_mesh_shape`."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = PRODUCTION[multi_pod]
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_host_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """A small ``("data", "model")`` ``DeviceMesh`` over the ranks of the
    default process group (tests, examples).  As the JAX package's, the
    extents are cut to what the ranks allow (``data`` at most the world
    size, ``model`` at most what is left); the mesh must then take every
    rank, or this raises."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, max(n // data, 1))
    if data * model != n:
        raise ValueError(f"a ({data}, {model}) mesh does not take all {n} ranks")
    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))


def _axis_groups(shape: tuple[int, ...], dim: int) -> list:
    """The process groups along mesh dim ``dim`` of the default group's
    ranks laid out in row-major ``shape`` (global rank ``r`` at the index
    ``np.unravel_index(r, shape)``, the order of ``Mesh(devices.reshape(
    shape), names)``), one for each index of the other dims, in their
    row-major order.  Every rank creates every group in the same order, as
    ``dist.new_group`` requires."""
    import itertools

    import torch.distributed as dist

    others = [range(n) if d != dim else [None] for d, n in enumerate(shape)]
    groups = []
    for idx in itertools.product(*others):
        members = []
        for i in range(shape[dim]):
            full = list(idx)
            full[dim] = i
            members.append(sum(c * math.prod(shape[d + 1:]) for d, c in enumerate(full)))
        groups.append(dist.new_group(members))
    return groups


def make_data_axes(data: int, model: int = 1, pods: int = 1) -> tuple:
    """The data axes of this rank, over the ranks of the default process
    group laid out as a ``("pod", "data", "model")`` mesh of ``(pods, data,
    model)`` (``--data-par`` and ``--pods`` of the training CLI): global
    rank ``r`` is pod ``r // (data * model)``, data index ``r // model %
    data`` and model index ``r % model``, the order of a mesh over the
    devices reshaped to those extents.  Returns ``core.collectives.DataAxis``
    es, outer first: the ``data`` axis of this rank's model index, preceded
    by the ``pod`` axis when ``pods`` > 1.  The ranks of one model index
    take the batch's rows; the ``model`` ranks of one data index hold the
    same rows and the same params, as the JAX package's step over the data
    axes with the params in ``P()`` replicates them over ``model``.

    The groups come from ``dist.new_group``, every rank creating every
    group in the same order; they take the default group's backend, gloo,
    which carries the host-staged payloads of CUDA tensors.  (A
    ``DeviceMesh`` of device type "cuda" would give NCCL groups, which
    refuse two ranks on one card.)  The axes share one set of staging
    buffers.  One axis over the whole default group is that group itself.
    Raises ``ValueError`` when the extents do not take the world, or when
    pods come with a model axis (a layout the JAX package's CLI does not
    have)."""
    import torch.distributed as dist
    from repro_torch.core.collectives import DataAxis, StagingBuffers

    world = dist.get_world_size()
    if min(data, model, pods) < 1 or data * model * pods != world:
        raise ValueError(f"a ({pods}, {data}, {model}) mesh does not take {world} ranks")
    if pods > 1 and model > 1:
        raise ValueError(f"{pods} pods with a model axis of {model} is not a layout "
                         "of the training CLI")
    staging = StagingBuffers()
    if data == world:
        return (DataAxis(None, staging),)
    shape, rank = (pods, data, model), dist.get_rank()
    data_group = _axis_groups(shape, 1)[rank // (data * model) * model + rank % model]
    if pods == 1:
        return (DataAxis(data_group, staging),)
    pod_group = _axis_groups(shape, 0)[rank % (data * model)]
    return (DataAxis(pod_group, staging), DataAxis(data_group, staging))


def data_axis_names(mesh) -> tuple[str, ...]:
    """The mesh's data-parallel axes, ``pod`` and ``data``, in mesh order."""
    return tuple(a for a in MeshShape.of(mesh).axis_names if a in ("pod", "data"))


def rules_for(cfg: ModelConfig, mode: str = "auto") -> dict:
    """Logical-axis -> mesh-axis rules; big models get FSDP+TP.

    ``auto`` takes FSDP+TP above 30B parameters, else tensor parallelism
    alone (``tp``).  ``ep2d`` shards the expert dim over (model, pod, data):
    viable when the expert count divides the whole mesh (deepseek-v3: 256 =
    16 x 16); archs whose expert count does not divide it fall back to
    model-only sharding by the divisibility rule.
    """
    if mode in ("fsdp_tp", "ep2d") or (mode == "auto" and cfg.param_count() > 30e9):
        rules = dict(FSDP_TP_RULES)
        if mode == "ep2d":
            rules["experts"] = ("model", "pod", "data")
        return rules
    return ShardingConfig().lookup()
