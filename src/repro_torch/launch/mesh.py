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


def make_pod_axes(pods: int) -> tuple:
    """The data axes of a pod layout over the ranks of the default process
    group: ``(pod, data)`` ``core.collectives.DataAxis``es of ``pods`` pods
    of ``world // pods`` ranks.  Global rank ``r`` is pod ``r // D``, data
    index ``r % D``: the order of a ``("pod", "data")`` mesh over the
    devices reshaped to ``(pods, D)``, and of a batch split over both axes
    (rank ``r`` takes the ``r``-th share of its rows).  The ``data`` axis
    runs the configured schedule inside a pod, the ``pod`` axis a ring
    across the pods (``training.train_step``).

    The groups come from ``dist.new_group``, every rank creating every
    group in the same order, as the call requires; they take the default
    group's backend, gloo, which carries the host-staged payloads of CUDA
    tensors.  (A ``DeviceMesh`` of device type "cuda" would give NCCL
    groups, which refuse two ranks on one card.)  The two axes share one
    set of staging buffers.  Raises ``ValueError`` when ``pods`` does not
    divide the world."""
    import torch.distributed as dist
    from repro_torch.core.collectives import DataAxis, StagingBuffers

    world = dist.get_world_size()
    if pods < 1 or world % pods:
        raise ValueError(f"{pods} pods do not divide {world} ranks")
    per_pod = world // pods
    rank = dist.get_rank()
    data_groups = [dist.new_group([p * per_pod + d for d in range(per_pod)])
                   for p in range(pods)]
    pod_groups = [dist.new_group([p * per_pod + d for p in range(pods)])
                  for d in range(per_pod)]
    staging = StagingBuffers()
    return (DataAxis(pod_groups[rank % per_pod], staging),
            DataAxis(data_groups[rank // per_pod], staging))


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
