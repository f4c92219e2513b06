"""Training step with pluggable gradient synchronization.

The port of the JAX package's ``training/train_step.py``, over the data
axes of a mesh (each a :class:`~repro_torch.core.collectives.DataAxis`;
every rank holds its own share of the global batch):

  * ``sync="xla"``   — autograd, then an all-reduce mean of the float32
    gradients over the data axes (``dist.all_reduce``; the baseline).
    Without an axis the step trains on one process.
  * ``sync="r2ccl"`` — autograd, then the gradients, cast to the wire dtype
    (``CommConfig.comm_dtype``), are synchronized by an explicit R2CCL
    collective program (ring / tree / r2ccl-allreduce / recursive, per the
    ``CommConfig``), whose every round merges in the ``chunk_combine``
    kernel; the metrics are averaged over the data axes.  Failure-aware
    schedules switch here without touching the model code.

Multi-pod meshes sync hierarchically, as the JAX package's step does: the
configured schedule runs over the innermost (intra-pod ``data``) axis, then
an explicit ring combines over each outer (``pod``) axis.  A ``model`` axis
holds replicas: the JAX package's step is manual over the data axes alone,
with the params in ``P()``, so the model ranks of one data index compute the
same values, and the step reduces over the data axes of this rank's model
index only (``launch.mesh.make_data_axes``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.configs.base import CommConfig, ModelConfig
from repro_torch.core.collectives import DataAxis, all_reduce_mean, sync_over_axes
from repro_torch.device import timed
from repro_torch.models import apply_model
from repro_torch.models.layers import cross_entropy
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.optim.schedules import cosine_with_warmup
from repro_torch.tree import leaves, tree_map, unflatten
from . import losses

WIRE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int


def init_train_state(params) -> TrainState:
    """Train state over ``params``, whose tensors become autograd leaves."""
    for p in leaves(params):
        p.requires_grad_(True)
    return TrainState(params=params, opt_state=init_opt_state(params), step=0)


def compute_loss(params, cfg: ModelConfig, batch) -> tuple[torch.Tensor, dict]:
    """(total loss, metrics) of the model in train mode on ``batch``; with
    ``cfg.mtp`` the MTP head's cross-entropy, weighted by
    ``cfg.mtp_loss_weight``, joins the total."""
    logits, _, aux = apply_model(params, cfg, batch, mode="train")
    loss = losses.task_loss(cfg, logits, batch)
    mtp_loss = torch.zeros((), device=loss.device)
    if isinstance(aux, tuple):                 # MTP head active
        aux, mtp_logits = aux
        # position t's MTP target is token t+2 = labels[t+1]
        mtp_loss = cross_entropy(mtp_logits[:, :-1], batch["labels"][:, 1:])
    total = loss + aux + cfg.mtp_loss_weight * mtp_loss
    return total, {"loss": loss, "aux_loss": aux, "mtp_loss": mtp_loss}


def param_grads(total: torch.Tensor, flat: list[torch.Tensor]) -> tuple:
    """d total / d each leaf of ``flat``.  A leaf the loss does not reach
    (the token embedding of an audio encoder, which reads frames) gets
    zeros, as ``jax.grad`` gives it, where autograd would raise."""
    return torch.autograd.grad(total, flat, allow_unused=True, materialize_grads=True)


def make_train_step(
    cfg: ModelConfig,
    opt: AdamWConfig,
    *,
    sync: str = "xla",                     # "xla" | "r2ccl"
    comm: CommConfig | None = None,
    axes: tuple[DataAxis, ...] = (),
    total_steps: int = 10_000,
    warmup_steps: int = 100,
) -> Callable:
    """Builds ``train_step(state, batch, stats=None) -> (state, metrics)``.

    ``axes`` are the data axes, outer first (``launch.mesh.make_data_axes``:
    pod, then data), the counterpart of the JAX package's ``data_axes``.
    Together they take the data ranks of this rank's model index: one axis
    (its group), or a pod and a data axis over the whole default process
    group (pods come with one model index).  ``batch`` holds this rank's
    rows of the global batch as tensors on the params' device.

    ``comm.mode`` selects the gradient AllReduce schedule of the innermost
    axis in r2ccl sync: "ring", "tree", "r2ccl" (failure-aware decomposition
    for ``comm.degraded_rank``, a rank of that axis: every pod runs the same
    program), "recursive" (multi-failure bandwidth spectrum) or "xla"
    (``dist.all_reduce`` — for parity tests); each outer axis then runs a
    ring (``dist.all_reduce`` under "xla").  The step updates the
    state's tensors in place (``optim.adamw``).  ``stats``, when given,
    accumulates host seconds (synchronized on the card) under ``fwd_bwd_s``,
    ``sync_s`` (of which ``wire_s``, itself holding ``stage_s`` and
    ``wait_s``, and ``merge_s``) and ``opt_s``, and the bytes the rank sends in the
    programs' rounds under ``sent_bytes``.  While tracing is on the three
    phases are the spans ``train.fwd_bwd``, ``train.sync`` and
    ``train.opt`` (``tracing``).
    """
    comm = comm or CommConfig()
    if sync not in ("xla", "r2ccl"):
        raise ValueError(f"unknown sync mode {sync!r}")
    axes = tuple(axes)
    if sync == "r2ccl" and not axes:
        raise ValueError("r2ccl sync needs the data axis (a DataAxis)")
    # the xla sync and the metrics reduce over every data rank of this
    # model index at once: one axis's group, or the pods' whole world
    span = axes[0] if len(axes) == 1 else DataAxis(staging=axes[-1].staging) if axes else None
    if span is not None and math.prod(a.size for a in axes) != span.size:
        raise ValueError(f"data axes of {[a.size for a in axes]} ranks do not take "
                         f"the {span.size} data ranks of one model index")
    wire_t = WIRE_DTYPES[comm.comm_dtype]

    def grads_and_metrics(params, batch):
        total, metrics = compute_loss(params, cfg, batch)
        flat = leaves(params)
        grads = unflatten(params, param_grads(total, flat))
        return grads, {k: v.detach() for k, v in metrics.items()}

    def mean_metrics(metrics):
        keys = sorted(metrics)
        vec = torch.stack([metrics[k].float() for k in keys])
        vec = span.all_reduce_sum(vec) / span.size
        return dict(zip(keys, vec.unbind(0)))

    def train_step(state: TrainState, batch, stats: dict | None = None):
        device = leaves(state.params)[0].device
        with timed(stats, "fwd_bwd_s", device, span="train.fwd_bwd"):
            grads, metrics = grads_and_metrics(state.params, batch)
        with timed(stats, "sync_s", device, span="train.sync"):
            if sync == "xla":
                if span is not None:
                    grads = tree_map(lambda g: all_reduce_mean(g, span, stats=stats),
                                     grads)
                    metrics = mean_metrics(metrics)
            else:
                orig = tree_map(lambda g: g.dtype, grads)
                wire = tree_map(lambda g: g.to(wire_t), grads)
                del grads
                # the configured (failure-aware) schedule inside the pod,
                # then a ring across the pods; each mean in the wire dtype
                wire = sync_over_axes(wire, axes, mean=True, stats=stats, **comm.kwargs())
                grads = tree_map(lambda g, t: g.to(t), wire, orig)
                del wire
                metrics = mean_metrics(metrics)
        lr_scale = cosine_with_warmup(state.step, warmup_steps=warmup_steps,
                                      total_steps=total_steps)
        with timed(stats, "opt_s", device, span="train.opt"):
            params, opt_state, gnorm = adamw_update(
                opt, state.params, grads, state.opt_state, lr_scale=lr_scale)
        metrics = dict(metrics, grad_norm=gnorm,
                       lr=torch.tensor(float(opt.lr * lr_scale)))
        return TrainState(params, opt_state, state.step + 1), metrics

    return train_step
