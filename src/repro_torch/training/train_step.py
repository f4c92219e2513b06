"""Training step with pluggable gradient synchronization.

The port of the JAX package's ``training/train_step.py``, for one data axis
(the ranks of a :class:`~repro_torch.core.collectives.DataAxis`, each with
its own share of the global batch):

  * ``sync="xla"``   — autograd, then an all-reduce mean of the float32
    gradients (``dist.all_reduce``; the baseline).  Without an axis the
    step trains on one process.
  * ``sync="r2ccl"`` — autograd, then the gradients, cast to the wire dtype
    (``CommConfig.comm_dtype``), are synchronized by an explicit R2CCL
    collective program (ring / tree / r2ccl-allreduce / recursive, per the
    ``CommConfig``), whose every round merges in the ``chunk_combine``
    kernel; the metrics are averaged over the ranks.  Failure-aware
    schedules switch here without touching the model code.

The JAX package's hierarchical pod ring and the model axes of its mesh
(tensor parallelism) are not ported (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import CommConfig, ModelConfig
from repro_torch.core.collectives import DataAxis, all_reduce_mean, sync_gradients
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


def compute_loss(params, cfg: ModelConfig, batch, *,
                 kernel_impl: str = "auto") -> tuple[torch.Tensor, dict]:
    """(total loss, metrics) of the model in train mode on ``batch``; with
    ``cfg.mtp`` the MTP head's cross-entropy, weighted by
    ``cfg.mtp_loss_weight``, joins the total."""
    logits, _, aux = apply_model(params, cfg, batch, mode="train",
                                 kernel_impl=kernel_impl)
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
    axis: DataAxis | None = None,
    total_steps: int = 10_000,
    warmup_steps: int = 100,
) -> Callable:
    """Builds ``train_step(state, batch, stats=None) -> (state, metrics)``.

    ``batch`` holds this rank's rows of the global batch as tensors on the
    params' device.  ``comm.mode`` selects the gradient AllReduce schedule in
    r2ccl sync: "ring", "tree", "r2ccl" (failure-aware decomposition for
    ``comm.degraded_rank``), "recursive" (multi-failure bandwidth spectrum)
    or "xla" (``dist.all_reduce`` — for parity tests).  The step updates the
    state's tensors in place (``optim.adamw``).  ``stats``, when given,
    accumulates host seconds (synchronized on the card) under ``fwd_bwd_s``,
    ``sync_s`` (of which ``wire_s``, itself holding ``stage_s``, and
    ``merge_s``) and ``opt_s``.
    """
    comm = comm or CommConfig()
    if sync not in ("xla", "r2ccl"):
        raise ValueError(f"unknown sync mode {sync!r}")
    if sync == "r2ccl" and axis is None:
        raise ValueError("r2ccl sync needs the data axis (a DataAxis)")
    wire_t = WIRE_DTYPES[comm.comm_dtype]

    def grads_and_metrics(params, batch):
        total, metrics = compute_loss(params, cfg, batch)
        flat = leaves(params)
        grads = unflatten(params, param_grads(total, flat))
        return grads, {k: v.detach() for k, v in metrics.items()}

    def mean_metrics(metrics):
        keys = sorted(metrics)
        vec = torch.stack([metrics[k].float() for k in keys])
        vec = axis.all_reduce_sum(vec) / axis.size
        return dict(zip(keys, vec.unbind(0)))

    def train_step(state: TrainState, batch, stats: dict | None = None):
        device = leaves(state.params)[0].device
        with timed(stats, "fwd_bwd_s", device):
            grads, metrics = grads_and_metrics(state.params, batch)
        with timed(stats, "sync_s", device):
            if sync == "xla":
                if axis is not None:
                    grads = tree_map(lambda g: all_reduce_mean(g, axis, stats=stats),
                                     grads)
                    metrics = mean_metrics(metrics)
            else:
                orig = tree_map(lambda g: g.dtype, grads)
                wire = tree_map(lambda g: g.to(wire_t), grads)
                del grads
                wire = sync_gradients(wire, axis, mean=True, stats=stats,
                                      **comm.kwargs())
                grads = tree_map(lambda g, t: g.to(t), wire, orig)
                del wire
                metrics = mean_metrics(metrics)
        lr_scale = cosine_with_warmup(state.step, warmup_steps=warmup_steps,
                                      total_steps=total_steps)
        with timed(stats, "opt_s", device):
            params, opt_state, gnorm = adamw_update(
                opt, state.params, grads, state.opt_state, lr_scale=lr_scale)
        metrics = dict(metrics, grad_norm=gnorm,
                       lr=torch.tensor(float(opt.lr * lr_scale)))
        return TrainState(params, opt_state, state.step + 1), metrics

    return train_step
