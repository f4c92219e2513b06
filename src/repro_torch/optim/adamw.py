"""AdamW as plain tensor code (decoupled weight decay, bias-corrected
moments), in the JAX package's order of operations (``optim/adamw.py``):
global-norm clip, count from 1, decay on every leaf, ``p - lr*(step + wd*p)``.

Unlike the JAX package's functional update, :func:`adamw_update` writes the
new parameters and moments into the given tensors, leaf by leaf, so that a
full-width step needs one leaf of scratch memory instead of a second copy of
the parameters and both moments.  The arithmetic is the same.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float | None = 1.0


def init_opt_state(params) -> dict[str, Any]:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": 0}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of the sum of squares, in float32."""
    return torch.sqrt(sum(l.float().square().sum() for l in leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state, lr_scale=1.0):
    """One AdamW step.  Returns (params, state, grad_norm): the same
    tensors, updated in place, with ``state["count"]`` advanced."""
    if cfg.grad_clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip_norm)
    else:
        gnorm = global_norm(grads)
    count = state["count"] + 1
    f = np.float32
    b1c = float(f(1.0) - f(cfg.b1) ** f(count))
    b2c = float(f(1.0) - f(cfg.b2) ** f(count))
    lr = float(f(cfg.lr) * f(lr_scale))

    def upd(p, g, m, v):
        g = g.float()
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g.square())
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        pf = p.float()
        p.copy_((pf - lr * (step + cfg.weight_decay * pf)).to(p.dtype))

    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["mu"]),
                          leaves(state["nu"])):
        upd(p, g, m, v)
    state["count"] = count
    return params, state, gnorm
