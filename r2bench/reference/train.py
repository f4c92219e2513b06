"""The reference of a data-parallel training step: each rank's loss and
gradients (``llama.loss``), their mean over the ranks through the gradient
wire's precision, and AdamW with a cosine schedule after a linear warm-up.

AdamW, as the configuration states it: the gradient clipped to a global norm
(``grad_clip_norm``), ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
bias corrections ``1 - b^t`` with t counted from 1, and ``p - lr (m_hat /
(sqrt(v_hat) + eps) + weight_decay p)``.  The learning rate is ``lr`` times
``min(step / warmup, 1) * (0.1 + 0.9 * (1 + cos(pi * progress)) / 2)``,
``progress`` the share of ``total - warmup`` steps past the warm-up (step 0
takes no step).
"""

from __future__ import annotations

import math

import torch

from . import llama


def lr_scale(step: int, warmup: int, total: int, min_ratio: float = 0.1) -> float:
    warm = min(step / max(warmup, 1), 1.0)
    progress = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return warm * (min_ratio + (1.0 - min_ratio) * 0.5 * (1.0 + math.cos(math.pi * progress)))


def through_wire(g: torch.Tensor, wire: str) -> torch.Tensor:
    """A gradient as the wire carries it: rounded to bfloat16, or (the
    control's lower precision) to float8 e4m3 under a per-tensor scale."""
    if wire == "bfloat16":
        return g.to(torch.bfloat16).float()
    if wire == "float8_e4m3fn":
        scale = g.abs().max().clamp(min=1e-30) / 448.0
        return (g / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown wire precision {wire!r}")


def steps(params: dict, c: dict, opt: dict, batches, *, wire: str = "bfloat16",
          precision: llama.Precision = llama.Precision(), on_step=None,
          moments=None, first: int = 0) -> list[float]:
    """Train ``params`` (leaves by path, float32, updated in place) for
    ``len(batches)`` steps.  ``batches[i][r]`` is rank r's (tokens, labels)
    at the i-th step.  A rank's gradient is that of its mean loss; the step's
    is the mean of the ranks' gradients through the wire, rounded to the
    wire's precision once.  Returns the losses, each the mean of the ranks'.
    ``on_step(i, grads)`` is given the i-th step's clipped gradient by path
    before the update.  ``moments`` (first, second; by path, updated in
    place) and ``first`` (the steps taken before) continue a run; by default
    it starts at zero."""
    names = list(params)
    if moments is None:
        moments = ({n: torch.zeros_like(params[n]) for n in names},
                   {n: torch.zeros_like(params[n]) for n in names})
    m, v = moments
    out = []
    for i, ranks in enumerate(batches):
        s = first + i
        total = {n: torch.zeros_like(params[n]) for n in names}
        losses = []
        for tokens, labels in ranks:
            leaves = {n: params[n].detach().requires_grad_(True) for n in names}
            tree = unflatten(leaves)
            loss = llama.loss(tree, c, tokens, labels, precision)
            grads = torch.autograd.grad(loss, [leaves[n] for n in names])
            for n, g in zip(names, grads):
                total[n] += through_wire(g, wire)
            losses.append(float(loss.detach()))
        g = {n: through_wire(total[n] / len(ranks), wire) for n in names}
        norm = math.sqrt(sum(float(t.double().square().sum()) for t in g.values()))
        clip = min(1.0, opt["grad_clip_norm"] / max(norm, 1e-9))
        g = {n: t * clip for n, t in g.items()}
        if on_step is not None:
            on_step(i, g)
        lr = opt["lr"] * lr_scale(s, opt["warmup_steps"], opt["total_steps"])
        with torch.no_grad():
            for n in names:
                adamw(params[n], g[n], m[n], v[n], s + 1, lr, opt)
        out.append(sum(losses) / len(losses))
    return out


def adamw(p, g, m, v, t: int, lr: float, opt: dict) -> None:
    """AdamW's update of one leaf at step count ``t`` (from 1), in place."""
    b1, b2 = opt["b1"], opt["b2"]
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).add_(g.square(), alpha=1 - b2)
    step = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + opt["eps"])
    p.sub_(lr * (step + opt["weight_decay"] * p))


def unflatten(flat: dict[str, torch.Tensor]) -> dict:
    """The nested layout of ``weights.flatten``'s paths (a number is a tuple
    index)."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        parts = path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t

    def fix(n):
        if isinstance(n, dict) and n and all(k.isdigit() for k in n):
            return tuple(fix(n[str(i)]) for i in range(len(n)))
        return {k: fix(v) for k, v in n.items()} if isinstance(n, dict) else n
    return fix(tree)
