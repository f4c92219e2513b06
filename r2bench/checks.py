"""The numbers that decide ``correct``: each a gap between what the timed path
produced and the plain reference, compared with a limit of its own
(``workloads/<cell>.json``'s ``limits``).

Leaves are compared by norm, the worst leaf counting: the gap between the
program's norm of a leaf and the reference's, over the larger of the
reference's norm of that leaf and of the median leaf (some leaves' norms are
all but zero).
"""

from __future__ import annotations

import statistics

import torch


def loss_gap(program: list[float], reference: list[float]) -> float:
    """The largest relative gap between the program's loss of a step and the
    reference's."""
    if len(program) != len(reference):
        raise ValueError(f"{len(program)} losses against {len(reference)}")
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def leaf_gap(program: dict[str, float], reference: dict[str, float], keep=None) -> float:
    """The worst leaf's gap of norms (``keep``: the leaves counted)."""
    names = [n for n in reference if keep is None or n in keep]
    if set(program) != set(reference):
        raise ValueError(f"leaves differ: {sorted(set(program) ^ set(reference))}")
    floor = statistics.median(reference[n] for n in names)
    return max(abs(program[n] - reference[n]) / max(reference[n], floor) for n in names)


def moved_leaves(grad_norms: dict[str, float], share: float = 1e-3) -> set[str]:
    """The leaves whose reference gradient is not nought to rounding: at
    least ``share`` of the median leaf's norm.  Adam moves the others by
    round-off alone."""
    floor = statistics.median(grad_norms.values())
    return {n for n, g in grad_norms.items() if g >= share * floor}


def sample_gap(program: dict[str, torch.Tensor], reference: dict[str, torch.Tensor]) -> float:
    """The worst leaf's root-mean-square difference over the same sampled
    elements, over the larger of the leaf's and the median leaf's
    root-mean-square in the reference."""
    ref = {n: torch.as_tensor(t).double() for n, t in reference.items()}
    rms = {n: float(t.square().mean().sqrt()) for n, t in ref.items()}
    floor = statistics.median(rms.values())
    return max(float((torch.as_tensor(program[n]).double() - ref[n]).square().mean().sqrt())
               / max(rms[n], floor) for n in reference)


def token_gaps(ref_logits: torch.Tensor, tokens) -> torch.Tensor:
    """How far below the reference's best logit each token's logit lies, at
    each position: ``ref_logits`` (n, V), ``tokens`` (n,)."""
    t = torch.as_tensor(tokens, device=ref_logits.device, dtype=torch.long)
    return ref_logits.max(-1).values - ref_logits.gather(-1, t[:, None])[:, 0]
