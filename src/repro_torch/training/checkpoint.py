"""Checkpoints in the JAX package's format: flat-path npz + json metadata.

The keys are the JAX package's (``training/checkpoint.py``): each leaf of the
train state named by its path, dict keys as themselves, sequence positions as
``#i``, fields of the state by name (``params/blocks/#0/attn/wq``,
``opt_state/count``, ``step``), so the JAX package's ``restore_checkpoint``
reads a file the port writes.  Integers (the step and the optimizer count)
are stored as int32 scalars and bfloat16 tensors as float32, which the
restore casts back to its template's dtype.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.tree import leaves_with_path

SEP = "/"


def _array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf, dtype=np.int32 if isinstance(leaf, int) else None)


def save_checkpoint(path: str, state, step: int, extra: dict | None = None) -> None:
    os.makedirs(path, exist_ok=True)
    flat = {SEP.join(p): _array(leaf) for p, leaf in leaves_with_path(state)}
    np.savez(os.path.join(path, f"step_{step}.npz"), **flat)
    meta = {"step": step, "keys": sorted(flat), **(extra or {})}
    with open(os.path.join(path, f"step_{step}.json"), "w") as f:
        json.dump(meta, f)
