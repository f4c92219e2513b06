"""Checkpoints in the JAX package's format: flat-path npz + json metadata.

The keys are the JAX package's (``training/checkpoint.py``): each leaf of the
train state named by its path, dict keys as themselves, sequence positions as
``#i``, fields of the state by name (``params/blocks/#0/attn/wq``,
``opt_state/count``, ``step``), so the JAX package's ``restore_checkpoint``
reads a file the port writes, and :func:`restore_checkpoint` reads either's.
Integers (the step and the optimizer count) are stored as int32 scalars and
bfloat16 tensors as float32, which the restore casts back to its template's
dtype.
"""

from __future__ import annotations

import dataclasses
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


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = [int(f[len("step_"):-len(".json")])
             for f in os.listdir(path) if f.endswith(".json") and f.startswith("step_")]
    return max(steps) if steps else None


def _restore(template, data, prefix: tuple[str, ...]):
    """``template``'s structure with each leaf read from ``data`` by its
    path: a tensor in the template's dtype and on its device, an int as an
    int."""
    if isinstance(template, dict):
        return {k: _restore(template[k], data, prefix + (str(k),)) for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_restore(v, data, prefix + (f"#{i}",))
                              for i, v in enumerate(template))
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _restore(getattr(template, f.name), data, prefix + (f.name,))
            for f in dataclasses.fields(template)})
    key = SEP.join(prefix)
    arr = data[key]
    if isinstance(template, torch.Tensor):
        if arr.shape != tuple(template.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape}, template "
                             f"{tuple(template.shape)}")
        return torch.as_tensor(arr).to(dtype=template.dtype, device=template.device)
    return int(arr)


def restore_checkpoint(path: str, state_template, step: int | None = None):
    """Restore into the structure of ``state_template`` (shapes must match);
    returns (state, step), as the JAX package's ``restore_checkpoint``.
    Restored tensors are new tensors: a train state's params are made
    autograd leaves again by ``init_train_state``'s caller as needed."""
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {path}")
    with np.load(os.path.join(path, f"step_{step}.npz")) as data:
        return _restore(state_template, data, ()), step
