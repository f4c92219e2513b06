"""Weights from the JAX package's param pytree, given as numpy arrays.

The port keeps the JAX layout (nested dicts, ``blocks`` stacked on a leading
``n_groups`` axis, ``wq`` as ``(d, H, D)``, ``wo`` as ``(H, D, d)``), so the
conversion moves arrays and transposes nothing.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device


def _tensor(x, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":          # ml_dtypes bfloat16 from JAX
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def params_from_jax(tree: Any, device: str | torch.device = "cuda") -> Any:
    """Same nested dict / tuple / list structure, arrays as tensors on
    ``device``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(conv(v) for v in node)
        return _tensor(node, dev)

    return conv(tree)
