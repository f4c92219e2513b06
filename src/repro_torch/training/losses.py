"""Training objective of the port's text models (the JAX package's
``training/losses.py``; the vision and audio objectives come with their
frontends)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import cross_entropy


def task_loss(cfg: ModelConfig, logits: torch.Tensor, batch) -> torch.Tensor:
    """Next-token cross-entropy over ``batch["labels"]``."""
    if cfg.modality.kind != "text":
        raise NotImplementedError(
            f"{cfg.modality.kind} objective: the port trains text models")
    return cross_entropy(logits, batch["labels"])
