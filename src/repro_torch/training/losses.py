"""Per-modality training objectives (the JAX package's
``training/losses.py``)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import cross_entropy


def task_loss(cfg: ModelConfig, logits: torch.Tensor, batch) -> torch.Tensor:
    """Next-token cross-entropy for text, prefix-offset cross-entropy for a
    vision-language model, masked-unit prediction for an audio encoder."""
    if cfg.modality.kind == "vision_text":
        p = cfg.modality.num_prefix_tokens
        t = batch["labels"].shape[1]
        # position P+i predicts text token i+1 (= labels[i])
        return cross_entropy(logits[:, p:p + t], batch["labels"])
    if cfg.modality.kind == "audio_frames":
        return cross_entropy(logits, batch["labels"], mask=batch.get("loss_mask"))
    return cross_entropy(logits, batch["labels"])
