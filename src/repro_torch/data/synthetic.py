"""Deterministic synthetic data pipeline.

Produces reproducible token/frame/patch batches for every modality with a
learnable signal (Zipfian n-gram language) so smoke training can show a
decreasing loss.  Batches are generated host-side with numpy, split over
the ranks by the launcher.  The port's copy of the JAX package's
``data/synthetic.py``: the same seed gives the same batches.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class SyntheticConfig:
    seq_len: int
    batch_size: int
    vocab_size: int
    seed: int = 0
    ngram: int = 2                 # learnable bigram structure


class SyntheticTokens:
    """Zipf-distributed bigram language: next ~ P(. | prev) with a fixed
    random transition table — learnable by any LM."""

    def __init__(self, cfg: SyntheticConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        k = min(v, 32)
        # each token has k likely successors
        self.successors = rng.integers(0, v, size=(v, k))
        self.rng = np.random.default_rng(cfg.seed + 1)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, T, v = cfg.batch_size, cfg.seq_len, cfg.vocab_size
        toks = np.empty((B, T + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, size=B)
        k = self.successors.shape[1]
        choice = rng.integers(0, k, size=(B, T))
        mix = rng.random((B, T)) < 0.9            # 10% noise
        noise = rng.integers(0, v, size=(B, T))
        for t in range(T):
            nxt = self.successors[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(mix[:, t], nxt, noise[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_batch(cfg: ModelConfig, seq_len: int, batch_size: int, step: int = 0,
               seed: int = 0) -> dict[str, np.ndarray]:
    """One global batch for any modality (numpy, deterministic)."""
    rng = np.random.default_rng((seed, step))
    if cfg.modality.kind == "audio_frames":
        frames = rng.standard_normal(
            (batch_size, seq_len, cfg.modality.frontend_dim)).astype(np.float32)
        labels = rng.integers(0, cfg.vocab_size, size=(batch_size, seq_len)).astype(np.int32)
        # HuBERT-style: predict cluster units at masked positions (~8%)
        mask = (rng.random((batch_size, seq_len)) < 0.08).astype(np.float32)
        return {"frames": frames, "labels": labels, "loss_mask": mask}
    if cfg.modality.kind == "vision_text":
        P = cfg.modality.num_prefix_tokens
        text_len = max(seq_len - P, 1)
        gen = SyntheticTokens(SyntheticConfig(text_len, batch_size, cfg.vocab_size, seed))
        b = gen.batch(step)
        patches = rng.standard_normal(
            (batch_size, P, cfg.modality.frontend_dim)).astype(np.float32)
        return {"patches": patches, "tokens": b["tokens"], "labels": b["labels"]}
    gen = SyntheticTokens(SyntheticConfig(seq_len, batch_size, cfg.vocab_size, seed))
    return gen.batch(step)
