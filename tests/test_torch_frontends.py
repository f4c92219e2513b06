"""The port's two modality frontends held against the JAX package on their
smoke configs, from the same (JAX-initialised) weights and numpy inputs:
paligemma-smoke (``vision_text``: projected image patches as a
bidirectional prefix before the scaled text embeddings) and hubert-smoke
(``audio_frames``: projected frames through a non-causal encoder).

Tolerances: logits atol 3e-2, as ``_torch_model_parity.py`` (a bf16
residual stream in both frameworks; the JAX side runs op by op); greedy
tokens equal wherever the reference's top-2 margin exceeds twice that;
``task_loss`` on the same float32 logits atol 1e-5 (one float32 reduction
in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_model_parity import ATOL, _np, assert_tokens_match, converted_params
from repro.configs.base import ModalityConfig as JModality
from repro.models import apply_model as jax_apply
from repro.models import get_smoke_config as jax_smoke
from repro.models import init_caches as jax_init_caches
from repro.training.losses import task_loss as jax_task_loss
from repro_torch.configs.base import ModalityConfig
from repro_torch.data import make_batch
from repro_torch.models import apply_model, get_smoke_config, init_caches
from repro_torch.training.losses import task_loss

FRONTENDS = ["paligemma-3b", "hubert-xlarge"]


def _batch(arch, seq_len=16, batch=2, step=0):
    """The same numpy batch for both sides (the port's ``make_batch``, which
    equals the JAX package's: ``test_torch_training.py``)."""
    return make_batch(get_smoke_config(arch), seq_len=seq_len, batch_size=batch, step=step)


@pytest.mark.parametrize("arch", FRONTENDS)
def test_train_logits_match_jax(arch):
    """Train mode over the whole input: paligemma's logits at the 8 image
    positions and the 8 text positions, hubert's at every frame."""
    cfg, jp, tp = converted_params(arch)
    b = _batch(arch)
    with jax.disable_jit():
        jl, _, _ = jax_apply(jp, cfg, {k: jnp.asarray(v) for k, v in b.items()},
                             mode="train")
    tl, caches, _ = apply_model(tp, get_smoke_config(arch),
                                {k: torch.from_numpy(v) for k, v in b.items()}, mode="train")
    assert caches is None
    assert tl.shape == jl.shape == (2, 16, cfg.vocab_size)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)


def test_paligemma_prefill_with_patches_then_decode_matches_jax():
    """Prefill over 8 patch embeddings and 8 text tokens (the image prefix
    attended both ways), then 3 greedy decode steps fed the reference's
    tokens, which embed tokens only: last-position logits, greedy tokens and
    the KV cache's fill level against JAX ``apply_model``."""
    arch = "paligemma-3b"
    cfg, jp, tp = converted_params(arch)
    tcfg = get_smoke_config(arch)
    b = _batch(arch)
    B, ctx = 2, 24
    jc = jax_init_caches(cfg, B, ctx, dtype=jnp.float32)
    tc = init_caches(tcfg, B, ctx, dtype=torch.float32, device="cpu")
    feed = {k: b[k] for k in ("patches", "tokens")}
    with jax.disable_jit():
        jl, jc, _ = jax_apply(jp, cfg, {k: jnp.asarray(v) for k, v in feed.items()},
                              mode="prefill", caches=jc)
    tl, tc, _ = apply_model(tp, tcfg, {k: torch.from_numpy(v) for k, v in feed.items()},
                            mode="prefill", caches=tc)
    assert tl.shape == jl.shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
    assert_tokens_match(tl[:, -1], jl[:, -1])
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
        with jax.disable_jit():
            jl, jc, _ = jax_apply(jp, cfg, {"tokens": jnp.asarray(nxt)[:, None]},
                                  mode="decode", caches=jc)
        tl, tc, _ = apply_model(tp, tcfg, {"tokens": torch.tensor(nxt)[:, None]},
                                mode="decode", caches=tc)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
        assert_tokens_match(tl[:, -1], jl[:, -1])
    np.testing.assert_allclose(_np(tc["blocks"][0].k), _np(jc["blocks"][0].k),
                               atol=ATOL, rtol=ATOL)
    assert tc["blocks"][0].index == int(jc["blocks"][0].index[0]) == 16 + 3


def test_paligemma_prefix_is_bidirectional():
    """An image patch's hidden state sees the patches after it: changing the
    last patch moves the logits at the first image position (a causal mask
    would leave them alone), and no text position is seen by an image
    position."""
    arch = "paligemma-3b"
    _, _, tp = converted_params(arch)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    b = {k: torch.from_numpy(v) for k, v in _batch(arch).items()}
    base, _, _ = apply_model(tp, tcfg, b, mode="train")
    moved = dict(b, patches=b["patches"].clone())
    moved["patches"][:, -1] += 1.0
    other, _, _ = apply_model(tp, tcfg, moved, mode="train")
    assert (other[:, 0] - base[:, 0]).abs().max() > 1e-3
    text = dict(b, tokens=(b["tokens"] + 1) % tcfg.vocab_size)
    other, _, _ = apply_model(tp, tcfg, text, mode="train")
    P = tcfg.modality.num_prefix_tokens
    torch.testing.assert_close(other[:, :P], base[:, :P], rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_vision_batch_without_patches_raises(mode):
    arch = "paligemma-3b"
    tcfg = get_smoke_config(arch)
    _, _, tp = converted_params(arch)
    caches = None if mode == "train" else init_caches(tcfg, 2, 24, device="cpu")
    with pytest.raises(ValueError, match="patches"):
        apply_model(tp, tcfg, {"tokens": torch.zeros(2, 8, dtype=torch.long)}, mode=mode,
                    caches=caches)


@pytest.mark.parametrize("kind", ["text", "vision_text", "audio_frames"])
def test_task_loss_matches_jax(kind):
    """The three objectives on the same float32 logits: next-token
    cross-entropy (text), cross-entropy over the text positions after the
    image prefix (vision_text, P = 8), cross-entropy masked by
    ``loss_mask`` (audio_frames)."""
    rng = np.random.default_rng(5)
    B, T, V, P = 3, 12, 40, 8
    jcfg = dataclasses.replace(jax_smoke("smollm-360m"), modality=JModality(
        kind=kind, frontend_dim=16, num_prefix_tokens=P if kind == "vision_text" else 0))
    tcfg = dataclasses.replace(get_smoke_config("smollm-360m"), modality=ModalityConfig(
        kind=kind, frontend_dim=16, num_prefix_tokens=P if kind == "vision_text" else 0))
    logits = rng.standard_normal((B, T + (P if kind == "vision_text" else 0), V)).astype(np.float32)
    batch = {"labels": rng.integers(0, V, (B, T)).astype(np.int32)}
    if kind == "audio_frames":
        batch["loss_mask"] = (rng.random((B, T)) < 0.3).astype(np.float32)
    want = float(jax_task_loss(jcfg, jnp.asarray(logits),
                               {k: jnp.asarray(v) for k, v in batch.items()}))
    got = task_loss(tcfg, torch.from_numpy(logits),
                    {k: torch.from_numpy(v) for k, v in batch.items()}).item()
    assert abs(got - want) <= 1e-5


@pytest.mark.parametrize("arch", FRONTENDS)
def test_compute_loss_on_the_smoke_batch_matches_jax(arch):
    """The whole objective on ``make_batch``'s batch for the modality (hubert's
    loss mask, ~8% of the frames, included), remat on; atol 1e-3, as
    ``_torch_grad_parity.py``."""
    from repro.training.train_step import compute_loss as jax_compute_loss
    from repro_torch.training import compute_loss

    cfg, jp, tp = converted_params(arch)
    b = _batch(arch, seq_len=16, batch=2, step=1)
    with jax.disable_jit():
        jl, jm = jax_compute_loss(jp, dataclasses.replace(cfg, remat=True),
                                  {k: jnp.asarray(v) for k, v in b.items()})
    tl, tm = compute_loss(tp, dataclasses.replace(get_smoke_config(arch), remat=True),
                          {k: torch.from_numpy(v) for k, v in b.items()})
    assert abs(tl.item() - float(jl)) <= 1e-3
    assert abs(tm["loss"].item() - float(jm["loss"])) <= 1e-3
