"""Model assembly for the dense llama family: embedding -> block stack ->
final norm -> unembed.

The port of the JAX package's ``models/transformer.py`` for attention-only
block patterns.  Parameters keep its pytree layout: ``blocks`` is a tuple
over the pattern of dicts whose tensors carry a leading ``n_groups`` axis
(the axis ``lax.scan`` runs over there; a Python loop runs over it here),
``tail`` holds the remainder layers.  Modes ``train`` (full sequence,
logits everywhere, no caches), ``prefill`` (build caches, logits at the last
position) and ``decode`` (one token + caches).  With ``cfg.remat``, train
mode recomputes each layer in the backward pass (``torch.utils.checkpoint``,
the counterpart of ``jax.checkpoint``).  MoE, MLA, the recurrent blocks and
the modality frontends raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from . import layers as L


def _check_supported(cfg: ModelConfig) -> None:
    missing = []
    if cfg.moe is not None and cfg.moe.num_experts > 0:
        missing.append("MoE feed-forward")
    if cfg.attention is None or cfg.attention.kind != "gqa":
        missing.append(f"attention kind "
                       f"{cfg.attention.kind if cfg.attention else None!r}")
    if cfg.block_pattern != ("attn",):
        missing.append(f"block pattern {cfg.block_pattern}")
    if cfg.modality.kind != "text":
        missing.append(f"{cfg.modality.kind} frontend")
    if cfg.mtp:
        missing.append("MTP head")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense GQA text models; not yet "
            f"ported: {', '.join(missing)} (ROADMAP.md, queue 1)")


# ---------------------------------------------------------------------------
# per-layer init / apply
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: ModelConfig, lead=()) -> dict:
    norm_init, _ = L.make_norm(cfg.norm)
    a = cfg.attention
    return {
        "norm1": norm_init(cfg.d_model, lead, gen.device),
        "attn": L.init_gqa(gen, cfg.d_model, a.num_heads, a.num_kv_heads,
                           a.head_dim, lead),
        "norm2": norm_init(cfg.d_model, lead, gen.device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation, lead),
    }


def _apply_layer(params, cfg: ModelConfig, x, *, cache, mode, attn_impl="auto"):
    """Returns (x_out, new_cache)."""
    _, norm_fn = L.make_norm(cfg.norm)
    h = norm_fn(params["norm1"], x)
    a = cfg.attention
    y, new_cache = L.gqa_attention(
        params["attn"], h, num_heads=a.num_heads,
        num_kv_heads=a.num_kv_heads, head_dim=a.head_dim,
        rope_theta=a.rope_theta, use_rope=a.use_rope, causal=a.causal,
        window=a.sliding_window, logit_cap=a.logit_softcap, cache=cache,
        mode=mode, attn_impl=attn_impl)
    x = x + y.to(x.dtype)
    h2 = norm_fn(params["norm2"], x)
    y2 = L.mlp(params["mlp"], h2, cfg.activation)
    return x + y2.to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def _pattern_split(cfg: ModelConfig) -> tuple[int, list[str], list[str]]:
    """(num_groups, pattern, remainder_kinds)."""
    p = list(cfg.block_pattern)
    if not cfg.scan_layers:
        return 0, p, cfg.pattern_layers
    n_groups = cfg.num_layers // len(p)
    remainder = cfg.pattern_layers[n_groups * len(p):]
    return n_groups, p, remainder


def init_model(cfg: ModelConfig, *, seed: int = 0,
               device: str | torch.device = "cuda") -> dict:
    """Random float32 weights with the JAX package's distributions, drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device``.  Returns
    the params dict (the JAX package also returns logical sharding axes,
    which the port does not use yet)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params: dict[str, Any] = {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                  cfg.tie_embeddings)}
    n_groups, pattern, remainder = _pattern_split(cfg)
    if n_groups > 0:
        params["blocks"] = tuple(_init_layer(gen, cfg, (n_groups,))
                                 for _ in pattern)
    if remainder:
        params["tail"] = [_init_layer(gen, cfg) for _ in remainder]
    norm_init, _ = L.make_norm(cfg.norm)
    params["final_norm"] = norm_init(cfg.d_model, (), dev)
    return params


def init_caches(cfg: ModelConfig, batch: int, context_len: int,
                dtype=torch.bfloat16, device: str | torch.device = "cuda") -> dict:
    """Cache dict matching the model structure; ``blocks`` caches carry the
    leading ``n_groups`` axis like the params."""
    _check_supported(cfg)
    dev = resolve_device(device)
    a = cfg.attention
    n_groups, pattern, remainder = _pattern_split(cfg)

    def one(lead=()):
        return L.init_kv_cache(batch, context_len, a.num_kv_heads, a.head_dim,
                               dtype, dev, lead)

    caches: dict[str, Any] = {}
    if n_groups > 0:
        caches["blocks"] = tuple(one((n_groups,)) for _ in pattern)
    if remainder:
        caches["tail"] = [one() for _ in remainder]
    return caches


def _unstack(stacked: dict, n_groups: int) -> list[dict]:
    """Per-group views of a layer's stacked params.  ``unbind`` makes one
    backward node per tensor (the gradients of all groups are stacked once),
    where indexing each group would scatter into a full-size zero tensor per
    group."""
    per = {k: {n: t.unbind(0) for n, t in sub.items()} for k, sub in stacked.items()}
    return [{k: {n: ts[g] for n, ts in sub.items()} for k, sub in per.items()}
            for g in range(n_groups)]


def apply_model(
    params,
    cfg: ModelConfig,
    batch: dict[str, torch.Tensor],
    *,
    mode: str = "prefill",          # train | prefill | decode
    caches: dict | None = None,
    attn_impl: str = "auto",
) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
    """Forward pass over ``batch["tokens"]`` (B, T).

    Returns (logits, new_caches, aux_loss) like the JAX package; the dense
    path has no auxiliary loss, so aux is a zero.  ``train`` takes no caches
    and returns None for them; prefill and decode update ``caches`` (from
    :func:`init_caches`) in place and return them.  ``attn_impl="reference"``
    runs train and prefill attention through the plain version on any
    device.
    """
    _check_supported(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got {mode!r}")
    train = mode == "train"
    if not train and caches is None:
        raise ValueError(f"mode={mode!r} needs caches (init_caches)")
    x = L.embed(params["embed"], batch["tokens"],
                scale_by_dim=cfg.embedding_scale)
    x = x.to(torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)

    n_groups, pattern, remainder = _pattern_split(cfg)
    kw = dict(mode=mode, attn_impl=attn_impl)

    def layer(p, x, cache):
        if train and cfg.remat:
            return checkpoint(_apply_layer, p, cfg, x, cache=None, use_reentrant=False,
                              **kw)
        return _apply_layer(p, cfg, x, cache=cache, **kw)

    new_caches: dict[str, Any] = {}
    if n_groups > 0:
        groups = [_unstack(params["blocks"][i], n_groups) for i in range(len(pattern))]
        for g in range(n_groups):
            for i in range(len(pattern)):
                cache = None
                if not train:
                    c = caches["blocks"][i]
                    cache = L.KVCache(c.k[g], c.v[g], c.positions[g], c.index)
                x, c2 = layer(groups[i][g], x, cache)
        if not train:
            index = c2.index
            new_caches["blocks"] = tuple(
                L.KVCache(c.k, c.v, c.positions, index) for c in caches["blocks"])
    if remainder:
        tail = []
        for i in range(len(remainder)):
            x, c2 = layer(params["tail"][i], x,
                          None if train else caches["tail"][i])
            tail.append(c2)
        if not train:
            new_caches["tail"] = tail

    _, norm_fn = L.make_norm(cfg.norm)
    xn = norm_fn(params["final_norm"], x)
    if mode == "prefill":
        xn = xn[:, -1:]                   # only the last position's logits
    cap = 30.0 if cfg.attention and cfg.attention.logit_softcap else None
    logits = L.unembed(params["embed"], xn, logit_cap=cap)
    aux = torch.zeros((), device=logits.device)
    return logits, (None if train else new_caches), aux
