"""Model assembly: embedding -> pattern block stack -> final norm -> unembed.

The port of the JAX package's ``models/transformer.py`` for text models
with GQA or MLA attention (``models/mla.py``), dense or MoE, and the
recurrent families: block patterns of
``attn``, ``local_attn`` (the config's sliding window), ``global_attn``
(full attention, or ``window_override``; Gemma-2 alternates it with
``local_attn``), ``rglru`` (RecurrentGemma) and ``rwkv`` (RWKV-6), with a
dense MLP or the MoE feed-forward (``models/moe.py``) after attention.
Parameters keep its pytree layout: ``blocks`` is a tuple over the pattern
of dicts whose tensors carry a leading ``n_groups`` axis (the axis
``lax.scan`` runs over there; a Python loop runs over it here), ``lead``
holds the ``moe.first_k_dense`` leading dense-FFN layers and ``tail`` the
remainder layers.  Caches are stacked the same way, one per layer kind: a
``KVCache`` for GQA attention (a ``local_attn`` cache holds
``min(window, context_len)`` slots, a ring buffer, as does any attention
cache under ``window_override``), an ``MLACache`` for MLA (the latents; MLA
takes no window), an ``RGLRUState`` or an ``RWKVState``.
Modes ``train`` (full sequence, logits everywhere, no caches), ``prefill``
(build caches, logits at the last position) and ``decode`` (one token +
caches).  With ``cfg.remat``, train mode recomputes each layer in the
backward pass (``torch.utils.checkpoint``, the counterpart of
``jax.checkpoint``).  With ``cfg.mtp`` (DeepSeek-V3) train mode also runs
the multi-token-prediction head and returns its logits beside the aux
loss.  The two modality frontends take precomputed embeddings through a
linear ``frontend_proj``, as in the JAX package: ``vision_text``
(PaliGemma) puts the projected image patches before the scaled token
embeddings and attends over them as a bidirectional prefix (prefix-LM) in
train and prefill mode, while decode embeds tokens only; ``audio_frames``
(HuBERT) projects frames, and its config's non-causal attention without
rope makes it an encoder: its users run train mode (its logits are the
encoder's output), and the serve CLI refuses ``encoder_only`` configs.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from . import layers as L
from . import mla as MLA
from . import moe as MOE
from . import rglru as RG
from . import rwkv6 as RW

ATTN_KINDS = ("attn", "local_attn", "global_attn")
KINDS = (*ATTN_KINDS, "rglru", "rwkv")


def _check_supported(cfg: ModelConfig) -> None:
    missing = []
    unknown = sorted(set(cfg.block_pattern) - set(KINDS))
    if unknown:
        missing.append(f"block kinds {unknown}")
    if any(k in ATTN_KINDS for k in cfg.block_pattern) and (
            cfg.attention is None or cfg.attention.kind not in ("gqa", "mla")):
        missing.append(f"attention kind "
                       f"{cfg.attention.kind if cfg.attention else None!r}")
    if cfg.modality.kind not in ("text", "vision_text", "audio_frames"):
        missing.append(f"{cfg.modality.kind} frontend")
    m = cfg.moe
    if m is not None and m.scoring != "softmax" and m.held_experts is None:
        missing.append(f"the {m.scoring} router outside the held-expert layer "
                       f"(set moe.held_experts)")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port runs GQA or MLA (dense or MoE) and recurrent "
            f"models with text, vision_text or audio_frames inputs; not ported: "
            f"{', '.join(missing)}")


# ---------------------------------------------------------------------------
# per-layer init / apply
# ---------------------------------------------------------------------------

def _lead_layers(cfg: ModelConfig) -> int:
    """Leading layers with a dense FFN (``moe.first_k_dense``), run unscanned."""
    return cfg.moe.first_k_dense if (cfg.moe and cfg.moe.first_k_dense) else 0


def _uses_moe(cfg: ModelConfig, layer_idx: int) -> bool:
    """Whether layer ``layer_idx`` takes the MoE FFN: from layer
    ``first_k_dense`` on in an MoE config."""
    m = cfg.moe
    return m is not None and m.num_experts > 0 and layer_idx >= _lead_layers(cfg)


def _init_ffn(gen: torch.Generator, cfg: ModelConfig, layer_idx: int, lead=()):
    """("moe", params) where ``_uses_moe``, else ("mlp", params)."""
    m = cfg.moe
    if _uses_moe(cfg, layer_idx):
        return "moe", MOE.init_moe(gen, cfg.d_model, m.expert_d_ff or cfg.d_ff,
                                   m.num_experts, m.num_shared_experts,
                                   cfg.activation, lead,
                                   held=m.held_experts and m.held_experts[1],
                                   router_bias=m.scoring == "sigmoid")
    return "mlp", L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation, lead)


def _init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str, layer_idx: int,
                lead=()) -> dict:
    norm_init, _ = L.make_norm(cfg.norm)
    params: dict[str, Any] = {"norm1": norm_init(cfg.d_model, lead, gen.device)}
    if kind in ATTN_KINDS:
        a = cfg.attention
        if a.kind == "mla":
            params["attn"] = MLA.init_mla(
                gen, cfg.d_model, a.num_heads, q_lora_rank=a.q_lora_rank,
                kv_lora_rank=a.kv_lora_rank, qk_nope_head_dim=a.qk_nope_head_dim,
                qk_rope_head_dim=a.qk_rope_head_dim, v_head_dim=a.v_head_dim,
                latent_norms=a.latent_norms, lead=lead)
        else:
            params["attn"] = L.init_gqa(gen, cfg.d_model, a.num_heads,
                                        a.num_kv_heads, a.head_dim, lead)
    elif kind == "rglru":
        params["rglru"] = RG.init_rglru_block(
            gen, cfg.d_model, cfg.rglru.lru_width or cfg.d_model,
            cfg.rglru.conv_width, lead)
    else:
        rw = cfg.rwkv
        params["rwkv"] = RW.init_rwkv_block(gen, cfg.d_model, rw.head_size,
                                            rw.decay_lora, rw.tokenshift_lora, lead)
        return params                  # the rwkv block holds its channel-mix
    params["norm2"] = norm_init(cfg.d_model, lead, gen.device)
    ftype, params[ftype] = _init_ffn(gen, cfg, layer_idx, lead)
    return params


def _window(cfg: ModelConfig, kind: str, window_override):
    """The attention window of a layer kind: ``local_attn`` the config's
    sliding window, ``global_attn`` the override (None: full attention),
    ``attn`` the override or else the config's window."""
    if kind == "local_attn":
        return cfg.attention.sliding_window
    if kind == "global_attn":
        return window_override
    return window_override or cfg.attention.sliding_window


def _same_impl():
    """``checkpoint``'s ``context_fn``: the forward and its recompute in the
    backward pass, outside the caller's ``ops.use``, take the forward's
    choice of implementation."""
    impl = ops.current()
    return ops.use(impl), ops.use(impl)


def _apply_layer(params, cfg: ModelConfig, kind: str, x, *, cache, mode,
                 window_override=None, prefix_len=None):
    """Returns (x_out, new_cache, aux_loss); aux_loss is None for a layer
    without MoE.  ``prefix_len`` (the image prefix of a vision_text batch)
    reaches GQA attention; MLA and the recurrent blocks take none, as in the
    JAX package."""
    _, norm_fn = L.make_norm(cfg.norm)
    aux = None
    h = norm_fn(params["norm1"], x)
    if kind in ATTN_KINDS and cfg.attention.kind == "mla":
        a = cfg.attention                  # MLA takes no window
        y, new_cache = MLA.mla_attention(
            params["attn"], h, num_heads=a.num_heads,
            qk_nope_head_dim=a.qk_nope_head_dim, qk_rope_head_dim=a.qk_rope_head_dim,
            v_head_dim=a.v_head_dim, rope_theta=a.rope_theta, yarn=a.yarn, cache=cache,
            mode=mode)
    elif kind in ATTN_KINDS:
        a = cfg.attention
        y, new_cache = L.gqa_attention(
            params["attn"], h, num_heads=a.num_heads,
            num_kv_heads=a.num_kv_heads, head_dim=a.head_dim,
            rope_theta=a.rope_theta, use_rope=a.use_rope, causal=a.causal,
            window=_window(cfg, kind, window_override), prefix_len=prefix_len,
            logit_cap=a.logit_softcap, cache=cache, mode=mode)
    elif kind == "rglru":
        y, new_cache = RG.rglru_block(params["rglru"], h,
                                      conv_width=cfg.rglru.conv_width,
                                      state=cache, mode=mode)
    else:
        y, new_cache = RW.rwkv_block(params["rwkv"], h,
                                     head_size=cfg.rwkv.head_size,
                                     state=cache, mode=mode)
        return x + y.to(x.dtype), new_cache, aux
    x = x + y.to(x.dtype)
    h2 = norm_fn(params["norm2"], x)
    if "moe" in params and cfg.moe.held_experts is not None:
        m = cfg.moe
        y2 = MOE.moe_ffn_held(params["moe"], h2, num_experts=m.num_experts,
                              top_k=m.top_k, held=m.held_experts,
                              activation=cfg.activation, scoring=m.scoring,
                              n_group=m.n_group, topk_group=m.topk_group,
                              routed_scaling_factor=m.routed_scaling_factor,
                              decode=mode == "decode")
    elif "moe" in params:
        m = cfg.moe
        y2, aux = MOE.moe_ffn(params["moe"], h2, num_experts=m.num_experts,
                              top_k=m.top_k, capacity_factor=m.capacity_factor,
                              activation=cfg.activation,
                              router_aux_weight=m.router_aux_weight,
                              expert_sharding=m.expert_axis)
    else:
        y2 = L.mlp(params["mlp"], h2, cfg.activation)
    return x + y2.to(x.dtype), new_cache, aux


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def _pattern_split(cfg: ModelConfig) -> tuple[int, list[str], list[str]]:
    """(num_groups, pattern, remainder_kinds).  The leading
    ``first_k_dense`` layers run unscanned, so the groups cover
    ``num_layers - first_k_dense``."""
    p = list(cfg.block_pattern)
    lead = _lead_layers(cfg)
    if not cfg.scan_layers:
        return 0, p, cfg.pattern_layers[lead:]
    n_groups = (cfg.num_layers - lead) // len(p)
    remainder = cfg.pattern_layers[lead + n_groups * len(p):]
    return n_groups, p, remainder


def init_model(cfg: ModelConfig, *, seed: int = 0,
               device: str | torch.device = "cuda") -> dict:
    """Random float32 weights with the JAX package's distributions, drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device``.  Returns
    the params dict; its logical sharding axes, which the JAX package's
    ``init_model`` returns beside it, are :func:`model_axes`.  On
    ``device="meta"`` the tree holds shapes and dtypes only, and no
    generator is made (a dry run's weights)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = L.ShapeOnly() if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    params: dict[str, Any] = {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                  cfg.tie_embeddings)}
    if cfg.modality.kind in ("vision_text", "audio_frames"):
        fd = cfg.modality.frontend_dim
        params["frontend_proj"] = L.dense_init(gen, (fd, cfg.d_model), fd)
    n_groups, pattern, remainder = _pattern_split(cfg)
    # the scanned groups and the tail take the MoE FFN in an MoE config (the
    # JAX package initialises them as layer 10**6); only ``lead`` is dense
    if n_groups > 0:
        params["blocks"] = tuple(_init_layer(gen, cfg, kind, 10**6, (n_groups,))
                                 for kind in pattern)
    lead = _lead_layers(cfg)
    if lead:
        params["lead"] = [_init_layer(gen, cfg, cfg.pattern_layers[i], i)
                          for i in range(lead)]
    if remainder:
        params["tail"] = [_init_layer(gen, cfg, kind, 10**6) for kind in remainder]
    norm_init, _ = L.make_norm(cfg.norm)
    params["final_norm"] = norm_init(cfg.d_model, (), dev)
    if cfg.mtp:
        # DeepSeek-V3's MTP module: [h_t ; emb(token_{t+1})] projected to d,
        # one more block of the pattern's last kind (an MoE layer in an MoE
        # config), its own norm, the shared unembedding
        params["mtp_proj"] = L.dense_init(gen, (2 * cfg.d_model, cfg.d_model),
                                          2 * cfg.d_model)
        params["mtp_block"] = _init_layer(gen, cfg, cfg.block_pattern[-1], 10**6)
        params["mtp_norm"] = norm_init(cfg.d_model, (), dev)
    return params


def _layer_axes(cfg: ModelConfig, kind: str, layer_idx: int) -> dict:
    """The logical axes of ``_init_layer``'s params (without ``lead``)."""
    axes: dict[str, Any] = {"norm1": L.norm_axes(cfg.norm)}
    if kind in ATTN_KINDS:
        axes["attn"] = dict(MLA.MLA_AXES if cfg.attention.kind == "mla" else L.GQA_AXES)
        if cfg.attention.kind == "mla" and cfg.attention.latent_norms:
            axes["attn"].update(MLA.LATENT_NORM_AXES)
    elif kind == "rglru":
        axes["rglru"] = dict(RG.RGLRU_AXES)
    else:
        axes["rwkv"] = dict(RW.RWKV_AXES)
        return axes
    axes["norm2"] = L.norm_axes(cfg.norm)
    if _uses_moe(cfg, layer_idx):
        axes["moe"] = MOE.moe_axes(cfg.moe.num_shared_experts, cfg.activation,
                                   router_bias=cfg.moe.scoring == "sigmoid")
    else:
        axes["mlp"] = L.mlp_axes(cfg.activation)
    return axes


def model_axes(cfg: ModelConfig) -> dict:
    """The logical sharding axes of :func:`init_model`'s params: the same
    nesting of dicts, tuples and lists, each tensor's place taken by a tuple
    of logical axis names (``"embed"``, ``"heads"``, ...) or ``None``, one
    per dimension, as the JAX package's ``init_model`` returns them.  The
    stacked ``blocks`` lead with ``None`` for their ``n_groups`` axis.
    ``launch/sharding.py`` maps them onto a mesh."""
    _check_supported(cfg)
    axes: dict[str, Any] = {"embed": L.embedding_axes(cfg.tie_embeddings)}
    if cfg.modality.kind in ("vision_text", "audio_frames"):
        axes["frontend_proj"] = (None, "embed")
    n_groups, pattern, remainder = _pattern_split(cfg)
    if n_groups > 0:
        axes["blocks"] = tuple(
            {k: {n: (None, *ax) for n, ax in sub.items()}
             for k, sub in _layer_axes(cfg, kind, 10**6).items()}
            for kind in pattern)
    lead = _lead_layers(cfg)
    if lead:
        axes["lead"] = [_layer_axes(cfg, cfg.pattern_layers[i], i) for i in range(lead)]
    if remainder:
        axes["tail"] = [_layer_axes(cfg, kind, 10**6) for kind in remainder]
    axes["final_norm"] = L.norm_axes(cfg.norm)
    if cfg.mtp:
        axes["mtp_proj"] = (None, "embed")
        axes["mtp_block"] = _layer_axes(cfg, cfg.block_pattern[-1], 10**6)
        axes["mtp_norm"] = L.norm_axes(cfg.norm)
    return axes


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, context_len: int,
                 window_override, dtype, dev, lead=(), device_index=False):
    if kind in ATTN_KINDS:
        a = cfg.attention
        if a.kind == "mla":
            return MLA.init_mla_cache(batch, context_len, a.kv_lora_rank,
                                      a.qk_rope_head_dim, dtype, dev, lead,
                                      device_index=device_index)
        if kind == "local_attn" and a.sliding_window:
            size = min(a.sliding_window, context_len)
        elif window_override:
            size = min(window_override, context_len)
        else:
            size = context_len
        return L.init_kv_cache(batch, size, a.num_kv_heads, a.head_dim, dtype,
                               dev, lead)
    if kind == "rglru":
        return RG.init_rglru_state(batch, cfg.rglru.lru_width or cfg.d_model,
                                   cfg.rglru.conv_width, dtype, dev, lead)
    return RW.init_rwkv_state(batch, cfg.d_model, cfg.rwkv.head_size, dtype,
                              dev, lead)


def init_caches(cfg: ModelConfig, batch: int, context_len: int,
                window_override=None, dtype=torch.bfloat16,
                device: str | torch.device = "cuda", device_index: bool = False) -> dict:
    """Cache dict matching the model structure, one cache per layer by its
    kind; ``blocks`` caches carry the leading ``n_groups`` axis like the
    params.  ``window_override`` sizes the caches of ``attn`` and
    ``global_attn`` layers as ``apply_model``'s argument windows them.
    ``device_index`` gives each ``MLACache`` its position as a tensor on
    the device (the engine's captured decode)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    n_groups, pattern, remainder = _pattern_split(cfg)

    def one(kind, lead=()):
        return _layer_cache(cfg, kind, batch, context_len, window_override, dtype,
                            dev, lead, device_index)

    caches: dict[str, Any] = {}
    if n_groups > 0:
        caches["blocks"] = tuple(one(kind, (n_groups,)) for kind in pattern)
    lead = _lead_layers(cfg)
    if lead:
        caches["lead"] = [one(cfg.pattern_layers[i]) for i in range(lead)]
    if remainder:
        caches["tail"] = [one(kind) for kind in remainder]
    return caches


def cache_rows(caches: dict, batch: int) -> dict:
    """The first ``batch`` rows of an :func:`init_caches` dict, as views (the
    batch axis follows a stacked cache's group axis): writes through them
    reach ``caches``, whose other rows they leave alone.  A device
    ``index`` has no batch axis: the views share it."""
    def rows(cache, stacked: bool):
        return type(cache)(**{
            f.name: ((v[:, :batch] if stacked else v[:batch])
                     if isinstance(v := getattr(cache, f.name), torch.Tensor)
                     and f.name != "index" else v)
            for f in dataclasses.fields(cache)})

    return {name: type(group)(rows(c, name == "blocks") for c in group)
            for name, group in caches.items()}


def reset_caches(caches: dict) -> None:
    """Refill an :func:`init_caches` dict, or :func:`cache_rows` of one, in
    place with what ``init_caches`` puts there: zeros, and -1 (empty) in a
    KV cache's ``positions``."""
    for group in caches.values():
        for cache in group:
            for f in dataclasses.fields(cache):
                v = getattr(cache, f.name)
                if isinstance(v, torch.Tensor):
                    v.fill_(-1 if f.name == "positions" else 0)


def _group(cache, g: int):
    """Group ``g``'s view of a stacked cache (a KVCache, MLACache,
    RGLRUState or RWKVState): its tensors indexed on the leading axis, so
    that in-place writes reach the stack; other fields (an attention cache's
    index) as they are."""
    return type(cache)(**{
        f.name: (getattr(cache, f.name)[g]
                 if isinstance(getattr(cache, f.name), torch.Tensor)
                 else getattr(cache, f.name))
        for f in dataclasses.fields(cache)})


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
    window_override: int | None = None,
) -> tuple[torch.Tensor, dict | None, Any]:
    """Forward pass.  ``batch`` keys by modality: ``tokens`` (B, T) for
    text; ``patches`` (B, P, frontend_dim) and ``tokens`` (B, T_text) for
    vision_text (tokens only in decode); ``frames`` (B, T, frontend_dim)
    for audio_frames.

    Returns (logits, new_caches, aux_loss) like the JAX package; aux_loss
    is the sum of the MoE layers' router losses (a zero without MoE).  With
    ``cfg.mtp`` in train mode it is ``(aux_loss, mtp_logits)``: the MTP
    head's logits for token t+2 at each position t (its block's router loss
    is in aux_loss).
    ``train`` takes no caches and returns None for them; prefill and decode
    update ``caches`` (from :func:`init_caches`, with the same
    ``window_override``) in place and return them.  ``window_override``
    windows ``global_attn`` and ``attn`` layers.  Each kernel and product
    runs as ``kernels.ops`` chooses (``ops.use``; under remat the recompute
    takes the forward's choice).
    """
    _check_supported(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got {mode!r}")
    train = mode == "train"
    if not train and caches is None:
        raise ValueError(f"mode={mode!r} needs caches (init_caches)")
    prefix_len = None
    if cfg.modality.kind == "vision_text" and mode != "decode":
        if "patches" not in batch:
            raise ValueError(f"{cfg.name}: a vision_text batch in {mode} mode needs "
                             f"'patches' (B, P, {cfg.modality.frontend_dim}) beside 'tokens'")
        patches = batch["patches"]
        x_txt = L.embed(params["embed"], batch["tokens"],
                        scale_by_dim=cfg.embedding_scale)
        x_img = L._mm(patches, params["frontend_proj"])      # not scaled
        x = torch.cat([x_img.to(x_txt.dtype), x_txt], dim=1)
        prefix_len = patches.shape[1]
    elif cfg.modality.kind == "audio_frames":
        x = L._mm(batch["frames"], params["frontend_proj"])
    else:
        x = L.embed(params["embed"], batch["tokens"],
                    scale_by_dim=cfg.embedding_scale)
    x = x.to(torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)

    n_groups, pattern, remainder = _pattern_split(cfg)
    kw = dict(mode=mode, window_override=window_override, prefix_len=prefix_len)
    total_aux = torch.zeros((), device=x.device)

    def layer(p, kind, x, cache):
        nonlocal total_aux
        if train and cfg.remat:
            x, c, aux = checkpoint(_apply_layer, p, cfg, kind, x, cache=None,
                                   use_reentrant=False, context_fn=_same_impl, **kw)
        else:
            x, c, aux = _apply_layer(p, cfg, kind, x, cache=cache, **kw)
        if aux is not None:
            total_aux = total_aux + aux
        return x, c

    new_caches: dict[str, Any] = {}
    lead = _lead_layers(cfg)
    if lead:
        lead_caches = []
        for i in range(lead):
            x, c2 = layer(params["lead"][i], cfg.pattern_layers[i], x,
                          None if train else caches["lead"][i])
            lead_caches.append(c2)
        if not train:
            new_caches["lead"] = lead_caches
    if n_groups > 0:
        groups = [_unstack(params["blocks"][i], n_groups) for i in range(len(pattern))]
        last = [None] * len(pattern)
        for g in range(n_groups):
            for i, kind in enumerate(pattern):
                cache = None if train else _group(caches["blocks"][i], g)
                x, last[i] = layer(groups[i][g], kind, x, cache)
        if not train:
            # the stacks were written in place; an attention cache takes the
            # index its layer advanced to
            new_caches["blocks"] = tuple(
                dataclasses.replace(c, index=last[i].index)
                if isinstance(c, (L.KVCache, MLA.MLACache))
                and not isinstance(c.index, torch.Tensor) else c
                for i, c in enumerate(caches["blocks"]))
    if remainder:
        tail = []
        for i, kind in enumerate(remainder):
            x, c2 = layer(params["tail"][i], kind, x,
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
    if cfg.mtp and train and cfg.modality.kind == "text":
        # position t pairs with the embedding of token t+1 (zeros at the end)
        emb = L.embed(params["embed"], batch["tokens"],
                      scale_by_dim=cfg.embedding_scale).to(xn.dtype)
        emb_shift = torch.cat([emb[:, 1:], torch.zeros_like(emb[:, :1])], dim=1)
        h = L._mm(torch.cat([xn, emb_shift], dim=-1), params["mtp_proj"]).to(xn.dtype)
        h, _, aux = _apply_layer(params["mtp_block"], cfg, cfg.block_pattern[-1], h,
                                 cache=None, mode="train")
        if aux is not None:
            total_aux = total_aux + aux
        mtp_logits = L.unembed(params["embed"], norm_fn(params["mtp_norm"], h),
                               logit_cap=cap)
        return logits, None, (total_aux, mtp_logits)
    return logits, (None if train else new_caches), total_aux
