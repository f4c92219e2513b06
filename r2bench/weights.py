"""Weights of a llama-architecture configuration, made on the device from the
seed, in the parameter layout that ``repro_torch`` and the plain reference
both take.

The layout: ``embed.embedding`` (V, d), ``embed.unembed`` (d, V) when the
head is not tied, ``blocks`` a one-element tuple of the layer's params
stacked over the layers (``attn.wq`` (L, d, H, D), ``wk``/``wv`` (L, d,
KVH, D), ``wo`` (L, H, D, d), ``mlp.wg``/``wu`` (L, d, F), ``wd`` (L, F, d),
``norm1``/``norm2.scale`` (L, d)) and ``final_norm.scale`` (d,).  A norm
multiplies by ``1 + scale``.  One ``torch.randn`` call a leaf, from one
generator on the device: the same seed gives the same bits on the card.
"""

from __future__ import annotations

import torch


def _normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device).mul_(std)


def make_weights(c: dict, seed: int, device) -> dict:
    """float32 weights for configuration ``c`` (``configs/<name>.json``):
    normal, std 0.02 for the embedding, ``1/sqrt(fan_in)`` for the products
    and 0.1 for the norms' scales (drawn, so that the check sees them)."""
    d, L, V = c["hidden_size"], c["num_hidden_layers"], c["vocab_size"]
    H, KVH, D, F = (c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"],
                    c["intermediate_size"])
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed % 2**63)
    embed = {"embedding": _normal(gen, (V, d), 0.02)}
    if not c["tie_word_embeddings"]:
        embed["unembed"] = _normal(gen, (d, V), d ** -0.5)
    layer = {
        "norm1": {"scale": _normal(gen, (L, d), 0.1)},
        "attn": {"wq": _normal(gen, (L, d, H, D), d ** -0.5),
                 "wk": _normal(gen, (L, d, KVH, D), d ** -0.5),
                 "wv": _normal(gen, (L, d, KVH, D), d ** -0.5),
                 "wo": _normal(gen, (L, H, D, d), (H * D) ** -0.5)},
        "norm2": {"scale": _normal(gen, (L, d), 0.1)},
        "mlp": {"wg": _normal(gen, (L, d, F), d ** -0.5),
                "wu": _normal(gen, (L, d, F), d ** -0.5),
                "wd": _normal(gen, (L, F, d), F ** -0.5)},
    }
    return {"embed": embed, "blocks": (layer,),
            "final_norm": {"scale": _normal(gen, (d,), 0.1)}}


def flatten(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """Leaves by path (``blocks.0.attn.wq``), dict keys sorted."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}
