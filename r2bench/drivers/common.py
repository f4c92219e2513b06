"""What both drivers take from the program and the card."""

from __future__ import annotations

import dataclasses
import importlib

import torch


def port_config(c: dict):
    """The program's ``ModelConfig`` for configuration ``c``: the registry's
    architecture (``c["registry"]``) at the file's sizes, depth and residual
    precision.  Raises where the file states what the program cannot run."""
    from repro_torch.models import get_config

    if c["rms_norm_eps"] != 1e-6:
        raise ValueError(f"{c['registry']}: the program's RMSNorm takes eps 1e-6, "
                         f"the configuration states {c['rms_norm_eps']}")
    base = get_config(c["registry"])
    attn = dataclasses.replace(base.attention, num_heads=c["num_attention_heads"],
                               num_kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
                               rope_theta=c["rope_theta"])
    return dataclasses.replace(
        base, num_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
        tie_embeddings=c["tie_word_embeddings"], attention=attn,
        dtype=c["precision"]["residual"], remat=c.get("remat", base.remat))


def device_info(device: torch.device, chips: int, peak_bytes: int) -> dict:
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
            "count": chips, "memory_peak_bytes": int(peak_bytes)}


def load_fault(path: str | None):
    """``module:function`` of a planted fault (the harness's own tests), or
    None."""
    if not path:
        return None
    mod, fn = path.split(":")
    return getattr(importlib.import_module(mod), fn)


def precision_departures(leaves: dict) -> int:
    """How far this process departs from float32 products and weights, as
    both configurations state them (``"tf32": false``): each of the
    switches that lets a float32 product run in TF32 or bfloat16 that is on,
    and each weight leaf that is not float32.  The check compares it with
    0: a product in a lower precision can read inside the program's own
    rounding at the bfloat16 residual stream, so the numbers alone do not
    hold it."""
    n = int(torch.get_float32_matmul_precision() != "highest")
    n += int(bool(torch.backends.cuda.matmul.allow_tf32))
    n += int(bool(torch.backends.cudnn.allow_tf32))
    return n + sum(t.dtype != torch.float32 for t in leaves.values())
