"""Faults planted in the DeepSeek-V3 serving cell's program: each is called
with the server before its engine is made (``drivers/serve_deepseek_v3.py``)
and changes what the program computes, not the reference; each must turn
``correct`` false."""

import contextlib
import dataclasses
import math

import torch


def _moe(server, **kw):
    cfg = server.program_cfg
    server.program_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))


def _attention(server, **kw):
    cfg = server.program_cfg
    server.program_cfg = dataclasses.replace(
        cfg, attention=dataclasses.replace(cfg.attention, **kw))


def _layer_params(server, fn):
    """The program's params with ``fn(layer params)`` applied to the dense
    layers' and the stacked MoE layers' dicts (copies: the reference keeps
    the cell's)."""
    p = dict(server.program_params)
    p["lead"] = [fn({k: dict(v) for k, v in lp.items()}) for lp in p["lead"]]
    p["blocks"] = tuple(fn({k: dict(v) for k, v in b.items()}) for b in p["blocks"])
    server.program_params = p


def softmax_router(server):
    """The router's softmax top-k in place of the sigmoid group-limited one."""
    _moe(server, scoring="softmax")


def scaling_one(server):
    """The routed weights not multiplied by ``routed_scaling_factor``."""
    _moe(server, routed_scaling_factor=1.0)


def no_group_limit(server):
    """Every group kept: the top-8 chosen over all experts."""
    _moe(server, topk_group=server.program_cfg.moe.n_group)


def mscale_left_out(server):
    """YaRN's softmax scale ``mscale_all_dim`` term left out (the
    frequencies kept)."""
    yarn = server.program_cfg.attention.yarn
    _attention(server, yarn=dataclasses.replace(yarn, mscale_all_dim=0.0))


def latent_norms_left_out(server):
    """MLA without its q and kv latent norms."""
    def drop(lp):
        lp["attn"] = {k: v for k, v in lp["attn"].items() if k not in ("q_norm", "kv_norm")}
        return lp
    _attention(server, latent_norms=False)
    _layer_params(server, drop)


def held_expert_zeroed(server):
    """Held expert 3's output zeroed in every MoE layer."""
    def zero(lp):
        if "moe" in lp:
            wd = lp["moe"]["wd"].clone()
            wd[:, 3] = 0
            lp["moe"]["wd"] = wd
        return lp
    _layer_params(server, zero)


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def capacity_dropped(server):
    """Switch-style capacity: each expert takes at most ``ceil(slots / E *
    1.25)`` of a call's (token, choice) slots, in order, the rest dropped
    (weight 0) and counted under ``moe.dropped`` (eager only: the count
    reads the host)."""
    from repro_torch import tracing
    from repro_torch.models import moe

    route, first, count = moe.route, *server.program_cfg.moe.held_experts

    def capped(params, xt, top_k, *args, **kwargs):
        scores, top_w, top_i = route(params, xt, top_k, *args, **kwargs)
        E = scores.shape[-1]
        cap = math.ceil(top_i.numel() / E * 1.25)
        onehot = torch.nn.functional.one_hot(top_i.reshape(-1), E)
        rank = ((torch.cumsum(onehot, 0) * onehot).sum(-1) - 1).view_as(top_i)
        dropped = rank >= cap
        held = (top_i >= first) & (top_i < first + count)
        tracing.count("moe.dropped", int((dropped & held).sum()))
        return scores, top_w.masked_fill(dropped, 0.0), top_i

    return _patched(moe, "route", capped)


def bfloat16_products(server):
    """Every product of the model's layers with its operands rounded to
    bfloat16 (float32 sums), inside the program where no switch shows it;
    decode steps run eagerly on the static buffers (a graph would keep each
    product's rounded copy of its weight)."""
    from repro_torch.models import layers, mla, moe
    from repro_torch.serving import engine

    def mm(x, w):
        return torch.matmul(x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float())

    def expert_mm(x, w):
        return real_expert_mm(x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float())

    def einsum(eq, *ops):
        return torch.einsum(eq, *(t.to(torch.bfloat16).float() for t in ops))

    real_expert_mm = moe._expert_mm
    stack = contextlib.ExitStack()
    for module in (layers, mla, moe):
        stack.enter_context(_patched(module, "_mm", mm))
    for module in (layers, mla):
        stack.enter_context(_patched(module, "_einsum", einsum))
    stack.enter_context(_patched(moe, "_expert_mm", expert_mm))
    stack.enter_context(_patched(engine, "cuda_graph", lambda step: step))
    return stack


PROGRAM_FAULTS = ["softmax_router", "scaling_one", "no_group_limit", "mscale_left_out",
                  "latent_norms_left_out", "held_expert_zeroed", "capacity_dropped",
                  "bfloat16_products"]
