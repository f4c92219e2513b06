"""Serving DeepSeek-V3, one expert-parallel chip's share, through
``repro_torch``'s ``ServingEngine.run_batch`` under open-loop arrivals.

The window, the batching policy, the latencies and the idle gaps' labels are
``drivers/serve.py``'s (``serve_window``, ``latencies``, ``host_label``,
``prompts_of``), as is the server's clock seam and warm-up (``Server`` is
a subclass).  Its own: the configuration's mapping onto the program
(:func:`port_config`, which raises on what the program cannot run), the
weights (:func:`make_weights`), the check and the MoE readings.

The tracer is on from set-up (``repro_torch.tracing``): each prefill
records the spans ``moe.route`` and ``moe.experts`` and the held experts'
counts.  The program logs each MoE layer's chosen experts
(``moe.log_routes``: prefill's as they are, decode's in a ring on the
device that the graphs write), taken after each batch; decode's counts come
from that log and the graphs' rows (:func:`decode_counts`).

After the window, with the engine's buffers freed, the check holds the served tokens to the plain reference
(``reference/deepseek_v3.py``) over a sample of finished requests: the
reference runs each request's left-padded sequence with each MoE layer
pinned, token by token, to the experts the program chose for it (in its
batch's prefill, then in each decode step), and

- ``logit_gap``: the widest gap of a served token below the pinned
  reference's best logit;
- ``route_flip_share``: the share of (token, MoE layer) pairs, over the
  checked sequences' real tokens, whose expert set differs from the one
  the reference chooses itself at that layer;
- ``moe_dropped_slots``: slots routed to a held expert and not computed in
  the window's prefills (the program's ``moe.dropped``; decode computes
  every held expert on every row), held to 0: the layer is dropless;
- ``precision_departures``: as ``drivers/common.py`` counts them, held to
  0.

With ``ctx.control`` also, for each lower precision of the reference put in
the program's place (its own routing, the tokens it puts first), the same
two numbers against the float32 reference pinned to its routing.

A planted fault (``ctx.fault``, the harness's own tests) is called with the
server before the engine is made: it may replace ``program_cfg`` or
``program_params`` (what the engine gets; the reference keeps the cell's),
and may return a context that stays open for the rest of the run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import numpy as np
import torch

from r2bench import checks, harness, trace
from r2bench.drivers.common import device_info, load_fault, precision_departures
from r2bench.drivers.serve import Server as _Server
from r2bench.drivers.serve import host_label, latencies, prompts_of, serve_window
from r2bench.formulas import flash_fwd_cost
from r2bench.formulas_deepseek_v3 import prefill_flops
from r2bench.reference import deepseek_v3 as ref
from r2bench.reference.llama import Precision
from r2bench.traffic.requests import schedule
from r2bench.traffic.tokens import BigramTokens
from r2bench.weights import flatten

#: the held layer's prefill counters (``models/moe.py``)
COUNTERS = ("moe.tokens", "moe.held_slots", "moe.expert_rows", "moe.dropped")

#: what the program runs of the published configuration, key by key
FIXED = {"hidden_act": "silu", "attention_bias": False, "tie_word_embeddings": False,
         "scoring_func": "sigmoid", "topk_method": "noaux_tc", "norm_topk_prob": True,
         "moe_layer_freq": 1, "num_nextn_predict_layers": 0, "rms_norm_eps": 1e-6}
#: products in the check's controls (``ctx.control``)
CONTROLS = {"tf32_products": "tf32", "bfloat16_products": "bfloat16"}


def port_config(c: dict):
    """The program's ``ModelConfig`` for configuration ``c``: the registry's
    DeepSeek-V3 at the file's sizes and depth, with its latent norms, YaRN,
    the sigmoid group-limited router and the held experts.  Raises where
    the file states what the program cannot run."""
    from repro_torch.configs.base import YaRNConfig
    from repro_torch.models import get_config

    bad = {k: c.get(k) for k, v in FIXED.items() if c.get(k) != v}
    rs = c["rope_scaling"]
    if rs.get("type") != "yarn":
        bad["rope_scaling.type"] = rs.get("type")
    if c["num_key_value_heads"] != c["num_attention_heads"]:
        bad["num_key_value_heads"] = c["num_key_value_heads"]
    if bad:
        raise ValueError(f"{c['registry']}: the program runs {FIXED}; the configuration "
                         f"states {bad}")
    base = get_config(c["registry"])
    attn = dataclasses.replace(
        base.attention, num_heads=c["num_attention_heads"],
        num_kv_heads=c["num_key_value_heads"], head_dim=c["v_head_dim"],
        rope_theta=float(c["rope_theta"]), q_lora_rank=c["q_lora_rank"],
        kv_lora_rank=c["kv_lora_rank"], qk_nope_head_dim=c["qk_nope_head_dim"],
        qk_rope_head_dim=c["qk_rope_head_dim"], v_head_dim=c["v_head_dim"],
        latent_norms=True,
        yarn=YaRNConfig(factor=float(rs["factor"]),
                        original_max_position_embeddings=rs["original_max_position_embeddings"],
                        beta_fast=float(rs["beta_fast"]), beta_slow=float(rs["beta_slow"]),
                        mscale=float(rs["mscale"]), mscale_all_dim=float(rs["mscale_all_dim"])))
    moe = dataclasses.replace(
        base.moe, num_experts=c["n_routed_experts_published"], top_k=c["num_experts_per_tok"],
        num_shared_experts=c["n_shared_experts"], expert_d_ff=c["moe_intermediate_size"],
        first_k_dense=c["first_k_dense_replace"], scoring="sigmoid", n_group=c["n_group"],
        topk_group=c["topk_group"], routed_scaling_factor=float(c["routed_scaling_factor"]),
        held_experts=(c["first_held_expert"], c["n_routed_experts"]))
    return dataclasses.replace(
        base, num_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"], tie_embeddings=False,
        attention=attn, moe=moe, mtp=False, dtype=c["precision"]["residual"], remat=False)


def _normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device).mul_(std)


def make_weights(c: dict, seed: int, device) -> dict:
    """float32 weights in the program's layout (``transformer.init_model``'s:
    ``lead`` the dense layers, ``blocks`` the MoE layers stacked), one
    ``torch.randn`` call a leaf from one generator on the device: normal,
    std 0.02 for the embedding, ``1/sqrt(fan_in)`` for the products, 0.1
    for the norms' scales and the router's selection bias."""
    d, L, V = c["hidden_size"], c["num_hidden_layers"], c["vocab_size"]
    k, H = c["first_k_dense_replace"], c["num_attention_heads"]
    ql, R, rope = c["q_lora_rank"], c["kv_lora_rank"], c["qk_rope_head_dim"]
    qk, vd = c["qk_nope_head_dim"] + rope, c["v_head_dim"]
    F, ff, E, n = (c["intermediate_size"], c["moe_intermediate_size"],
                   c["n_routed_experts_published"], c["n_routed_experts"])
    S = c["n_shared_experts"] * ff
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed % 2**63)

    def attn(*lead):
        return {"w_dq": _normal(gen, (*lead, d, ql), d ** -0.5),
                "w_uq": _normal(gen, (*lead, ql, H, qk), ql ** -0.5),
                "w_dkv": _normal(gen, (*lead, d, R), d ** -0.5),
                "w_kpe": _normal(gen, (*lead, d, rope), d ** -0.5),
                "w_uk": _normal(gen, (*lead, R, H, c["qk_nope_head_dim"]), R ** -0.5),
                "w_uv": _normal(gen, (*lead, R, H, vd), R ** -0.5),
                "w_o": _normal(gen, (*lead, H, vd, d), (H * vd) ** -0.5),
                "q_norm": _normal(gen, (*lead, ql), 0.1),
                "kv_norm": _normal(gen, (*lead, R), 0.1)}

    embed = {"embedding": _normal(gen, (V, d), 0.02), "unembed": _normal(gen, (d, V), d ** -0.5)}
    lead = [{"norm1": {"scale": _normal(gen, (d,), 0.1)}, "attn": attn(),
             "norm2": {"scale": _normal(gen, (d,), 0.1)},
             "mlp": {"wg": _normal(gen, (d, F), d ** -0.5), "wu": _normal(gen, (d, F), d ** -0.5),
                     "wd": _normal(gen, (F, d), F ** -0.5)}} for _ in range(k)]
    g = L - k
    blocks = {"norm1": {"scale": _normal(gen, (g, d), 0.1)}, "attn": attn(g),
              "norm2": {"scale": _normal(gen, (g, d), 0.1)},
              "moe": {"router": _normal(gen, (g, d, E), d ** -0.5),
                      "router_bias": _normal(gen, (g, E), 0.1),
                      "wg": _normal(gen, (g, n, d, ff), d ** -0.5),
                      "wu": _normal(gen, (g, n, d, ff), d ** -0.5),
                      "wd": _normal(gen, (g, n, ff, d), ff ** -0.5),
                      "shared_wg": _normal(gen, (g, d, S), d ** -0.5),
                      "shared_wu": _normal(gen, (g, d, S), d ** -0.5),
                      "shared_wd": _normal(gen, (g, S, d), S ** -0.5)}}
    return {"embed": embed, "lead": lead, "blocks": (blocks,),
            "final_norm": {"scale": _normal(gen, (d,), 0.1)}}


class Server(_Server):
    """The engine and its recorded clock for the DeepSeek-V3 configuration;
    each batch also drains the tracer (the batch's spans and its prefill's
    counts)."""

    def __init__(self, ctx: harness.Context):
        from repro_torch.models import moe
        from repro_torch.serving.engine import Request, ServingEngine

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.c, self.mix = ctx.cell.config, ctx.cell.traffic
        self.device = torch.device(ctx.device)
        self.cfg = self.program_cfg = port_config(self.c)
        self.params = self.program_params = make_weights(self.c, ctx.seed, self.device)
        self.stamps: list[float] = []
        self.Request = Request
        self.tokens = BigramTokens(self.c["vocab_size"], ctx.seed)
        self.fault = None                       # serve.Server's token rewrite: none here
        moe.log_routes(self.device, self.mix["max_batch"], self.c["num_experts_per_tok"],
                       calls=8192)
        self.planted = contextlib.ExitStack()
        planted = load_fault(ctx.fault)
        if planted is not None:
            opened = planted(self)
            if opened is not None:
                self.planted.enter_context(opened)
        self.engine = ServingEngine(
            self.program_cfg, self.program_params, context_len=self.mix["context_len"],
            strategy=self.mix["strategy"], nics_per_node=self.mix["nics_per_node"],
            cache_dtype=getattr(torch, self.c["precision"]["cache"]), clock=self._clock,
            device=self.device)
        self.spans: list = []
        self.counters: list[dict] = []
        self.routes: list[tuple] = []

    def batch(self, prompts, outputs):
        from repro_torch import tracing
        from repro_torch.models import moe

        out = super().batch(prompts, outputs)
        rec = tracing.drain()
        self.spans.extend(rec["spans"])
        self.counters.append(rec["counters"])
        self.routes.append(moe.take_routes(self.device))
        return out


def pinned_routes(b: dict, k: int, routes: tuple) -> list:
    """Row ``k`` of batch ``b``'s chosen experts at each MoE layer, over its
    left-padded prompt (prefill) and each served token but the last (a
    decode step each): (width + tokens - 1, top_k) a layer."""
    pre, dec = routes
    B, W, n = len(b["requests"]), b["width"], len(pre)
    steps = (len(b["stamps"]) - 2) // 2
    o = len(b["tokens"][k])
    top_k = pre[0].shape[-1]
    dec = dec[dec.shape[0] - steps * n:].view(steps, n, -1, top_k)
    return [torch.cat([pre[j].view(B, W, top_k)[k], dec[:o - 1, j, k].to(pre[j].dtype)])
            for j in range(n)]


def decode_counts(batches, routes, held: tuple[int, int], rows_of) -> dict:
    """The window's decode counts from the route log: ``moe.tokens`` (real
    rows a call), ``moe.held_slots`` (their slots routed to a held expert)
    and ``moe.expert_rows`` (every held expert on each of the ``rows_of(B)``
    rows the step ran), over each batch's decode calls (a step a MoE
    layer)."""
    first, count = held
    out = dict.fromkeys(COUNTERS[:3], 0)
    for b, (pre, dec) in zip(batches, routes, strict=True):
        B = len(b["requests"])
        calls = (len(b["stamps"]) - 2) // 2 * len(pre)
        real = dec[dec.shape[0] - calls:, :B]
        out["moe.tokens"] += calls * B
        out["moe.held_slots"] += int(((real >= first) & (real < first + count)).sum())
        out["moe.expert_rows"] += calls * count * rows_of(B)
    return out


def flips(own: list, pinned: list, rows: slice) -> tuple[int, int]:
    """(pairs whose expert sets differ, pairs) over ``rows`` of each layer."""
    n = sum(int((a[rows].sort(-1).values != b[rows].sort(-1).values).any(-1).sum())
            for a, b in zip(own, pinned, strict=True))
    return n, sum(a[rows].shape[0] for a in own)


def check(server: Server, ctx: harness.Context, served: dict) -> dict:
    """``logit_gap`` and ``route_flip_share`` over a sample of finished
    requests drawn from the seed (the longest among them), each run once
    through the reference pinned to the experts the program logged for it;
    the controls' readings with ``ctx.control``."""
    c, lim = server.c, ctx.cell.limits
    done = [(b, k, i) for i, b in enumerate(served["batches"]) for k in range(len(b["requests"]))]
    longest = max(range(len(done)), key=lambda i: (done[i][0]["width"]
                                                   + done[i][0]["requests"][done[i][1]].output_len))
    rng = np.random.default_rng((ctx.seed, 4))
    others = [i for i in range(len(done)) if i != longest]
    pick = [longest] + list(rng.choice(others, size=min(len(others), server.mix["check_requests"] - 1),
                                       replace=False))
    prec = Precision(residual=c["precision"]["residual"])
    widest, tokens, flipped, pairs = 0.0, 0, 0, 0
    lower = {name: [0.0, 0, 0] for name in CONTROLS} if ctx.control else {}
    with torch.no_grad():
        for i in pick:
            b, k, bi = done[int(i)]
            r = b["requests"][k]
            out = b["tokens"][k]
            pad = b["width"] - r.prompt_len
            seq = np.concatenate([np.zeros(pad, np.int64), served["prompts"][r.index],
                                  np.asarray(out[:-1], np.int64)])
            x = torch.as_tensor(seq, device=server.device)[None]
            program = pinned_routes(b, k, server.routes[bi])
            own: list = []
            rows = slice(b["width"] - 1, b["width"] - 1 + len(out))
            xn = ref.hidden(server.params, c, x, prec, pins=program, routes=own)
            lg = ref.logits(server.params, xn[0, rows], prec)
            widest = max(widest, float(checks.token_gaps(lg, out).max()))
            n, m = flips(own, program, slice(pad, None))
            flipped, pairs, tokens = flipped + n, pairs + m, tokens + len(out)
            for name, products in CONTROLS.items() if lower else ():
                # the lower precision in the program's place: its own routing
                # pins the float32 reference, as the check pins it to the program's
                lp = Precision(products=products, residual=prec.residual)
                mine: list = []
                low = ref.logits(server.params, ref.hidden(server.params, c, x, lp,
                                                           routes=mine)[0, rows], lp)
                base: list = []
                held = ref.logits(server.params, ref.hidden(server.params, c, x, prec, pins=mine,
                                                            routes=base)[0, rows], prec)
                lower[name][0] = max(lower[name][0],
                                     float(checks.token_gaps(held, low.argmax(-1)).max()))
                n, m = flips(base, mine, slice(pad, None))
                lower[name][1] += n
                lower[name][2] += m
            del program, own, xn
    print(f"r2bench: {len(pick)} requests, {tokens} served tokens and {pairs} (token, MoE "
          f"layer) pairs checked", flush=True)
    result = {"logit_gap": (widest, lim["logit_gap"]),
              "route_flip_share": (flipped / max(pairs, 1), lim["route_flip_share"])}
    for name, (gap, n, m) in lower.items():
        result[f"{name}_logit_gap"] = (gap, lim["logit_gap"])
        result[f"{name}_route_flip_share"] = (n / max(m, 1), lim["route_flip_share"])
    return result


def flash_roofline(events, batches, c: dict, precision: str) -> dict | None:
    """The flash forward's bound and device time over the window: one
    launch a layer of each prefill, q (B, T, H, 1, nope + rope), V padded to
    that width."""
    launches = [e for e in events if "flash_fwd" in e[2]]
    L, H = c["num_hidden_layers"], c["num_attention_heads"]
    D = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    shapes = [(len(b["requests"]), b["width"]) for b in batches for _ in range(L)]
    if not launches or len(launches) != len(shapes):
        print(f"r2bench: {len(launches)} flash forward launches against {len(shapes)} "
              "calls; flash_fwd_roofline.serve is not read", flush=True)
        return None
    bound = sum(flash_fwd_cost((B, T, H, 1, D), (B, T, H, D), precision).bound_s()
                for B, T in shapes)
    return {"bound_s": bound, "device_s": sum((b - a) * 1e-9 for a, b, _ in launches)}


def span_device_s(prof, spans, names: tuple[str, ...]) -> float | None:
    """Device seconds of the operations launched inside the spans named
    ``names``: the host launch calls inside a span give their correlation
    ids, the device operations with those ids their durations.  None where
    the trace holds no launch inside them."""
    inside = sorted((s.start_ns, s.end_ns) for s in spans if s.name in names)
    if not inside:
        return None
    starts = np.array([a for a, _ in inside], dtype=np.int64)
    ends = np.array([b for _, b in inside], dtype=np.int64)
    ids, device = set(), []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append(e)
            continue
        j = np.searchsorted(starts, e.start_ns(), side="right") - 1
        if j >= 0 and e.start_ns() <= ends[j] and getattr(e, "correlation_id", int)():
            ids.add(e.correlation_id())
    if not ids:
        print("r2bench: no launch inside the MoE spans in the trace; moe_prefill_ms.serve "
              "is not read", flush=True)
        return None
    return sum(e.duration_ns() for e in device if e.correlation_id() in ids) * 1e-9


def run(ctx: harness.Context) -> dict:
    from repro_torch import tracing
    from repro_torch.models import moe

    c, mix = ctx.cell.config, ctx.cell.traffic
    device = torch.device(ctx.device)
    tracing.enable()
    try:
        server = Server(ctx)
        with server.planted:
            return _run(ctx, server, c, mix, tracing)
    finally:
        tracing.disable()
        tracing.drain()
        moe.stop_routes(device)


def _run(ctx, server, c, mix, tracing) -> dict:
    from repro_torch.serving.engine import graph_rows

    reqs = schedule(mix, ctx.seconds)
    prompts = prompts_of(server, reqs)
    server.warm()
    tracing.drain()
    server.spans, server.counters, server.routes = [], [], []
    if server.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(server.device)
    setup_s = time.time() - ctx.t_process
    prof = trace.profiler(cpu=False) if ctx.trace else None
    served = serve_window(server, reqs, prompts, ctx.seconds, prof)
    peak = torch.cuda.max_memory_allocated(server.device) if server.device.type == "cuda" else 0
    ttft, tpot = latencies(reqs, served["batches"])
    failed = sum(1 for t in ttft if math.isinf(t))
    out = {"e2e": {"tpot_p90_ms": 1e3 * harness.percentile(tpot, 90), "setup_s": setup_s},
           "attempted": len(reqs), "failed": failed,
           "device": device_info(server.device, ctx.cell.chips, peak)}
    batches = served["batches"]
    st = [b["stamps"] for b in batches]
    counted = {name: sum(cn.get(name, 0) for cn in server.counters)
               for name in (*COUNTERS, "engine.graph_replay", "engine.decode_eager")}
    steps = sum((len(s) - 2) // 2 for s in st)
    G = mix["max_batch"]                 # the warm-up's largest batch: the graphs' rows
    decode = decode_counts(batches, server.routes, server.program_cfg.moe.held_experts,
                           (lambda B: min(r for r in graph_rows(G) if r >= B))
                           if server.engine.capture else (lambda B: B))
    # each prefill's held slots, the real tokens' share of its padded rows
    held = sum(cn.get("moe.held_slots", 0) * sum(r.prompt_len for r in b["requests"])
               / (len(b["requests"]) * b["width"]) for cn, b in zip(server.counters, batches))
    print(f"r2bench: window: {len(batches)} batches of "
          f"{[len(b['requests']) for b in batches]} rows, {steps} decode steps; "
          f"engine.graph_replay {counted['engine.graph_replay']}, engine.decode_eager "
          f"{counted['engine.decode_eager']}; decode {decode}; prefill "
          f"{ {n: counted[n] for n in COUNTERS} }", flush=True)
    records = {"serve": {
        "prefill_s": [s[1] - s[0] for s in st],
        "decode_s": sum(s[j + 1] - s[j] for s in st for j in range(2, len(s) - 1, 2)),
        "decode_steps": steps,
        "ttft_s": ttft,
        "prefill_flops": prefill_flops(c, [r.prompt_len for b in batches for r in b["requests"]],
                                       held),
        "graph_replay": counted["engine.graph_replay"],
        "decode_eager": counted["engine.decode_eager"],
        "moe": {"decode_expert_rows": decode["moe.expert_rows"],
                "decode_held_slots": decode["moe.held_slots"],
                "prefill_held_slots": counted["moe.held_slots"]},
    }}
    if ctx.trace:
        lo, hi = served["win0_ns"], served["win1_ns"]
        events = trace.device_events(prof, lo, hi)
        busy_s, gaps = trace.busy([(a, b) for a, b, _ in events], lo, hi)
        window_s = (hi - lo) * 1e-9
        out["device"].update(busy_s=busy_s, window_s=window_s)
        out["breakdown"] = trace.breakdown(trace.by_name(events), gaps, host_label(batches, lo))
        records["serve"].update(
            busy_s=busy_s, trace_window_s=window_s,
            flash=flash_roofline(events, batches, c, c["precision"]["products"]),
            moe_prefill_s=span_device_s(prof, server.spans, ("moe.route", "moe.experts")),
            prefills=len(batches))
        del events, prof
    out["records"] = records
    departures = precision_departures(flatten(server.engine.params))
    server.engine = None
    if server.device.type == "cuda":
        torch.cuda.empty_cache()
    lim = ctx.cell.limits
    out["checks"] = check(server, ctx, served) if batches else {
        "logit_gap": (math.inf, lim["logit_gap"]),
        "route_flip_share": (math.inf, lim["route_flip_share"])}
    out["checks"]["moe_dropped_slots"] = (counted["moe.dropped"], 0)
    out["checks"]["precision_departures"] = (departures, 0)
    return out
