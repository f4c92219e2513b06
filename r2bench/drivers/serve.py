"""Serving through ``repro_torch``'s ``ServingEngine.run_batch`` under
open-loop arrivals.

Set-up makes the weights from the seed on the device, the engine (with
``clock=`` a recording ``time.perf_counter``), the window's requests
(``traffic.requests.schedule``) and their prompts, and runs one batch at the
largest and one at the smallest shape the traffic sends.  The window offers
each request when it is due.  The program has no request scheduler, so the
policy is the driver's: whenever the engine is free, one ``run_batch`` takes
every request due by then, up to ``max_batch``, in order of arrival (the
engine left-pads the prompts of a batch to its longest); when none is due it
waits for the next.  Requests due in the window are served to the end, also
after it closes (for at most ``drain_seconds``): a late request is late, and
its wait counts.

A request's first token comes at the end of its batch's prefill and its
k-th at the end of decode step k - 1: the engine's clock readings.  TTFT runs
from when the request was due, TPOT is (last - first) / (tokens - 1).

After the window the check holds the served tokens against the reference
(``logit_check``) and the process to float32 products and weights
(``precision_departures``).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from r2bench import checks, harness, trace
from r2bench.drivers.common import device_info, load_fault, port_config, precision_departures
from r2bench.formulas import flash_fwd_cost, prefill_flops
from r2bench.reference import llama
from r2bench.traffic.requests import schedule
from r2bench.traffic.tokens import BigramTokens
from r2bench.weights import flatten, make_weights

WARM_INDEX = 1 << 40       # prompt indices of the warm-up batches, past any request's


class Server:
    """The engine and its recorded clock, for the cell's configuration."""

    def __init__(self, ctx: harness.Context):
        from repro_torch.serving.engine import Request, ServingEngine

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.c, self.mix = ctx.cell.config, ctx.cell.traffic
        self.device = torch.device(ctx.device)
        self.cfg = port_config(self.c)
        self.params = make_weights(self.c, ctx.seed, self.device)
        self.stamps: list[float] = []
        self.Request = Request
        self.engine = ServingEngine(
            self.cfg, self.params, context_len=self.mix["context_len"],
            strategy=self.mix["strategy"], nics_per_node=self.mix["nics_per_node"],
            cache_dtype=getattr(torch, self.c["precision"]["cache"]), clock=self._clock,
            device=self.device)
        self.tokens = BigramTokens(self.c["vocab_size"], ctx.seed)
        self.fault = load_fault(ctx.fault)

    def _clock(self) -> float:
        t = time.perf_counter()
        self.stamps.append(t)
        return t

    def batch(self, prompts: list[np.ndarray], outputs: list[int]) -> tuple[list, list[float]]:
        """One ``run_batch``: the tokens of each request and the clock
        readings (prefill start, prefill end, then each decode step's start
        and end)."""
        self.stamps = []
        results = self.engine.run_batch([self.Request(prompt=p, max_new_tokens=n)
                                         for p, n in zip(prompts, outputs)])
        toks = [r.tokens for r in results]
        if self.fault is not None:
            toks = self.fault(toks)
        return toks, self.stamps

    def warm(self) -> None:
        """The largest and the smallest batch the traffic sends."""
        p, o, B = self.mix["prompt"], self.mix["output"], self.mix["max_batch"]
        for n, plen, olen in ((B, p["max"], o["max"]), (1, p["min"], o["min"])):
            self.batch([self.tokens.prompt(WARM_INDEX + i, plen) for i in range(n)], [olen] * n)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def prompts_of(server: Server, reqs) -> dict[int, np.ndarray]:
    return {r.index: server.tokens.prompt(r.index, r.prompt_len) for r in reqs}


def serve_window(server: Server, reqs, prompts: dict, seconds: float, prof=None) -> dict:
    """Offer ``reqs`` (due times in seconds from the window's start, prompts
    by index) to the engine; returns the batches served and the window's
    bounds."""
    drain = server.mix["drain_seconds"]
    batches = []
    if prof is not None:
        prof.__enter__()
    win0_ns = time.time_ns()
    t0 = time.perf_counter()
    i, n = 0, len(reqs)
    while i < n:
        now = time.perf_counter() - t0
        if now > seconds + drain:
            break
        if reqs[i].due > now:
            time.sleep(reqs[i].due - now)
            continue
        j = i
        while j < n and reqs[j].due <= now and j - i < server.mix["max_batch"]:
            j += 1
        group = reqs[i:j]
        toks, stamps = server.batch([prompts[r.index] for r in group],
                                    [r.output_len for r in group])
        batches.append({"requests": group, "tokens": toks, "stamps": [t - t0 for t in stamps],
                        "width": max(r.prompt_len for r in group)})
        i = j
    window_s = time.perf_counter() - t0
    win1_ns = time.time_ns()
    if prof is not None:
        prof.__exit__(None, None, None)
    return {"batches": batches, "served": i, "window_s": window_s, "win0_ns": win0_ns,
            "win1_ns": win1_ns, "prompts": prompts}


def latencies(reqs, batches) -> tuple[list[float], list[float]]:
    """TTFT and TPOT in seconds of every request of ``reqs``; a request never
    served has ``inf`` for both."""
    ttft = {r.index: math.inf for r in reqs}
    tpot = dict(ttft)
    for b in batches:
        st = b["stamps"]
        for r in b["requests"]:
            first = st[1]
            last = st[2 * r.output_len - 1] if r.output_len > 1 else first
            ttft[r.index] = first - r.due
            tpot[r.index] = (last - first) / max(r.output_len - 1, 1)
    return [ttft[r.index] for r in reqs], [tpot[r.index] for r in reqs]


def logit_check(server: Server, ctx: harness.Context, served: dict) -> dict:
    """The widest gap between a served token's logit and the reference's
    best, over a sample of finished requests drawn from the seed (the longest
    among them), each run once through the reference over its batch's
    left-padded prompt and its served tokens; with ``ctx.control`` also, for
    each lower precision of the control, the widest gap of the token that it
    puts first (``control.py``; not compared)."""
    c = server.c
    done = [(b, k) for b in served["batches"] for k in range(len(b["requests"]))]
    longest = max(range(len(done)), key=lambda i: (done[i][0]["width"]
                                                   + done[i][0]["requests"][done[i][1]].output_len))
    rng = np.random.default_rng((ctx.seed, 4))
    others = [i for i in range(len(done)) if i != longest]
    pick = [longest] + list(rng.choice(others, size=min(len(others), server.mix["check_requests"] - 1),
                                       replace=False))
    prec = llama.Precision(residual=c["precision"]["residual"])
    lower = {"tf32_products": llama.Precision(products="tf32", residual=prec.residual),
             "bfloat16_products": llama.Precision(products="bfloat16", residual=prec.residual),
             "float8_residual": llama.Precision(residual="float8_e4m3fn")} if ctx.control else {}
    widest, tokens = 0.0, 0
    widest_lower = dict.fromkeys(lower, 0.0)
    with torch.no_grad():
        for i in pick:
            b, k = done[int(i)]
            r = b["requests"][k]
            out = b["tokens"][k]
            seq = np.concatenate([np.zeros(b["width"] - r.prompt_len, np.int64),
                                  served["prompts"][r.index], np.asarray(out[:-1], np.int64)])
            x = torch.as_tensor(seq, device=server.device)[None]
            rows = slice(b["width"] - 1, b["width"] - 1 + len(out))
            ref = llama.logits(server.params, c, llama.hidden(server.params, c, x, prec)[0, rows], prec)
            widest = max(widest, float(checks.token_gaps(ref, out).max()))
            tokens += len(out)
            for name, lp in lower.items():
                low = llama.logits(server.params, c, llama.hidden(server.params, c, x, lp)[0, rows], lp)
                widest_lower[name] = max(widest_lower[name],
                                         float(checks.token_gaps(ref, low.argmax(-1)).max()))
    out = {"logit_gap": (widest, ctx.cell.limits["logit_gap"])}
    for name, gap in widest_lower.items():
        out[f"{name}_logit_gap"] = (gap, ctx.cell.limits["logit_gap"])
    print(f"r2bench: {len(pick)} requests, {tokens} served tokens checked", flush=True)
    return out


def flash_roofline(events, batches, c: dict, precision: str) -> dict | None:
    """The flash forward's bound and device time over the window: one
    launch a layer of each prefill, q (B, T, KVH, H / KVH, D)."""
    launches = [e for e in events if "flash_fwd" in e[2]]
    L, H, KVH, D = (c["num_hidden_layers"], c["num_attention_heads"],
                    c["num_key_value_heads"], c["head_dim"])
    shapes = [(len(b["requests"]), b["width"]) for b in batches for _ in range(L)]
    if not launches or len(launches) != len(shapes):
        print(f"r2bench: {len(launches)} flash forward launches against {len(shapes)} "
              "calls; flash_fwd_roofline.serve is not read", flush=True)
        return None
    bound = sum(flash_fwd_cost((B, T, KVH, H // KVH, D), (B, T, KVH, D), precision).bound_s()
                for B, T in shapes)
    return {"bound_s": bound, "device_s": sum((b - a) * 1e-9 for a, b, _ in launches)}


def host_label(batches, t0_ns: int):
    """What the driver and the engine were doing at a gap's middle."""
    spans = []
    for b in batches:
        st = b["stamps"]
        spans.append((st[0], st[1], "engine.prefill"))
        for j in range(2, len(st) - 1, 2):
            spans.append((st[j], st[j + 1], "engine.decode_step"))
            if j + 2 < len(st):
                spans.append((st[j + 1], st[j + 2], "engine.between_steps"))
        spans.append((st[-1], st[-1], "engine.after_batch"))

    def label(gap):
        mid = ((gap[0] + gap[1]) / 2 - t0_ns) * 1e-9
        for a, b, name in spans:
            if a <= mid <= b:
                return name
        return "driver.waiting_or_batching"
    return label


def run(ctx: harness.Context) -> dict:
    c, mix = ctx.cell.config, ctx.cell.traffic
    server = Server(ctx)
    reqs = schedule(mix, ctx.seconds)
    prompts = prompts_of(server, reqs)
    server.warm()
    if server.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(server.device)
    setup_s = time.time() - ctx.t_process
    prof = trace.profiler(cpu=False) if ctx.trace else None
    served = serve_window(server, reqs, prompts, ctx.seconds, prof)
    peak = torch.cuda.max_memory_allocated(server.device) if server.device.type == "cuda" else 0
    ttft, tpot = latencies(reqs, served["batches"])
    failed = sum(1 for t in ttft if math.isinf(t))
    out = {"e2e": {"ttft_p90_ms": 1e3 * harness.percentile(ttft, 90),
                   "tpot_p90_ms": 1e3 * harness.percentile(tpot, 90),
                   "setup_s": setup_s},
           "attempted": len(reqs), "failed": failed,
           "device": device_info(server.device, ctx.cell.chips, peak)}
    batches = served["batches"]
    st = [b["stamps"] for b in batches]
    records = {"serve": {
        "prefill_s": [s[1] - s[0] for s in st],
        "decode_s": sum(s[j + 1] - s[j] for s in st for j in range(2, len(s) - 1, 2)),
        "decode_steps": sum((len(s) - 2) // 2 for s in st),
        "ttft_s": ttft,
        "prefill_flops": prefill_flops(c, [r.prompt_len for b in batches for r in b["requests"]]),
    }}
    if ctx.trace:
        lo, hi = served["win0_ns"], served["win1_ns"]
        events = trace.device_events(prof, lo, hi)
        busy_s, gaps = trace.busy([(a, b) for a, b, _ in events], lo, hi)
        window_s = (hi - lo) * 1e-9
        out["device"].update(busy_s=busy_s, window_s=window_s)
        out["breakdown"] = trace.breakdown(trace.by_name(events), gaps, host_label(batches, lo))
        records["serve"].update(busy_s=busy_s, trace_window_s=window_s,
                                flash=flash_roofline(events, batches, c, c["precision"]["products"]))
        del events, prof
    out["records"] = records
    departures = precision_departures(flatten(server.engine.params))
    server.engine = None
    if server.device.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = logit_check(server, ctx, served) if batches else {
        "logit_gap": (math.inf, ctx.cell.limits["logit_gap"])}
    out["checks"]["precision_departures"] = (departures, 0)
    return out
