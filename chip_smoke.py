#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing its own line and raising on failure (exit code != 0):

  1. device  — the card's name, and its name and power limit from nvidia-smi;
  2. build   — every kernel of the serving path, from ``src/repro_torch/
               kernels/csrc/`` (one nvcc per source, all started together);
  3. kernels — each kernel against its plain PyTorch version on the card, at
               the serving path's shapes and at shape / dtype / mask cases,
               plus its time, the plain version's time, one PyTorch library
               call's time as a yardstick, and the card's bound for the work;
  4. serve   — full-width smollm-360m (random fp32 weights from a seed) in the
               port's ServingEngine(strategy="r2ccl"): 4 requests of 512-token
               prompts, 16 new tokens, healthy and with a NIC failure at decode
               step 4; tokens must be identical, launch counts are read around
               the two runs, and prefill logits through the kernel are held
               against the plain attention on the card.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no result.
float32 matmuls run in full float32: TF32 is switched off for matmuls and
cuDNN alike.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12

#: kernels of the serving path: wrapper count key -> where it lives / replaces
KERNELS = {
    "flash_attention": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:96"),
}

ARCH, BATCH, PROMPT, NEW_TOKENS, CONTEXT = "smollm-360m", 4, 512, 16, 1024
FAIL_STEP = 4
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # kernel vs plain
LOGIT_ATOL = 5e-2                                     # model through kernel vs plain


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(q, k, ref, kw) -> tuple[float, str]:
    """Least time for the work: each input read once and the output written
    once at the memory rate, against the matmul operations that this mask
    leaves (4 * D per visible (query, key) pair and query head) at the
    dtype's peak."""
    B, Tq, KVH, G, D = q.shape
    Tk = k.shape[1]
    mask = ref.attention_mask(
        kw.get("q_offset", 0) + torch.arange(Tq), torch.arange(Tk),
        causal=kw.get("causal", True), window=kw.get("window"),
        prefix_len=kw.get("prefix_len"), k_valid_len=kw.get("k_valid_len"),
        k_len=Tk)
    flops = 4.0 * D * int(mask.sum()) * B * KVH * G
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    t_ops, t_bytes = flops / PEAK_FLOPS[q.dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_flash_attention(gen) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    def inputs(B, Tq, Tk, KVH, G, D, dtype):
        q = torch.randn(B, Tq, KVH, G, D, device="cuda", generator=gen).to(dtype)
        k = torch.randn(B, Tk, KVH, D, device="cuda", generator=gen).to(dtype)
        v = torch.randn(B, Tk, KVH, D, device="cuda", generator=gen).to(dtype)
        return q, k, v

    cases = [  # (label, (B, Tq, Tk, KVH, G, D), dtype, kwargs)
        ("smollm-prefill", (BATCH, PROMPT, PROMPT, 5, 3, 64), torch.float32, {}),
        ("paper-7b-heads", (2, 256, 256, 32, 1, 128), torch.float32, {}),
        ("paper-7b-heads", (2, 256, 256, 32, 1, 128), torch.bfloat16, {}),
        ("ragged", (1, 96, 160, 2, 2, 20), torch.float32, {}),
        ("ragged", (1, 96, 160, 2, 2, 20), torch.float32, dict(causal=False)),
        ("window", (1, 128, 128, 2, 1, 16), torch.float32, dict(window=16)),
        ("prefix", (1, 128, 128, 2, 1, 16), torch.float32, dict(prefix_len=8)),
        ("softcap", (1, 128, 128, 2, 1, 16), torch.float32, dict(logit_cap=20.0)),
        ("non-causal", (1, 128, 128, 2, 1, 16), torch.float32, dict(causal=False)),
        ("window+softcap", (1, 128, 128, 2, 1, 16), torch.float32,
         dict(window=32, logit_cap=50.0)),
        ("q_offset/k_valid_len", (2, 16, 200, 2, 4, 32), torch.float32,
         dict(q_offset=100, k_valid_len=150)),
        ("glm4-heads", (1, 64, 64, 2, 16, 128), torch.bfloat16, {}),
    ]
    smollm_err = None
    for label, shape, dtype, kw in cases:
        q, k, v = inputs(*shape, dtype)
        out = flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        want = ref.reference_attention(q, k, v, **kw)
        if not torch.isfinite(out).all():
            raise RuntimeError(f"flash_attention {label}: non-finite output")
        err = (out.float() - want.float()).abs().max().item()
        ok = err <= ATOL[dtype]
        log("kernels", f"flash_attention {label} {shape} {str(dtype)[6:]} {kw} "
            f"max_abs_err={err:.3e} (tol {ATOL[dtype]:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"flash_attention {label}: max_abs_err {err} "
                               f"> {ATOL[dtype]}")
        if smollm_err is None:
            smollm_err = err

    # timing at the serving prefill shape (one layer's attention)
    q, k, v = inputs(BATCH, PROMPT, PROMPT, 5, 3, 64, torch.float32)
    B, T, KVH, G, D = q.shape
    qs = q.reshape(B, T, KVH * G, D).transpose(1, 2)        # (B, H, T, D)
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)            # (B, KVH, T, D)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    got = sdpa(qs, ks, vs, is_causal=True, enable_gqa=True)
    lib_err = (got.transpose(1, 2).reshape(q.shape)
               - ref.reference_attention(q, k, v)).abs().max().item()
    t_kernel = time_ms(lambda: flash_attention_cuda(q, k, v))
    t_plain = time_ms(lambda: ref.reference_attention(q, k, v))
    t_lib = time_ms(lambda: sdpa(qs, ks, vs, is_causal=True, enable_gqa=True))
    t_kernel2 = time_ms(lambda: flash_attention_cuda(q, k, v))
    bound, bound_by = attention_bound(q, k, ref, {})
    log("kernels", f"flash_attention smollm-prefill fp32: kernel {t_kernel:.4f} / "
        f"{t_kernel2:.4f} ms, plain {t_plain:.4f} ms, sdpa {t_lib:.4f} ms "
        f"(sdpa max_abs_err {lib_err:.2e}), bound {bound:.4f} ms ({bound_by})")
    return dict(name="flash_attention", **KERNELS["flash_attention"],
                launches=0, max_abs_err=smollm_err, ms=min(t_kernel, t_kernel2),
                plain_ms=t_plain, bound_ms=bound, bound_by=bound_by,
                library_ms=t_lib)


def serve(card: str) -> dict[str, int]:
    from repro_torch.core.failures import Failure, FailureType
    from repro_torch.kernels import ops
    from repro_torch.models import apply_model, get_config, init_caches, init_model
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log("serve", f"{ARCH}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.attention.num_heads}/{cfg.attention.num_kv_heads} heads, "
        f"{cfg.param_count() / 1e6:.1f}M fp32 params, "
        f"init {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT) for _ in range(BATCH)]

    def requests(new=NEW_TOKENS):
        return [Request(prompt=p, max_new_tokens=new) for p in prompts]

    def engine():
        return ServingEngine(cfg, params, context_len=CONTEXT, strategy="r2ccl",
                             device="cuda")

    engine().run_batch(requests(2))        # warm-up: cuBLAS handles, kernel load
    ops.reset_launch_counts()
    healthy = engine().run_batch(requests())
    failing = engine()
    failed = failing.run_batch(requests(), fail_at_step=FAIL_STEP,
                               failure=Failure(FailureType.NIC_HARDWARE, 1, 0))
    launches = ops.launch_counts()
    prefills = 2

    for r in healthy + failed:
        if len(r.tokens) != NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise RuntimeError(f"bad tokens {r.tokens}")
    if [r.tokens for r in healthy] != [r.tokens for r in failed]:
        raise RuntimeError("tokens differ with the mid-decode NIC failure")
    if failed[0].failovers != 1 or failing.last_recovery is None \
            or not failing.last_recovery.total > 0:
        raise RuntimeError("r2ccl failover not taken through the control plane")
    if launches["flash_attention"] != cfg.num_layers * prefills:
        raise RuntimeError(f"flash_attention launched {launches['flash_attention']} "
                           f"times, want {cfg.num_layers} x {prefills} prefills")
    log("serve", f"tokens identical healthy vs NIC failure at step {FAIL_STEP}; "
        f"failovers={failed[0].failovers}, hiccup {failing.last_recovery.total * 1e3:.4f} ms "
        f"(stages {failing.last_recovery.stages}); launches {launches}")
    log("serve", f"healthy: TTFT {healthy[0].ttft * 1e3:.3f} ms, TPOT "
        f"{healthy[0].tpot * 1e3:.3f} ms; with failure: TTFT {failed[0].ttft * 1e3:.3f} ms, "
        f"TPOT {failed[0].tpot * 1e3:.3f} ms, total {failed[0].total_latency * 1e3:.3f} ms "
        f"[B={BATCH}, prompt {PROMPT}, {NEW_TOKENS} new tokens; {card}]")
    log("serve", f"first tokens of request 0: {healthy[0].tokens[:8]}")

    # prefill logits through the kernel vs the same model with plain attention
    toks = torch.as_tensor(np.stack(prompts), device="cuda")
    with torch.no_grad():
        logits = {impl: apply_model(params, cfg, {"tokens": toks}, mode="prefill",
                                    caches=init_caches(cfg, BATCH, CONTEXT,
                                                       dtype=torch.float32,
                                                       device="cuda"),
                                    attn_impl=impl)[0][:, -1].float()
                  for impl in ("auto", "reference")}
    a, b = logits["auto"], logits["reference"]
    if not (torch.isfinite(a).all() and a.shape == (BATCH, cfg.vocab_size)):
        raise RuntimeError(f"prefill logits: shape {tuple(a.shape)} or non-finite")
    err = (a - b).abs().max().item()
    top2 = b.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > LOGIT_ATOL
    same = a.argmax(-1) == b.argmax(-1)
    if err > LOGIT_ATOL or not bool(same[decided].all()):
        raise RuntimeError(f"prefill logits kernel vs plain: max_abs_err {err}, "
                           f"top-1 equal {same.tolist()} (decided {decided.tolist()})")
    log("serve", f"prefill logits through the kernel vs plain attention: "
        f"max_abs_err={err:.3e} (tol {LOGIT_ATOL}), top-1 equal {same.tolist()}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}: "
              "run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels.build import load_libraries

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    card = nvidia_smi()
    log("device", f"{name}; nvidia-smi: {card}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}; TF32 off (matmul and cuDNN)")

    t0 = time.perf_counter()
    libs = load_libraries(list(KERNELS))
    for n, lib in libs.items():
        regs = [ln.split(":", 1)[1].strip() for ln in lib.log.splitlines()
                if "registers" in ln]
        log("build", f"{n}: nvcc {lib.build_seconds:.2f} s -> {lib.path.name}; "
            f"ptxas: {sorted(set(regs))}")
    log("build", f"all kernels in {time.perf_counter() - t0:.2f} s")

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [check_flash_attention(gen)]
    launches = serve(card)
    for row in rows:
        row["launches"] = launches[row["name"]]
    log("done", f"{time.perf_counter() - t_start:.1f} s in all")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
