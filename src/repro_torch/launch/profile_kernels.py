"""Time the port's redesigned kernels against the PyTorch call that
computes the same function, on the card:

  PYTHONPATH=src python -m repro_torch.launch.profile_kernels [--label L]

* the flash-attention forward at the smollm-360m prefill shape (B=4, T=512,
  KVH=5, G=3, D=64, fp32, causal) and at recurrentgemma-9b's local attention
  (2, 2304, 2304, 1, 16, 256, fp32, window 2048), and at paper-7b's heads
  (2, 256, 256, 32, 1, 128, bf16, causal), against SDPA (the window as a
  boolean mask);
* the flash-attention backward at the smollm-360m training shape (B=2,
  T=512, KVH=5, G=3, D=64, fp32, causal) and at paper-7b's heads (bf16),
  against SDPA's backward;
* ``chunk_combine`` at the largest merge of the training phase ((3,
  13426888) bf16, every row seg=1 acc=1, in place) against in-place
  ``torch.add``;
* ``wkv_scan`` at rwkv6-1.6b's prefill shape (4, 512, 32, 64) and
  ``lru_scan`` at recurrentgemma-9b's (2, 2304, 4096) fp32 with a nonzero
  h0; no single PyTorch call computes either recurrence, so they have no
  library call.  Beside ``lru_scan``, ``torch.mul(a, x, out=h)`` moves the
  same bytes (two fp32 reads and one write an element, contiguous): the
  rate the card reaches on that traffic, not the same function.

Each is timed three ways: CUDA events around 20 back-to-back calls (5 at
recurrentgemma's shape), the device time of each kernel from
``torch.profiler``, and the host's time per call while the card is kept
busy.  The flash forward and ``chunk_combine`` also give the host's time
per call through ``kernels.ops`` (``ops_host_ms``), the path the models and
the collectives take: since the kernels became dispatcher ops
(``kernels/library.py``) it includes the dispatch to the op.  It uses only the wrappers' public signatures, so the same file times
an older checkout's package when that checkout's ``src`` comes first on
``PYTHONPATH`` (run it by path then).  Prints one JSON line, with the card's
name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

TRAIN_SHAPE = (2, 512, 512, 5, 3, 64)
PREFILL_SHAPE = (4, 512, 512, 5, 3, 64)
LOCAL_ATTN_SHAPE, LOCAL_WINDOW = (2, 2304, 2304, 1, 16, 256), 2048
PAPER_7B_SHAPE = (2, 256, 256, 32, 1, 128)
LARGEST_MERGE = (3, 13426888)
WKV_SHAPE = (4, 512, 32, 64)
WKV_TRAIN = (2, 512, 32, 64)
LRU_SHAPE = (2, 2304, 4096)


def events_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, replays: int = 10) -> float:
    """ms a replay of ``fn`` captured as one CUDA graph (after a warm-up
    call on a side stream), by CUDA events over ``replays`` replays: the
    device's time for ``fn``'s launches with no host launch cost between
    them, as a decode step's graph runs them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays


#: marker launches at the head of a profile: once a process has run
#: torch.compile, the profiler drops the first kernel event of each window
#: (seen with torch 2.11 on an H100), and a marker takes that loss
MARKERS = 4


def device_profile(fn, calls: int = 10) -> dict[str, dict]:
    """Per kernel (or memset) that ``fn`` launches, by name: its device ms
    and its launches, each per call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(MARKERS):
            torch.cuda._sleep(1)           # spin_kernel, left out below
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0 and "spin_kernel" not in e.key:
            out[e.key[:80]] = dict(ms=us / calls / 1e3, launches=e.count / calls)
    return out


def device_ms(fn, calls: int = 10) -> dict[str, float]:
    """Mean device ms per call of each kernel ``fn`` launches, by name."""
    return {name: v["ms"] for name, v in device_profile(fn, calls).items()}


def host_ms(fn, calls: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return t


def three_ways(fn, iters: int = 20) -> dict:
    return dict(events_ms=events_ms(fn, iters), device_ms=device_ms(fn), host_ms=host_ms(fn))


def sdpa_forward(q, k, v, kw: dict | None = None):
    """SDPA's forward on the kernel's layout, q (B, Tq, KVH, G, D) and k, v
    (B, Tk, KVH, D), for the flash kernel's keyword arguments ``kw``:
    causal (the default) or not, with GQA; a window or a prefix-LM prefix as
    a boolean mask (with a prefix, K and V expanded to the query heads);
    ``scale`` (None: 1/sqrt(D)).  Returns a callable giving (B, KVH * G, Tq,
    D); differentiable in q, k and v."""
    kw = kw or {}
    B, Tq, KVH, G, D = q.shape
    qs = q.reshape(B, Tq, KVH * G, D).transpose(1, 2)
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    causal, window, prefix = kw.get("causal", True), kw.get("window"), kw.get("prefix_len")
    scale = kw.get("scale")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window is None and prefix is None:
        return lambda: sdpa(qs, ks, vs, is_causal=causal, enable_gqa=True, scale=scale)
    qp = torch.arange(Tq, device=q.device)[:, None]
    kp = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones(Tq, k.shape[1], dtype=torch.bool, device=q.device)
    if causal:
        mask = (kp <= qp) | (kp < prefix) if prefix is not None else kp <= qp
    if window is not None:
        mask = mask & (qp - kp < window)
    if prefix is not None:
        ks, vs = ks.repeat_interleave(G, dim=1), vs.repeat_interleave(G, dim=1)
        return lambda: sdpa(qs, ks, vs, attn_mask=mask, scale=scale)
    return lambda: sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True, scale=scale)


def attention_forward(shape, dtype, gen, window=None, iters=20) -> dict:
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    B, Tq, Tk, KVH, G, D = shape
    q = torch.randn(B, Tq, KVH, G, D, device="cuda", generator=gen).to(dtype)
    k, v = (torch.randn(B, Tk, KVH, D, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    kw = {} if window is None else dict(window=window)
    library = sdpa_forward(q, k, v, kw)
    kernel = lambda: flash_attention_cuda(q, k, v, **kw)
    from repro_torch.kernels import ops
    return dict(shape=shape, dtype=str(dtype)[6:], window=window,
                kernel=three_ways(kernel, iters), sdpa=three_ways(library, iters),
                kernel_again=events_ms(kernel, iters),
                ops_host_ms=host_ms(lambda: ops.flash_attention(q, k, v, **kw)))


def wkv_scan(gen) -> dict:
    from repro_torch.kernels.wkv_scan import wkv_scan_cuda
    B, T, H, K = WKV_SHAPE
    r, k, v = (torch.randn(B, T, H, K, device="cuda", generator=gen) for _ in range(3))
    w = torch.exp(-torch.exp(-6.0 + 2.0 * torch.randn(B, T, H, K, device="cuda",
                                                      generator=gen)))
    u = 0.1 * torch.randn(H, K, device="cuda", generator=gen)
    s0 = torch.randn(B, H, K, K, device="cuda", generator=gen)
    kernel = lambda: wkv_scan_cuda(r, k, v, w, u, s0)
    return dict(shape=WKV_SHAPE, kernel=three_ways(kernel), kernel_again=events_ms(kernel))


def wkv_scan_bwd(gen) -> dict:
    from repro_torch.kernels.wkv_scan import CHUNK, wkv_scan_bwd_cuda, wkv_scan_cuda
    B, T, H, K = WKV_TRAIN
    r, k, v, gy = (torch.randn(B, T, H, K, device="cuda", generator=gen) for _ in range(4))
    w = torch.exp(-torch.exp(-6.0 + 2.0 * torch.randn(B, T, H, K, device="cuda",
                                                      generator=gen)))
    u = 0.1 * torch.randn(H, K, device="cuda", generator=gen)
    s0 = torch.randn(B, H, K, K, device="cuda", generator=gen)
    ckpt = torch.empty((B, H, -(-T // CHUNK), K, K), device="cuda")
    wkv_scan_cuda(r, k, v, w, u, s0, ckpt)
    kernel = lambda: wkv_scan_bwd_cuda(r, k, v, w, u, ckpt, gy, None, want_gs0=False)
    return dict(shape=WKV_TRAIN, kernel=three_ways(kernel), kernel_again=events_ms(kernel))


def lru_scan(gen) -> dict:
    from repro_torch.kernels.lru_scan import lru_scan_cuda
    B, T, W = LRU_SHAPE
    # decays in the model's range: a = u ** r, u in (0.9, 0.999), r in (0, 1)
    a = (0.9 + 0.099 * torch.rand(W, device="cuda", generator=gen)) ** torch.rand(
        B, T, W, device="cuda", generator=gen)
    x = torch.randn(B, T, W, device="cuda", generator=gen)
    h0 = torch.randn(B, W, device="cuda", generator=gen)
    h = torch.empty_like(a)
    kernel = lambda: lru_scan_cuda(a, x, h0)
    same_bytes = lambda: torch.mul(a, x, out=h)
    return dict(shape=LRU_SHAPE, kernel=three_ways(kernel), same_bytes_mul=three_ways(same_bytes),
                kernel_again=events_ms(kernel))


def attention_backward(shape, dtype, gen) -> dict:
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda, flash_attention_cuda
    B, Tq, Tk, KVH, G, D = shape
    q, do = (torch.randn(B, Tq, KVH, G, D, device="cuda", generator=gen).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, Tk, KVH, D, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    lse = torch.empty(B, Tq, KVH, G, device="cuda")
    out = flash_attention_cuda(q, k, v, lse=lse)
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        qr.reshape(B, Tq, KVH * G, D).transpose(1, 2), kr.transpose(1, 2),
        vr.transpose(1, 2), is_causal=True, enable_gqa=True)
    dos = do.reshape(B, Tq, KVH * G, D).transpose(1, 2)
    kernel = lambda: flash_attention_bwd_cuda(q, k, v, out, do, lse)
    library = lambda: torch.autograd.grad(sdpa, (qr, kr, vr), dos, retain_graph=True)
    return dict(shape=shape, dtype=str(dtype)[6:], kernel=three_ways(kernel),
                sdpa_backward=three_ways(library), kernel_again=events_ms(kernel))


def chunk_combine(gen) -> dict:
    from repro_torch.kernels.chunk_combine import chunk_combine_cuda
    rows, M = LARGEST_MERGE
    local = torch.randn(rows, M, device="cuda", generator=gen).to(torch.bfloat16)
    recv = torch.randn(rows, M, device="cuda", generator=gen).to(torch.bfloat16)
    seg = acc = [1] * rows
    kernel = lambda: chunk_combine_cuda(local, recv, seg, acc, out=local)
    library = lambda: torch.add(local, recv, out=local)
    from repro_torch.kernels import ops
    return dict(shape=LARGEST_MERGE, kernel=three_ways(kernel), torch_add=three_ways(library),
                kernel_again=events_ms(kernel), torch_add_again=events_ms(library),
                ops_host_ms=host_ms(lambda: ops.chunk_combine(local, recv, seg, acc,
                                                              out=local)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = dict(label=args.label, card=card,
               forward_prefill=attention_forward(PREFILL_SHAPE, torch.float32, gen),
               forward_local=attention_forward(LOCAL_ATTN_SHAPE, torch.float32, gen,
                                               window=LOCAL_WINDOW, iters=5),
               forward_paper_7b=attention_forward(PAPER_7B_SHAPE, torch.bfloat16, gen),
               wkv_scan=wkv_scan(gen),
               lru_scan=lru_scan(gen),
               backward_train=attention_backward(TRAIN_SHAPE, torch.float32, gen),
               backward_paper_7b=attention_backward(PAPER_7B_SHAPE, torch.bfloat16, gen),
               chunk_combine=chunk_combine(gen),
               wkv_scan_bwd=wkv_scan_bwd(gen))    # last: the rows above draw what they drew
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
