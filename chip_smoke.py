#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing its own lines and seconds, and raising on failure
(exit code != 0):

  1. device  — the card's name, and its name and power limit from nvidia-smi;
  2. build   — every kernel of the serving and training paths, from
               ``src/repro_torch/kernels/csrc/`` (one nvcc per source, all
               started together);
  3. kernels — each kernel against its plain PyTorch version on the card, at
               the main paths' shapes and at shape / dtype / mask cases, plus
               its time, the plain version's time, one PyTorch library call's
               time as a yardstick where one exists, and the card's bound;
  4. serve   — full-width smollm-360m (random fp32 weights from a seed) in the
               port's ServingEngine(strategy="r2ccl"): 4 requests of 512-token
               prompts, 16 new tokens, healthy and with a NIC failure at decode
               step 4; tokens must be identical, launch counts are read around
               the two runs, and prefill logits through the kernel are held
               against the plain attention on the card;
 4b. roofline — the dry run (``launch/dryrun.py``: the step counted on the
               meta device by the kernels' formulas, ``cost_analysis`` at the
               datasheet peaks) against the card: smollm-360m's serve
               prefill and one training rank's step run under
               FlopCounterMode with the kernels live count exactly the meta
               run's FLOPs and launches; TTFT and the step time read at most
               1.05x their bounds; the bytes init_model, init_caches and
               the batch request equal the predicted argument bytes
               (memory_allocated's gain printed beside them, with the
               allocator's rounding); then the bounds of every
               configuration served or trained here.  Every serve phase
               prints its TTFT and TPOT as a share of the dry run's bound;
  5. serve_recurrentgemma — the same for full-width recurrentgemma-9b (38
               layers, 9.4B fp32 params): 2 requests of 2304-token prompts, more
               than the 2048-token local-attention window, so prefill wraps the
               ring buffer; 26 lru_scan and 12 flash_attention launches per
               prefill; prefill logits through the kernels against the plain
               versions of all of them;
  6. serve_rwkv6 — the same for full-width rwkv6-1.6b: 4 requests of
               512-token prompts, 24 wkv_scan launches per prefill;
  7. serve_gemma2, serve_deepseek67b, serve_dbrx — the same for the other
               GQA families at full width and a cut depth (fp32 weights at
               full depth do not fit the card): gemma2-27b, 12 of 46 layers
               (6 local/global pairs, softcap 50), 2 requests of 4352-token
               prompts that wrap the 4096-key window; deepseek-67b, 8 of 95
               layers; dbrx-132b (16 experts, top 4), 4 of 40 layers; one
               flash_attention launch per layer per prefill; for dbrx the
               tokens whose expert set differs between the kernels' and the
               plain versions' prefill are counted and held to a share
               (ROUTE_FLIP_LIMIT), and the logits check pins the plain run
               to the kernels' experts;
  8. serve_deepseekv3 — the same for deepseek-v3-671b at full width and 4
               of 61 layers (3 dense + 1 MoE of 256 experts, top 8, one
               shared; 60.4 GB), its MTP head off (train-only): Multi-head
               Latent Attention, whose prefill runs the flash kernel at head_dim
               192 (128 KV heads of one query) and whose decode attends to the
               latent cache in plain PyTorch; 4 requests of 512-token prompts,
               4 flash_attention launches per prefill, routing flips counted;
  9. serve_paligemma — paligemma-3b at full width and depth (18 layers, fp32
               weights, 10.0 GB): apply_model prefill over 256 image-patch
               embeddings (a bidirectional prefix, the flash kernel's
               prefix-LM mask at head_dim 256) and 256 text tokens, then 15
               greedy decode steps, 4 requests; 18 flash_attention launches a
               prefill, none in decode; tokens and prefill logits held to the
               plain versions; TTFT, TPOT and peak memory printed;
 10. serve_hubert — hubert-xlarge at full width and depth (48 layers, 3.8
               GB): the encoder's forward over 4 clips of 1024 frames (the
               non-causal mask at head_dim 80), 48 flash_attention launches,
               logits held to the plain versions; forward time and peak
               memory printed;
 11. train   — full-width smollm-360m trained data-parallel on 4 ranks, all on
               this card (host-staged gloo wire): one rank's gradients through
               the attention kernels against plain attention; ``sync="xla"``
               against ``sync="r2ccl"`` (degraded rank 1, lost 0.5, g 2) for 4
               steps from one seed; then ``python -m repro_torch.launch.train``
               on a ring, switching at step 2 to the degraded R2CCL program
               after a NIC failure on node 1.  Launch counts are read on rank
               0 around each run and held to the counts the programs, the
               leaves and the layers predict; the step time is split into
               forward+backward, wire, merge and optimizer;
 12. train_frontends — one rank's full-width, full-depth gradients of
               paligemma-3b (the backward kernel at head_dim 256, prefix 256)
               and hubert-xlarge (head_dim 80, non-causal) through the
               kernels against the plain versions; then hubert-xlarge at full
               width and 24 of 48 layers on 4 ranks sharing the card, sync
               r2ccl, a ring switched to the degraded program after a NIC
               failure on node 1 at step 2; the loss must be finite and
               fall, and chunk_combine and both attention kernels run as
               many times as predicted;
 13. train_recurrent — one rank's full-width gradients of recurrentgemma-9b
               at 12 of 38 layers (8 rglru, 4 local_attn: the LRU scan's
               forward and backward kernels, the flash kernels at head_dim
               256) and rwkv6-1.6b at full depth (24 rwkv layers: the WKV
               recurrence's forward, with per-chunk states, and backward
               kernels) through the kernels against the plain versions;
               then rwkv6-1.6b at full width and 8 of 24 layers on 4 ranks
               sharing the card, sync r2ccl, a ring switched to the degraded
               program after a NIC failure on node 1 at step 2; every loss
               and gradient norm finite, the loss falling, the launches as
               planned;
 14. recovery_sim — the framework-free runtime, on a machine with no JAX:
               ``python -m repro_torch.analysis`` (verify + lint) and
               ``cost --corpus`` in process (210 entries, 182 bit-exact); a
               1 GB ring AllReduce on 4 nodes of 4 InfiniBand NICs
               co-simulated through a NIC failure and flaps of node 1, the
               control plane replanning mid-collective with
               score="alpha_beta", then "static", its fp32 payloads equal to
               all_reduce_oracle; chunk_combine against its plain version at
               the swapped-in programs' merge shapes; those two programs
               run on 4 gloo ranks with 16 MiB buffers on the card, every
               round merged by chunk_combine, equal to executor_np, the
               launches as planned; and the training-campaign overhead of
               the paper's 2.7B job across one NIC failure.

The kernels phase checks the two backward kernels of the scans (no Pallas
counterpart) against autograd through the plain versions at the training
shapes and at ragged, T = 1, head-size and hard-decay cases, twice each for
identical bits.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no result.
float32 matmuls run in full float32: TF32 is switched off for matmuls and
cuDNN alike.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"

# Every bound below is a kernel's FLOP and byte formula in
# ``repro_torch.launch.cost_analysis`` at the H100 SXM's datasheet peaks
# there (``H100_SXM``): an attention kernel's products at the tensor cores'
# rate for work of its accuracy (fp32-accurate as 3xTF32, bf16 at the bf16
# rate), with the fp32 CUDA-core rate printed beside it; the scans' work is
# no matrix product and takes the CUDA cores' rate.

#: kernels of the main paths: wrapper count key (and csrc/<key>.cu) ->
#: where it lives / which TPU kernel it replaces
KERNELS = {
    "flash_attention": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:96"),
    "flash_attention_bwd": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/models/layers.py:137",
        note="no Pallas counterpart; replaces jax.grad through blockwise_attention"),
    "chunk_combine": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/chunk_combine.cu",
        replaces="src/repro/kernels/chunk_combine.py:35"),
    "lru_scan": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/lru_scan.cu",
        replaces="src/repro/kernels/lru_scan.py:56"),
    "wkv_scan": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/wkv_scan.cu",
        replaces="src/repro/kernels/wkv_scan.py:59"),
    "lru_scan_bwd": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/lru_scan_bwd.cu",
        replaces="src/repro/models/rglru.py:96",
        note="no Pallas counterpart; replaces jax.grad through lru_scan_ref"),
    "wkv_scan_bwd": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/wkv_scan_bwd.cu",
        replaces="src/repro/models/rwkv6.py:97",
        note="no Pallas counterpart; replaces jax.grad through wkv_scan_ref"),
}
#: the other GQA families, full width at a cut depth: (arch, layers kept,
#: batch, prompt, context, kernel launches per prefill).  gemma2's prompts
#: (4352) exceed its 4096-key window, so its local and global layers differ.
GQA = {
    "serve_gemma2": ("gemma2-27b", 12, 2, 4352, 4608, dict(flash_attention=12)),
    "serve_deepseek67b": ("deepseek-67b", 8, 4, 512, 1024, dict(flash_attention=8)),
    "serve_dbrx": ("dbrx-132b", 4, 4, 512, 1024, dict(flash_attention=4)),
}
#: MLA, full width at a cut depth: as GQA, then the config's fields to
#: override.  deepseek-v3-671b's 4 layers are its 3 dense lead layers and one
#: MoE layer (60.4 GB of fp32 weights; a second MoE layer would need 106 GB).
#: Its MTP head runs in train mode only, and its block, a whole MoE layer,
#: would not fit beside them: mtp=False
MLA_PHASES = {
    "serve_deepseekv3": ("deepseek-v3-671b", 4, 4, 512, 1024, dict(flash_attention=4),
                         dict(mtp=False)),
}
#: the path whose launches each kernel's row reports
MAIN_PATH = {"flash_attention": "serve", "flash_attention_bwd": "train",
             "chunk_combine": "train", "lru_scan": "serve_recurrentgemma",
             "wkv_scan": "serve_rwkv6", "lru_scan_bwd": "train_recurrent",
             "wkv_scan_bwd": "train_recurrent"}
NO_LIBRARY = "no single PyTorch call computes this recurrence"

ARCH, BATCH, PROMPT, NEW_TOKENS, CONTEXT = "smollm-360m", 4, 512, 16, 1024
FAIL_STEP = 4
#: the frontend models at full width and depth: paligemma-3b (18 layers,
#: 10.0 GB of fp32 weights), batch, text tokens after its 256 image patches,
#: new tokens, context; hubert-xlarge (48 layers, 3.8 GB), batch, frames (4
#: clips of about 20 s of audio at HuBERT's 50 frames a second)
PALIGEMMA = ("paligemma-3b", BATCH, 256, NEW_TOKENS, 544)
HUBERT = ("hubert-xlarge", BATCH, 1024)
#: hubert-xlarge's layers in the 4-rank training run (full width): about
#: 8.5 GB a rank of weights, gradients, AdamW moments and the bf16 wire
HUBERT_TRAIN_LAYERS = 24
#: the recurrent families' training: recurrentgemma-9b's gradient check at
#: 12 of 38 layers, 4 groups of (rglru, rglru, local_attn) (3673M params,
#: 14.7 GB of fp32 weights: its 1.05B-parameter embedding alone rules out
#: four ranks on one card); rwkv6-1.6b's 4-rank run at 8 of 24 layers (677M
#: params: at the ~24.5 bytes a parameter a rank of the hubert run, about 66
#: GB for four, where 12 layers would need ~86 GB)
RG_GRAD_LAYERS = 12
RWKV_TRAIN_LAYERS = 8
#: the recurrent serve phases: (arch, batch, prompt, context, kernel
#: launches per prefill); recurrentgemma-9b has 12 groups of (rglru, rglru,
#: local_attn) and a tail of 2 rglru layers
RECURRENT = {
    "serve_recurrentgemma": ("recurrentgemma-9b", 2, 2304, 2560,
                             dict(lru_scan=26, flash_attention=12)),
    "serve_rwkv6": ("rwkv6-1.6b", 4, 512, 1024, dict(wkv_scan=24)),
}
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # kernel vs plain
# prefill logits, model through the kernels vs the plain versions, by serve
# phase, with the config's bf16 residual stream: the gap is bf16 roundings of
# the residual that land differently once a value moves by an ulp (2^-8
# relative), compounded over the layers, and for the recurrent families
# carried along the sequence by the recurrences.  On an H100 it measured
# 0.136 (recurrentgemma-9b, 38 layers) and 0.107 (rwkv6-1.6b, 24 layers),
# top-1 equal, while the float32 run below stayed within 7e-5.  For the
# recurrent phases this bf16 limit is only a guard on the rounding: it is
# too loose to catch a kernel fault, and the float32 check (LOGIT_ATOL_F32)
# is the one that holds the kernels.
# The GQA phases: deepseek-67b (8 plain llama layers) like smollm, with
# room for its wider rows; gemma2-27b's residual is scaled by sqrt(4608) at the embedding, so
# its bf16 ulps are larger; dbrx-132b's router picks its top 4 of 16 experts
# from bf16 activations, and a token whose 4th and 5th expert swap between
# the two paths moves by a whole expert's share.  The float32 check holds
# the kernels in all three.
# deepseek-v3-671b (4 layers, MLA, a top-8-of-256 router on bf16
# activations) as dbrx-132b: the same depth of bf16 residual roundings, and
# the pinned check (routing replayed) measured 2.2e-2 there; the float32
# check holds the kernels.
# paligemma-3b (18 layers), set before its first run: its text embeddings
# are scaled by sqrt(2048) as gemma2's are by sqrt(4608), so the residual's
# bf16 ulps are large, as there.  hubert-xlarge (48 layers, no embedding
# scale, LayerNorm), set before its first run: 1.5x smollm's depth of
# roundings, over all 4096 frames' logits rather than one position a
# request.  The float32 checks hold the kernels in both.
LOGIT_ATOL = {"serve": 5e-2, "serve_recurrentgemma": 0.25, "serve_rwkv6": 0.25,
              "serve_gemma2": 0.25, "serve_deepseek67b": 0.1, "serve_dbrx": 0.25,
              "serve_deepseekv3": 0.25, "serve_paligemma": 0.25, "serve_hubert": 0.25}
# the same with a float32 residual stream, where the gap is the kernels' own
# fp32 error (about 1e-6 relative) carried through the layers
LOGIT_ATOL_F32 = 1e-3
# MoE: the share of (token, layer) pairs whose expert set differs between
# the kernels' and the plain versions' prefill, by phase and residual dtype.
# dbrx-132b: on an H100 it measured 3 of 8192 (3.7e-4) in float32 and 71 of
# 8192 (8.7e-3) in bf16: ties within a rounding.  The limits are a few times
# those, so routing that drifts broadly between the two paths fails the
# phase although the logits check pins the plain run to the kernels' experts.
# deepseek-v3-671b, set before its first run: a flip needs the k-th and
# (k+1)-th router logits closer than the rounding, and near the k-th of N
# unit normals adjacent ones lie about 1 / (N phi(z)) apart, z the (1 - k/N)
# quantile: 0.197 for dbrx (4 of 16, z = 0.67), 0.055 here (8 of 256,
# z = 1.86), 3.5x narrower, so 3.5x the share: about 1.3e-3 in float32 and
# 3e-2 in bf16, over 2048 pairs (one MoE layer).  The limits are a few times
# those, as dbrx's
ROUTE_FLIP_LIMIT = {"serve_dbrx": {"float32": 1e-3, "bfloat16": 2e-2},
                    "serve_deepseekv3": {"float32": 5e-3, "bfloat16": 0.1}}
# scans vs their plain versions, relative to max(1, max |value|): both run
# the recurrence in fp32 in time order, the kernels with fused multiply-adds
# and (wkv) the sum over k in another order
SCAN_RTOL = 1e-5
# the scans' backward kernels vs autograd through the plain versions,
# relative to max(1, max |gradient|): the CPU block gradient tests' bound (a
# gradient sums over the T steps of the reverse recurrence, gu over B and T)
SCAN_BWD_RTOL = 1e-4
# the recurrent families' training shape: one rank's LOCAL_BATCH sequences
# of SEQ tokens; recurrentgemma-9b's LRU width, rwkv6-1.6b's 32 heads of 64
LRU_TRAIN = (2, 512, 4096)
WKV_TRAIN = (2, 512, 32, 64)
# one recurrentgemma-9b local_attn layer in prefill: (B, Tq, Tk, KVH, G, D)
RG_ATTN, RG_WINDOW = (2, 2304, 2304, 1, 16, 256), 2048
# one gemma2-27b layer in prefill: 16 KV heads of 2 queries at head_dim 128,
# softcap 50; the local layers' window, the global layers' none
G2_ATTN, G2_WINDOW, G2_CAP = (2, 4352, 4352, 16, 2, 128), 4096, 50.0
# one deepseek-v3-671b MLA layer in prefill: 128 KV heads of one query at
# head_dim 192 (qk_nope 128 + qk_rope 64), v padded from 128 to 192 as the
# model pads it, scale 1/sqrt(192) passed explicitly
MLA_ATTN, MLA_V = (BATCH, PROMPT, PROMPT, 128, 1, 192), 128
MLA_SCALE = 192 ** -0.5
# one paligemma-3b layer in prefill: MQA, 8 query heads of 256 on one KV
# head, 256 image patches (a bidirectional prefix) and 256 text tokens; one
# hubert-xlarge layer: 16 heads of 80, non-causal, 1024 frames (about 20 s
# of audio at HuBERT's 50 frames a second)
PG_ATTN, PG_PREFIX = (BATCH, 512, 512, 1, 8, 256), 256
HB_ATTN = (BATCH, 1024, 1024, 16, 1, 80)
# its library yardstick is flex_attention compiled (a softcap score_mod, a
# causal window block mask, GQA): SDPA has no logit softcap.  Its error
# against the plain version is held to FLEX_ATOL, a guard that it computes
# the same function (a TF32 product would err by about 1e-3, a wrong mask or
# cap by O(1))
FLEX_ATOL = 1e-2
# the training shapes of one layer's attention backward (B = LOCAL_BATCH
# sequences of SEQ): paligemma-3b (256 patches + 256 text tokens), hubert-
# xlarge; deepseek-v3's MLA at its serving batch of 4
PG_TRAIN = (2, 512, 512, 1, 8, 256)
HB_TRAIN = (2, 512, 512, 16, 1, 80)
MLA_TRAIN = MLA_ATTN
# backward kernel vs autograd through the plain version, relative to
# max(1, max |gradient|): a dK entry sums over up to Tq * G query rows
BWD_RTOL = {torch.float32: 1e-3, torch.bfloat16: 3e-2}

# training phase: 4 ranks x (2 sequences of 512 tokens) on this card
WORLD, LOCAL_BATCH, SEQ, TRAIN_STEPS, FAIL_AT = 4, 2, 512, 4, 2
PARITY_TOL = 5e-3          # xla vs r2ccl sync, loss and params (bf16 wire)
# step 0's synced gradients, r2ccl (bf16 wire) vs xla (fp32), per leaf
# ||g_r2ccl - g_xla|| / ||g_xla||: a bf16 rounding errs by at most 2^-8 = 3.9e-3
# relative, a gradient takes a few of them (the cast, each partial sum), and
# the partial sums of gradients that cancel across ranks are larger than the
# mean; 2e-2 is about five roundings, where a lost or unsummed contribution
# reads of the order of 1
SYNC_GRAD_TOL = 2e-2
# full-width loss and per-leaf ||g_kernel - g_plain|| / ||g_plain||, attention
# kernels vs plain, by the dtype of the residual stream.  With float32 the
# gap is the kernels' own error; with the config's bfloat16 it is dominated
# by bf16 roundings of the residual stream that land differently once any
# value moves by an ulp, compounded over 32 layers into the first layers'
# gradients (the first chip run measured 2.35e-2 there)
GRAD_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (2e-3, 5e-2)}
# rwkv6-1.6b at 24 layers with the bf16 residual stream is chaotic: on an
# H100 the kernels-vs-plain gap read 0.354 (leaf u), and the plain path
# against itself with only the WKV scan computed in float64 moved every
# block leaf's gradient by 9.8-28.5% (u the most), so no implementation that
# rounds differently can meet GRAD_TOL there.  Its bf16 check pins the plain
# run's scans to the kernels' forward values (the backward kernel against
# autograd through the plain recurrence, on the same residual stream) under
# GRAD_TOL, and holds the unpinned gap to a few times the plain path's own
# gap under a float64 scan, measured in the same run (set before its first
# run: two perturbations of one size land within 2x of each other; the
# first run read 1.24x)
BF16_PINNED = {"rwkv6-1.6b"}
BF16_UNPINNED_FACTOR = 4.0
R2CCL_COMM = dict(mode="r2ccl", degraded_rank=1, lost_fraction=0.5,
                  devices_per_node=2)
CLI_NICS = 2               # NICs a node in the CLI failover run


def counts(**nonzero) -> dict[str, int]:
    """Launch counts as ``ops.launch_counts()`` reports them: every kernel,
    0 unless given."""
    return {name: nonzero.get(name, 0) for name in KERNELS}


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


def attention_bound(q, k, kw, backward: bool = False) -> dict:
    """Least time for the work, by the flash kernels' formulas
    (``cost_analysis.flash_fwd_cost``, ``flash_bwd_cost``: the visible
    (query, key) pairs of this mask, in closed form): the larger of the
    products at the tensor cores' peak for the dtype and the bytes (each
    input read once, each output written once) at the memory rate, with
    the peak named; for fp32 also the same at the CUDA cores' rate."""
    from repro_torch.launch import cost_analysis as CA
    mask = dict(causal=kw.get("causal", True), window=kw.get("window"),
                prefix_len=kw.get("prefix_len"))
    if backward:
        cost = CA.flash_bwd_cost(q.shape, k.shape, q.dtype, **mask)
    else:
        cost = CA.flash_fwd_cost(q.shape, k.shape, q.dtype, q_offset=kw.get("q_offset", 0),
                                 k_valid_len=kw.get("k_valid_len"), **mask)
    out = cost.bound()
    if q.dtype == torch.float32:
        out["bound_ms_fp32_cuda_cores"] = dataclasses.replace(cost, peak="fp32").bound()[
            "bound_ms"]
    return out


def bound_text(b: dict) -> str:
    from repro_torch.launch.cost_analysis import H100_SXM
    text = (f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}; {b['gflop']:.3f} GFLOP, "
            f"{b['bound_peak']}: {b['ops_ms']:.4f} ms; {b['mbytes']:.1f} MB at "
            f"{H100_SXM.hbm_bw / 1e12:g} TB/s: {b['bytes_ms']:.4f} ms)")
    if "bound_ms_fp32_cuda_cores" in b:
        text += (f", fp32 on the CUDA cores at {H100_SXM.peak_flops['fp32'] / 1e12:g} "
                 f"TFLOP/s {b['bound_ms_fp32_cuda_cores']:.4f} ms")
    return text


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
        ("recurrentgemma-local", RG_ATTN, torch.float32, dict(window=RG_WINDOW)),
        ("gemma2-local", G2_ATTN, torch.float32, dict(window=G2_WINDOW, logit_cap=G2_CAP)),
        ("gemma2-global", G2_ATTN, torch.float32, dict(logit_cap=G2_CAP)),
        ("D=256 ragged", (1, 70, 70, 1, 16, 256), torch.float32, dict(window=33)),
        # the tiles' edges: one position a CTA (G = 64), hubert's head_dim 80,
        # lengths off every row and key tile, window and prefix at both tile
        # shapes, bf16 at head_dim 256
        ("G=64", (2, 37, 53, 2, 64, 32), torch.float32, {}),
        ("G=64 bf16", (1, 19, 19, 1, 64, 128), torch.bfloat16, dict(window=7)),
        ("D=80", (2, 100, 100, 2, 4, 80), torch.float32, dict(causal=False)),
        ("D=80 bf16", (2, 100, 100, 2, 4, 80), torch.bfloat16, {}),
        ("off the tiles", (1, 97, 131, 3, 3, 64), torch.float32, dict(window=50)),
        ("off the tiles", (2, 131, 97, 1, 5, 128), torch.float32, dict(prefix_len=40)),
        ("D=256 window+prefix", (1, 300, 300, 1, 16, 256), torch.float32,
         dict(window=64, prefix_len=20)),
        ("D=256 bf16", (1, 300, 300, 1, 16, 256), torch.bfloat16, dict(window=200)),
        # deepseek-v3's MLA prefill at head_dim 192 on the 256-wide template,
        # and off the row and key tiles
        ("mla-prefill", MLA_ATTN, torch.float32, dict(scale=MLA_SCALE)),
        ("mla-prefill", MLA_ATTN, torch.bfloat16, dict(scale=MLA_SCALE)),
        ("D=192 off the tiles", (1, 97, 131, 3, 1, 192), torch.float32, {}),
        # the frontends' prefills: paligemma-3b's 256 image patches as a
        # bidirectional prefix (MQA, 8 heads of 256), hubert-xlarge's
        # non-causal encoder (16 heads of 80)
        ("paligemma-prefill", PG_ATTN, torch.float32, dict(prefix_len=PG_PREFIX)),
        ("paligemma-prefill", PG_ATTN, torch.bfloat16, dict(prefix_len=PG_PREFIX)),
        ("hubert-encoder", HB_ATTN, torch.float32, dict(causal=False)),
        ("hubert-encoder", HB_ATTN, torch.bfloat16, dict(causal=False)),
    ]
    smollm_err = rg_err = g2_err = mla_err = None
    errs = {}
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
        if label == "recurrentgemma-local":
            rg_err = err
        if label == "gemma2-local":
            g2_err = err
        if label == "mla-prefill" and dtype == torch.float32:
            mla_err = err
        if dtype == torch.float32:
            errs.setdefault(label, err)
        del q, k, v, out, want

    # two calls on the same inputs give the same bits, output and lse (no
    # cross-CTA sums)
    for shape, dtype, kw in (((BATCH, PROMPT, PROMPT, 5, 3, 64), torch.float32, {}),
                             ((1, 300, 300, 1, 16, 256), torch.float32, dict(window=64))):
        q, k, v = inputs(*shape, dtype)
        lse = [torch.empty(shape[0], shape[1], shape[3], shape[4], device="cuda")
               for _ in range(2)]
        outs = [flash_attention_cuda(q, k, v, lse=lse[i], **kw) for i in range(2)]
        if not (torch.equal(outs[0], outs[1]) and torch.equal(lse[0], lse[1])):
            raise RuntimeError(f"flash_attention {shape}: two calls on the same inputs differ")
    log("kernels", "flash_attention: two calls on the same inputs give the same output "
        "and lse, bit for bit")
    del q, k, v, outs, lse

    rg = time_local_attention(gen, ref, flash_attention_cuda)
    g2 = time_gemma2_attention(gen, ref, flash_attention_cuda)
    mla = time_mla_attention(gen, ref, flash_attention_cuda)

    # timing at the serving prefill shape (one layer's attention), fp32, at
    # paper-7b's heads in bf16, and at the frontends' prefills in fp32, each
    # against SDPA (causal with GQA; paligemma's prefix as a boolean mask
    # with K and V expanded to its 8 heads; hubert non-causal)
    timed = {}
    for label, shape, dtype, kw in (
            ("smollm-prefill", (BATCH, PROMPT, PROMPT, 5, 3, 64), torch.float32, {}),
            ("paper-7b-heads", (2, 256, 256, 32, 1, 128), torch.bfloat16, {}),
            ("paligemma-prefill", PG_ATTN, torch.float32, dict(prefix_len=PG_PREFIX)),
            ("hubert-encoder", HB_ATTN, torch.float32, dict(causal=False))):
        q, k, v = inputs(*shape, dtype)
        timed[label] = time_forward(q, k, v, ref, flash_attention_cuda, kw, iters=20)
        t = timed[label]
        log("kernels", f"flash_attention {label} {shape} {str(dtype)[6:]} {kw}: kernel "
            f"{t['ms']:.4f} / {t['ms_again']:.4f} ms, plain {t['plain_ms']:.4f} ms, sdpa "
            f"{t['library_ms']:.4f} ms (sdpa max_abs_err vs the plain version "
            f"{t['library_err']:.2e}), {bound_text(t)}, {t['bound_ms'] / t['ms']:.1%} of it")
        log("kernels", f"flash_attention {label}, device time per call (torch.profiler): "
            f"kernel {fmt_ms(t['device_ms'])}, sdpa's kernels {fmt_ms(t['library_device_ms'])}")
    main = timed["smollm-prefill"]
    return dict(name="flash_attention", **KERNELS["flash_attention"],
                launches=0, max_abs_err=smollm_err, **main,
                recurrentgemma=dict(shape=RG_ATTN, max_abs_err=rg_err, **rg),
                gemma2=dict(shape=G2_ATTN, max_abs_err=g2_err, **g2),
                mla=dict(shape=MLA_ATTN, max_abs_err=mla_err, **mla),
                paper_7b_bf16=timed["paper-7b-heads"],
                paligemma=dict(shape=PG_ATTN, max_abs_err=errs["paligemma-prefill"],
                               **timed["paligemma-prefill"]),
                hubert=dict(shape=HB_ATTN, max_abs_err=errs["hubert-encoder"],
                            **timed["hubert-encoder"]))


def fmt_ms(t: float | None) -> str:
    return "not measured (no device time in the profile)" if t is None else f"{t:.4f} ms"


def time_forward(q, k, v, ref, flash_attention_cuda, kw, iters, plain_iters=None) -> dict:
    """One attention forward at (q, k, v): the kernel (twice, around the
    others), the plain version and SDPA (causal or not, with GQA; a window
    or a prefix as a boolean mask, K and V expanded to the query heads with
    a prefix) by CUDA events, the kernel's and SDPA's device time per call
    (torch.profiler), and the bound."""
    from repro_torch.launch.profile_kernels import device_ms, sdpa_forward
    library = sdpa_forward(q, k, v, kw)
    kernel = lambda: flash_attention_cuda(q, k, v, **kw)
    lib_err = (library().transpose(1, 2).reshape(q.shape).float()
               - ref.reference_attention(q, k, v, **kw).float()).abs().max().item()
    t_kernel = time_ms(kernel, iters=iters)
    t_plain = time_ms(lambda: ref.reference_attention(q, k, v, **kw),
                      iters=plain_iters or iters, warmup=1 if plain_iters else 3)
    t_lib = time_ms(library, iters=iters)
    t_kernel2 = time_ms(kernel, iters=iters)
    dev = sum(device_ms(kernel).values()) or None
    lib_dev = sum(device_ms(library).values()) or None
    return dict(ms=min(t_kernel, t_kernel2), ms_again=max(t_kernel, t_kernel2),
                plain_ms=t_plain, **attention_bound(q, k, kw), library_ms=t_lib,
                library_err=lib_err, device_ms=dev, library_device_ms=lib_dev)


def time_local_attention(gen, ref, flash_attention_cuda) -> dict:
    """One recurrentgemma-9b local_attn layer's prefill attention (MQA,
    16 query heads of 256, window 2048, fp32): kernel, plain version and
    SDPA with the window as a boolean mask, against the bound."""
    B, T, KVH, G, D = RG_ATTN[0], RG_ATTN[1], *RG_ATTN[3:]
    q = torch.randn(B, T, KVH, G, D, device="cuda", generator=gen)
    k = torch.randn(B, T, KVH, D, device="cuda", generator=gen)
    v = torch.randn(B, T, KVH, D, device="cuda", generator=gen)
    t = time_forward(q, k, v, ref, flash_attention_cuda, dict(window=RG_WINDOW), iters=5,
                     plain_iters=3)
    log("kernels", f"flash_attention recurrentgemma-local {RG_ATTN} fp32 window "
        f"{RG_WINDOW}: kernel {t['ms']:.4f} / {t['ms_again']:.4f} ms, plain {t['plain_ms']:.4f} "
        f"ms, sdpa (boolean mask) {t['library_ms']:.4f} ms (its max_abs_err vs the plain "
        f"version {t['library_err']:.2e}), {bound_text(t)}")
    log("kernels", f"flash_attention recurrentgemma-local, device time per call "
        f"(torch.profiler): kernel {fmt_ms(t['device_ms'])}, sdpa's kernels "
        f"{fmt_ms(t['library_device_ms'])}")
    return t


def time_mla_attention(gen, ref, flash_attention_cuda) -> dict:
    """One deepseek-v3-671b MLA layer's prefill attention (128 KV heads of
    one query at head_dim 192, v's last 64 columns zero as the model pads
    them, scale 1/sqrt(192), fp32): kernel, plain version and SDPA on the
    same q, k, v and scale, against the bound."""
    B, T, KVH, G, D = MLA_ATTN[0], MLA_ATTN[1], *MLA_ATTN[3:]
    q = torch.randn(B, T, KVH, G, D, device="cuda", generator=gen)
    k = torch.randn(B, T, KVH, D, device="cuda", generator=gen)
    v = torch.nn.functional.pad(
        torch.randn(B, T, KVH, MLA_V, device="cuda", generator=gen), (0, D - MLA_V))
    t = time_forward(q, k, v, ref, flash_attention_cuda, dict(scale=MLA_SCALE), iters=10,
                     plain_iters=3)
    log("kernels", f"flash_attention mla-prefill {MLA_ATTN} fp32 (v {MLA_V} padded to {D}, "
        f"scale 1/sqrt({D})): kernel {t['ms']:.4f} / {t['ms_again']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms (its max_abs_err vs the "
        f"plain version {t['library_err']:.2e}), {bound_text(t)}, "
        f"{t['bound_ms'] / t['ms']:.1%} of it")
    log("kernels", f"flash_attention mla-prefill, device time per call (torch.profiler): "
        f"kernel {fmt_ms(t['device_ms'])}, sdpa's kernels {fmt_ms(t['library_device_ms'])}")
    return t


def flex_forward(q, k, v, window: int, cap: float):
    """flex_attention's forward on the kernel's layout, q (B, T, KVH, G, D)
    and k, v (B, T, KVH, D): causal within ``window`` keys, logits capped
    at ``cap``, GQA, compiled by torch.compile.  Returns a callable giving
    (B, KVH * G, T, D)."""
    import torch._inductor.config as inductor_config
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention
    # inductor's and Triton's caches in the checkout's build directory, and
    # no compile worker processes
    cache = REPO / "build" / "torch_compile"
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(cache / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    inductor_config.compile_threads = 1
    B, T, KVH, G, D = q.shape
    qs = q.permute(0, 2, 3, 1, 4).reshape(B, KVH * G, T, D)
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)

    def softcap(score, b, h, q_idx, k_idx):
        return torch.tanh(score / cap) * cap

    def local(b, h, q_idx, k_idx):
        return (k_idx <= q_idx) & (q_idx - k_idx < window)

    mask = create_block_mask(local, None, None, T, T, device=q.device)
    flex = torch.compile(flex_attention, dynamic=False)
    return lambda: flex(qs, ks, vs, score_mod=softcap, block_mask=mask, enable_gqa=True)


def time_gemma2_attention(gen, ref, flash_attention_cuda) -> dict:
    """One gemma2-27b local layer's prefill attention (16 KV heads of 2
    queries at head_dim 128, window 4096, softcap 50, fp32): kernel by
    events (twice, around the others), the plain version and compiled
    flex_attention, the kernel's and flex's device time, against the
    bound."""
    from repro_torch.launch.profile_kernels import device_ms
    B, T, KVH, G, D = G2_ATTN[0], G2_ATTN[1], *G2_ATTN[3:]
    q = torch.randn(B, T, KVH, G, D, device="cuda", generator=gen)
    k = torch.randn(B, T, KVH, D, device="cuda", generator=gen)
    v = torch.randn(B, T, KVH, D, device="cuda", generator=gen)
    kw = dict(window=G2_WINDOW, logit_cap=G2_CAP)
    kernel = lambda: flash_attention_cuda(q, k, v, **kw)
    t0 = time.perf_counter()
    library = flex_forward(q, k, v, G2_WINDOW, G2_CAP)
    got = library()
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    if not torch.isfinite(got).all():
        raise RuntimeError("flex_attention gemma2-local: non-finite output")
    lib_err = (got.reshape(B, KVH, G, T, D).permute(0, 3, 1, 2, 4)
               - ref.reference_attention(q, k, v, **kw)).abs().max().item()
    if lib_err > FLEX_ATOL:
        raise RuntimeError(f"flex_attention gemma2-local: max_abs_err {lib_err} against "
                           f"the plain version > {FLEX_ATOL}")
    del got
    t_kernel = time_ms(kernel, iters=10)
    t_plain = time_ms(lambda: ref.reference_attention(q, k, v, **kw), iters=3, warmup=1)
    t_lib = time_ms(library, iters=10)
    t_kernel2 = time_ms(kernel, iters=10)
    t = dict(ms=min(t_kernel, t_kernel2), ms_again=max(t_kernel, t_kernel2),
             plain_ms=t_plain, **attention_bound(q, k, kw), library_ms=t_lib,
             library_err=lib_err, library_note="flex_attention, torch.compile",
             device_ms=sum(device_ms(kernel).values()) or None,
             library_device_ms=sum(device_ms(library).values()) or None)
    log("kernels", f"flash_attention gemma2-local {G2_ATTN} fp32 window {G2_WINDOW} "
        f"softcap {G2_CAP}: kernel {t['ms']:.4f} / {t['ms_again']:.4f} ms, plain "
        f"{t_plain:.4f} ms, flex_attention compiled {t_lib:.4f} ms (compile and first "
        f"call {compile_s:.1f} s; its max_abs_err vs the plain version {lib_err:.2e}; "
        f"SDPA has no logit softcap), {bound_text(t)}")
    log("kernels", f"flash_attention gemma2-local, device time per call (torch.profiler): "
        f"kernel {fmt_ms(t['device_ms'])}, flex_attention's kernels "
        f"{fmt_ms(t['library_device_ms'])}")
    return t


def check_flash_attention_bwd(gen) -> dict:
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)

    def inputs(B, Tq, Tk, KVH, G, D, dtype):
        q = torch.randn(B, Tq, KVH, G, D, device="cuda", generator=gen).to(dtype)
        k = torch.randn(B, Tk, KVH, D, device="cuda", generator=gen).to(dtype)
        v = torch.randn(B, Tk, KVH, D, device="cuda", generator=gen).to(dtype)
        do = torch.randn(B, Tq, KVH, G, D, device="cuda", generator=gen).to(dtype)
        return q, k, v, do

    def kernel(q, k, v, do, kw):
        B, Tq, KVH, G, _ = q.shape
        lse = torch.empty(B, Tq, KVH, G, device="cuda")
        out = flash_attention_cuda(q, k, v, lse=lse, **kw)
        return out, lse, flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)

    def plain(q, k, v, do, kw):
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        return torch.autograd.grad(ref.reference_attention(qr, kr, vr, **kw),
                                   (qr, kr, vr), do)

    train_shape = (LOCAL_BATCH, SEQ, SEQ, 5, 3, 64)
    cases = [  # (label, (B, Tq, Tk, KVH, G, D), dtype, kwargs)
        ("smollm-train", train_shape, torch.float32, {}),
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
        ("glm4-heads", (1, 64, 64, 2, 16, 128), torch.bfloat16, {}),
        # above head_dim 128 (warp pairs split the columns): the frontends'
        # training shapes, MLA's with its scale, D = 192 and 256 off the
        # tiles with a window and softcap, a prefix, bf16
        ("paligemma-train", PG_TRAIN, torch.float32, dict(prefix_len=PG_PREFIX)),
        ("paligemma-train", PG_TRAIN, torch.bfloat16, dict(prefix_len=PG_PREFIX)),
        ("hubert-train", HB_TRAIN, torch.float32, dict(causal=False)),
        ("mla-train", MLA_TRAIN, torch.float32, dict(scale=MLA_SCALE)),
        ("D=256 off the tiles", (1, 97, 131, 3, 2, 256), torch.float32,
         dict(window=40, logit_cap=30.0)),
        ("D=192 off the tiles", (1, 97, 131, 3, 2, 192), torch.float32,
         dict(window=40, logit_cap=30.0)),
        ("D=256 prefix", (1, 128, 128, 2, 1, 256), torch.float32, dict(prefix_len=40)),
        ("D=256 bf16", (1, 97, 131, 3, 2, 256), torch.bfloat16, dict(causal=False)),
    ]
    train_err = None             # (max_abs_err, max_rel_err) at the training shape
    rel_errs = {}                # fp32 max_rel_err by label
    for label, shape, dtype, kw in cases:
        q, k, v, do = inputs(*shape, dtype)
        _, _, got = kernel(q, k, v, do, kw)
        torch.cuda.synchronize()
        want = plain(q, k, v, do, kw)
        err = rel = 0.0
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            if not torch.isfinite(a).all():
                raise RuntimeError(f"flash_attention_bwd {label}: non-finite {name}")
            e = (a.float() - b.float()).abs().max().item()
            err = max(err, e)
            rel = max(rel, e / max(1.0, b.float().abs().max().item()))
        ok = rel <= BWD_RTOL[dtype]
        log("kernels", f"flash_attention_bwd {label} {shape} {str(dtype)[6:]} {kw} "
            f"max_abs_err={err:.3e}, max_rel_err={rel:.3e} (tol {BWD_RTOL[dtype]:g} "
            f"of max(1, max|grad|)) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"flash_attention_bwd {label}: max_rel_err {rel} "
                               f"> {BWD_RTOL[dtype]}")
        if train_err is None:
            train_err = (err, rel)
        if dtype == torch.float32:
            rel_errs.setdefault(label, rel)
        del q, k, v, do, got, want

    # the autograd.Function that the model calls gives the same gradients
    q, k, v, do = inputs(*train_shape, torch.float32)
    _, _, direct = kernel(q, k, v, do, {})
    qa, ka, va = (t.detach().requires_grad_() for t in (q, k, v))
    via = torch.autograd.grad(ops.flash_attention(qa, ka, va), (qa, ka, va), do)
    if any(not torch.equal(a, b) for a, b in zip(direct, via)):
        raise RuntimeError("ops.flash_attention's backward differs from the kernel's")

    # two calls on the same inputs give the same bits (no atomics), at D = 64
    # and at paligemma's D = 256 (the column halves' exchange)
    _, _, again = kernel(q, k, v, do, {})
    if any(not torch.equal(a, b) for a, b in zip(direct, again)):
        raise RuntimeError("flash_attention_bwd: two calls on the same inputs differ")
    pg = inputs(*PG_TRAIN, torch.float32)
    pg_kw = dict(prefix_len=PG_PREFIX)
    first, second = kernel(*pg, pg_kw)[2], kernel(*pg, pg_kw)[2]
    if any(not torch.equal(a, b) for a, b in zip(first, second)):
        raise RuntimeError("flash_attention_bwd paligemma-train: two calls on the same "
                           "inputs differ")
    log("kernels", "flash_attention_bwd smollm-train: ops.flash_attention's gradients "
        "equal the direct call's, and a second call's, bit for bit; paligemma-train "
        "(D = 256): two calls give the same bits")
    del pg, first, second, direct, again, via

    # timing at the training shapes (one layer's attention backward): smollm,
    # paper-7b's heads in bf16, and above head_dim 128 paligemma (prefix
    # 256), MLA (head_dim 192, its scale) and hubert (non-causal, head_dim 80)
    timed = {}
    for label, shape, dtype, kw in (
            ("smollm-train", train_shape, torch.float32, {}),
            ("paper-7b-heads", (2, 256, 256, 32, 1, 128), torch.bfloat16, {}),
            ("paligemma-train", PG_TRAIN, torch.float32, dict(prefix_len=PG_PREFIX)),
            ("hubert-train", HB_TRAIN, torch.float32, dict(causal=False)),
            ("mla-train", MLA_TRAIN, torch.float32, dict(scale=MLA_SCALE))):
        t = timed[label] = time_backward(inputs(*shape, dtype), kw, kernel, ref)
        passes = t["passes_ms"]
        log("kernels", f"flash_attention_bwd {label} {shape} {str(dtype)[6:]} {kw}: kernel "
            f"{t['ms']:.4f} / {t['ms_again']:.4f} ms, plain {t['plain_ms']:.4f} ms, sdpa "
            f"backward {t['library_ms']:.4f} ms, {bound_text(t)}, "
            f"{t['bound_ms'] / t['ms']:.1%} of it")
        log("kernels", f"flash_attention_bwd {label}, device time per call by pass "
            f"(torch.profiler): " + (", ".join(f"{n} {x:.4f} ms" for n, x in passes.items())
                                     or "not measured (no device time in the profile)")
            + f"; in all {sum(passes.values()):.4f} ms; sdpa backward's kernels "
            f"{fmt_ms(t['library_device_ms'])}")
    main = timed.pop("smollm-train")
    return dict(name="flash_attention_bwd", **KERNELS["flash_attention_bwd"],
                launches=0, max_abs_err=train_err[0], max_rel_err=train_err[1], **main,
                paper_7b_bf16=timed["paper-7b-heads"],
                paligemma=dict(shape=PG_TRAIN, max_rel_err=rel_errs["paligemma-train"],
                               **timed["paligemma-train"]),
                hubert=dict(shape=HB_TRAIN, max_rel_err=rel_errs["hubert-train"],
                            **timed["hubert-train"]),
                mla=dict(shape=MLA_TRAIN, max_rel_err=rel_errs["mla-train"],
                         **timed["mla-train"]))


def time_backward(inputs, kw, kernel, ref) -> dict:
    """One attention backward at (q, k, v, dO): the kernel (twice, around the
    others), autograd through the plain version and SDPA's backward (the
    same masks as ``time_forward``'s SDPA, fp32 with TF32 off or bf16) by CUDA
    events, the kernel's device time per pass and SDPA backward's kernels'
    (torch.profiler), and the bound."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    from repro_torch.launch.profile_kernels import device_ms, sdpa_forward
    q, k, v, do = inputs
    out, lse, _ = kernel(q, k, v, do, kw)
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    ref_out = ref.reference_attention(qr, kr, vr, **kw)
    sdpa_out = sdpa_forward(qr, kr, vr, kw)()
    B, Tq, KVH, G, D = q.shape
    dos = do.reshape(B, Tq, KVH * G, D).transpose(1, 2)
    bwd = lambda: flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
    library = lambda: torch.autograd.grad(sdpa_out, (qr, kr, vr), dos, retain_graph=True)
    t_kernel = time_ms(bwd, iters=10)
    t_plain = time_ms(lambda: torch.autograd.grad(ref_out, (qr, kr, vr), do,
                                                  retain_graph=True), iters=3, warmup=1)
    t_lib = time_ms(library, iters=10)
    t_kernel2 = time_ms(bwd, iters=10)
    passes = {bwd_pass(n): t for n, t in device_ms(bwd).items()}
    return dict(ms=min(t_kernel, t_kernel2), ms_again=max(t_kernel, t_kernel2),
                plain_ms=t_plain, **attention_bound(q, k, kw, backward=True),
                library_ms=t_lib, passes_ms=passes,
                library_device_ms=sum(device_ms(library).values()) or None)


def bwd_pass(kernel_name: str) -> str:
    """The backward's pass a profiled kernel name belongs to."""
    for short in ("bwd_preprocess", "bwd_dkdv", "bwd_dq"):
        if short in kernel_name:
            return short
    return kernel_name[:60]


def train_comms() -> dict:
    """The collective programs the training phases run, as ``CommConfig``s:
    the parity run's, and the CLI run's ring and the degraded program it
    switches to (the hubert-xlarge run takes the same two).  The CLI run has 2 NICs a node, so the
    failed NIC takes half the node's bandwidth (``launch/train.py``: lost
    fraction max(1/2, 0.34), g = 2) and the planner splits the payload
    between a ring and the partial AllReduce; with 8 NICs a node (lost 0.34)
    it would keep the plain ring."""
    from repro_torch.configs.base import CommConfig
    return {"parity": CommConfig(**R2CCL_COMM),
            "ring": CommConfig(mode="ring"),
            "degraded": CommConfig(mode="r2ccl", degraded_rank=1, lost_fraction=0.5,
                                   devices_per_node=CLI_NICS)}


def leaf_sizes(cfg=None) -> list[int]:
    """Element counts of the gradient leaves of ``cfg`` (smollm-360m's by
    default), in the order the collectives sync them."""
    from repro_torch.models import get_config, init_model
    from repro_torch.tree import leaves
    sizes = [p.numel() for p in leaves(init_model(cfg or get_config(ARCH), seed=0,
                                                  device="cuda"))]
    torch.cuda.empty_cache()
    return sizes


def program_merges(prog, total: int) -> list[tuple[int, int]]:
    """(rows, M) of every chunk_combine launch one rank makes running
    ``prog`` on ``total`` elements (``execute_program``): one launch per step
    of each non-empty segment (on every rank, destination or not), from the
    IR alone."""
    merges, start = [], 0
    for i, seg in enumerate(prog.segments):
        end = total if i == len(prog.segments) - 1 else start + int(round(seg.frac * total))
        n, C = max(end - start, 0), seg.schedule.num_chunks
        start = end
        if n:
            merges += [(C if st.whole_buffer else 1, -(-n // C)) for st in seg.schedule.steps]
    return merges


def planned_merges(sizes: list[int], comm) -> list[tuple[int, int]]:
    """(rows, M) of every chunk_combine launch one rank makes in one gradient
    sync: each leaf through the program ``comm`` selects."""
    from repro_torch.core.collectives import program_for
    prog = program_for(WORLD, **comm.kwargs())
    return [m for total in sizes for m in program_merges(prog, total)]


def largest_merges() -> tuple[tuple[int, int], tuple[int, int]]:
    """(rows, M) of the largest buffer the training phase hands to
    chunk_combine, and of the largest single row (a chunked step): every
    leaf of smollm-360m through every program it runs."""
    sizes = leaf_sizes()
    merges = [m for comm in train_comms().values() for m in planned_merges(sizes, comm)]
    return (max(merges, key=lambda rm: rm[0] * rm[1]),
            max((m for m in merges if m[0] == 1), key=lambda rm: rm[1]))


def check_chunk_combine(gen) -> dict:
    from repro_torch.core.collectives import VEC_BYTES, StagingBuffers
    from repro_torch.kernels import ref
    from repro_torch.kernels.chunk_combine import chunk_combine_cuda
    from repro_torch.launch import cost_analysis as CA
    from repro_torch.launch.profile_kernels import device_ms, host_ms

    def rand(n, dtype, offset=0):
        flat = torch.randn(n + offset, device="cuda", generator=gen).to(dtype)
        return flat[offset:]

    n_cases, worst = 0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for C in (1, 4, 12, 1024):
            # every (seg, acc) combination: one per row, or one per case for C=1
            combos = [([s], [a]) for s in (0, 1) for a in (0, 1)] if C == 1 else \
                [([0, 0, 1, 1] * (C // 4), [0, 1, 0, 1] * (C // 4))]
            for M in (1, 7, 513, 700):
                for seg, acc in combos:
                    # (local offset, recv offset): aligned, both off the 16-byte
                    # grid by one element, and misaligned against each other
                    for lo, ro in ((0, 0), (1, 1), (1, 0)):
                        for inplace in (False, True):
                            local = rand(C * M, dtype, lo).view(C, M)
                            recv = rand(C * M, dtype, ro).view(C, M)
                            want = ref.reference_chunk_combine(local, recv, seg, acc)
                            out = chunk_combine_cuda(local, recv, seg, acc,
                                                     out=local if inplace else None)
                            torch.cuda.synchronize()
                            err = (out.float() - want.float()).abs().max().item()
                            worst = max(worst, err)
                            n_cases += 1
                            if err != 0.0:
                                raise RuntimeError(
                                    f"chunk_combine {str(dtype)[6:]} C={C} M={M} seg={seg} "
                                    f"acc={acc} offsets=({lo},{ro}) inplace={inplace}: "
                                    f"max_abs_err {err} (tol 0: one fp32 add, one rounding)")
        log("kernels", f"chunk_combine {str(dtype)[6:]}: C in (1, 4, 12, 1024), M in (1, 7, 513, "
            f"700), every seg/acc pair, aligned / offset / misaligned rows, in and out "
            f"of place: max_abs_err={worst:.1e} (tol 0) ok")

    # timing at the largest merge of the training phase: bf16, every row
    # accumulating (3 x rows x M x 2 bytes move), in place as the collectives
    # call it.  On these inputs (every row seg=1, acc=1) one in-place add
    # computes the same function: it is the library yardstick, and must
    # agree exactly (one fp32 add, one rounding to bf16)
    (rows, M), (_, M1) = largest_merges()
    local = rand(rows * M, torch.bfloat16).view(rows, M)
    recv = rand(rows * M, torch.bfloat16).view(rows, M)
    seg = acc = [1] * rows
    lib = torch.add(local, recv)
    if not torch.equal(chunk_combine_cuda(local, recv, seg, acc), lib):
        raise RuntimeError("chunk_combine differs from torch.add where every row adds")
    del lib
    t_kernel = time_ms(lambda: chunk_combine_cuda(local, recv, seg, acc, out=local))
    t_plain = time_ms(lambda: ref.reference_chunk_combine(local, recv, seg, acc))
    t_lib = time_ms(lambda: torch.add(local, recv, out=local))
    t_kernel2 = time_ms(lambda: chunk_combine_cuda(local, recv, seg, acc, out=local))
    t_lib2 = time_ms(lambda: torch.add(local, recv, out=local))
    bound = CA.chunk_combine_cost((rows, M), torch.bfloat16, seg, acc).bound()["bound_ms"]
    log("kernels", f"chunk_combine largest training merge ({rows}, {M}) bf16: kernel "
        f"{t_kernel:.4f} / {t_kernel2:.4f} ms, plain {t_plain:.4f} ms, in-place "
        f"torch.add {t_lib:.4f} / {t_lib2:.4f} ms (events, back to back), bound "
        f"{bound:.4f} ms (bytes); {n_cases} cases checked")
    # the same split into device time (torch.profiler) and the host's time
    # per call with the card kept busy
    dev = {"kernel": device_ms(lambda: chunk_combine_cuda(local, recv, seg, acc, out=local)),
           "torch.add": device_ms(lambda: torch.add(local, recv, out=local))}
    dev = {n: sum(d.values()) or None for n, d in dev.items()}
    host = {"kernel": host_ms(lambda: chunk_combine_cuda(local, recv, seg, acc, out=local)),
            "torch.add": host_ms(lambda: torch.add(local, recv, out=local))}
    log("kernels", "chunk_combine largest training merge, device time per call "
        "(torch.profiler): " + ", ".join(
            f"{n} {t:.4f} ms" if t else f"{n} not measured" for n, t in dev.items())
        + "; host time per call: " + ", ".join(f"{n} {t:.4f} ms" for n, t in host.items()))
    del local, recv

    # the largest chunked merge, one row at an offset off the 16-byte grid
    # (row rc of a (C, M) buffer with ragged M): received into a staging
    # buffer at the row's phase, as the collectives stage it, and at offset 0
    buf = rand(M1 + 1, torch.bfloat16)
    row = buf[1:].view(1, M1)
    staged = StagingBuffers().get("recv", M1, torch.bfloat16, row.device,
                                  phase_of=row).view(1, M1)
    staged.copy_(rand(M1, torch.bfloat16).view(1, M1))
    at_zero = staged.clone()
    if (staged.data_ptr() - row.data_ptr()) % VEC_BYTES or \
            (at_zero.data_ptr() - row.data_ptr()) % VEC_BYTES == 0:
        raise RuntimeError("staging buffer phases not as intended")
    want = ref.reference_chunk_combine(row, staged, [1], [1])
    got = chunk_combine_cuda(row, staged, [1], [1])
    worst = max(worst, (got.float() - want.float()).abs().max().item())
    if worst != 0.0:
        raise RuntimeError(f"chunk_combine chunked row: max_abs_err {worst} (tol 0)")
    t_phase = time_ms(lambda: chunk_combine_cuda(row, staged, [1], [1], out=row))
    t_zero = time_ms(lambda: chunk_combine_cuda(row, at_zero, [1], [1], out=row))
    log("kernels", f"chunk_combine largest chunked merge (1, {M1}) bf16, row off the "
        f"16-byte grid: received at the row's phase {t_phase:.4f} ms, at offset 0 "
        f"{t_zero:.4f} ms, bound "
        f"{CA.chunk_combine_cost((1, M1), torch.bfloat16, [1], [1]).bound()['bound_ms']:.4f} "
        f"ms (bytes)")
    return dict(name="chunk_combine", **KERNELS["chunk_combine"], launches=0,
                max_abs_err=worst, ms=min(t_kernel, t_kernel2), plain_ms=t_plain,
                bound_ms=bound, bound_by="bytes", library_ms=min(t_lib, t_lib2),
                device_ms=dev["kernel"], library_device_ms=dev["torch.add"],
                host_ms=host["kernel"], library_host_ms=host["torch.add"])


def scan_err(got, want) -> tuple[float, float]:
    """(max |got - want|, that over max(1, max |want|)), raising on
    non-finite output."""
    if not torch.isfinite(got).all():
        raise RuntimeError("non-finite scan output")
    err = (got - want).abs().max().item()
    return err, err / max(1.0, want.abs().max().item())


def check_lru_scan(gen) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.lru_scan import TILE, WARPS, lru_scan_cuda
    from repro_torch.launch import cost_analysis as CA
    from repro_torch.launch.profile_kernels import device_ms
    from repro_torch.models import get_config
    from repro_torch.models.rglru import _gates, init_rglru_block

    # a and x from the model's gates: one RG-LRU block's gate weights at
    # recurrentgemma-9b's width, on post-conv activations of unit scale
    cfg = get_config("recurrentgemma-9b")
    W = cfg.rglru.lru_width
    gates = {k: v for k, v in init_rglru_block(gen, 8, W, cfg.rglru.conv_width).items()
             if k in ("w_rg", "b_rg", "w_ig", "b_ig", "lam")}

    def inputs(B, T, W, decay):
        """decay "gates": a, x from _gates; "zero": a = 0; "one": a = 1 and
        x = |u|, so h is a running sum that grows with t."""
        u = torch.randn(B, T, W, device="cuda", generator=gen)
        h0 = torch.randn(B, W, device="cuda", generator=gen)
        if decay != "gates":
            a = torch.full_like(u, 0.0 if decay == "zero" else 1.0)
            return a, (u.abs() if decay == "one" else u), h0
        a, x = _gates({k: v[..., :W, :W] if k.startswith("w_") else v[..., :W]
                       for k, v in gates.items()}, u)
        return a.contiguous(), x.contiguous(), h0

    decays = {"gates": "from _gates", "zero": "= 0", "one": "= 1, x = |u|"}
    serve_shape = (RECURRENT["serve_recurrentgemma"][1], RECURRENT["serve_recurrentgemma"][2], W)
    sub = TILE // WARPS
    worst = 0.0
    # the kernel's tiles (TILE steps) and sub-chunks (TILE // WARPS) +-1, W - 3
    # (off its 32 channels a CTA and its 16-byte copies), B = 1, hard decays
    for shape, decay in ((serve_shape, "gates"), ((3, 37, 100), "gates"), ((1, 1, 5), "gates"),
                         ((2, TILE + 1, W - 3), "gates"), ((2, TILE - 1, W), "gates"),
                         ((1, TILE, W - 3), "gates"), ((2, sub - 1, W), "gates"),
                         ((1, sub + 1, W - 3), "gates"), ((2, 2 * TILE + 1, W), "zero"),
                         ((1, TILE + 1, W - 3), "zero"), (serve_shape, "one"),
                         ((1, TILE - 1, W - 3), "one")):
        a, x, h0 = inputs(*shape, decay)
        got = lru_scan_cuda(a, x, h0)
        abs_err, err = scan_err(got, ref.reference_lru_scan(a, x, h0))
        worst = max(worst, err)
        log("kernels", f"lru_scan {shape} fp32, a {decays[decay]}, nonzero h0: max_abs_err="
            f"{abs_err:.3e}, {err:.3e} of max(1, max|h|) (tol {SCAN_RTOL:g}) "
            f"{'ok' if err <= SCAN_RTOL else 'FAIL'}")
        if err > SCAN_RTOL:
            raise RuntimeError(f"lru_scan {shape} ({decay}): max_err {err} > {SCAN_RTOL}")
        # two calls on the same inputs give the same bits (no cross-CTA sums)
        if not torch.equal(got, lru_scan_cuda(a, x, h0)):
            raise RuntimeError(f"lru_scan {shape} ({decay}): two calls on the same "
                               "inputs differ")
        if shape == serve_shape and decay == "gates":
            serve_err, timed = (abs_err, err), (a, x, h0)
        del a, x, h0, got
    log("kernels", "lru_scan: two calls on the same inputs give the same output, bit for "
        "bit, in every case above")
    a, x, h0 = timed
    t_kernel = time_ms(lambda: lru_scan_cuda(a, x, h0))
    t_plain = time_ms(lambda: ref.reference_lru_scan(a, x, h0), iters=3, warmup=1)
    t_kernel2 = time_ms(lambda: lru_scan_cuda(a, x, h0))
    dev = sum(device_ms(lambda: lru_scan_cuda(a, x, h0)).values()) or None
    cost = CA.lru_scan_cost(*a.shape)               # a, x in, h out; h0 in
    nbytes, bound = cost.nbytes, cost.bound()["bound_ms"]
    log("kernels", f"lru_scan serve shape {serve_shape} fp32: kernel {t_kernel:.4f} / "
        f"{t_kernel2:.4f} ms, plain {t_plain:.4f} ms, bound {bound:.4f} ms (bytes, "
        f"{nbytes / 1e6:.1f} MB), {bound / min(t_kernel, t_kernel2):.1%} of it; "
        f"library: none ({NO_LIBRARY}); worst case err {worst:.3e}; device time per call "
        f"(torch.profiler) {fmt_ms(dev)}")
    return dict(name="lru_scan", **KERNELS["lru_scan"], launches=0,
                max_abs_err=serve_err[0], max_rel_err=serve_err[1], ms=min(t_kernel, t_kernel2), plain_ms=t_plain, bound_ms=bound,
                bound_by="bytes", library_ms=None, library_note=NO_LIBRARY, device_ms=dev)


def check_wkv_scan(gen) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.wkv_scan import wkv_scan_cuda
    from repro_torch.launch import cost_analysis as CA
    from repro_torch.launch.profile_kernels import device_ms

    def inputs(B, T, H, K, hard=False):
        r, k, v = (torch.randn(B, T, H, K, device="cuda", generator=gen) for _ in range(3))
        # w = exp(-exp(dec)) as rwkv_block makes it, dec around the
        # decay_base of -6 moved by the low-rank term; `hard`: dec up to +3
        # (w down to exp(-e^3) ~ 2e-9) and every fifth step's rows w = 1
        if hard:
            dec = torch.rand(B, T, H, K, device="cuda", generator=gen) * 12.0 - 9.0
        else:
            dec = -6.0 + 2.0 * torch.randn(B, T, H, K, device="cuda", generator=gen)
        w = torch.exp(-torch.exp(dec))
        if hard:
            w[:, 2::5] = 1.0
        u = 0.1 * torch.randn(H, K, device="cuda", generator=gen)
        s0 = torch.randn(B, H, K, K, device="cuda", generator=gen)
        return r, k, v, w, u, s0

    arch, B, T, _, _ = RECURRENT["serve_rwkv6"]
    serve_shape = (B, T, 32, 64)                  # rwkv6-1.6b: d 2048 = 32 heads of 64
    worst = 0.0
    # B * H and T off the kernel's 16-step chunk and its CTAs per (b, h)
    for shape, hard in ((serve_shape, False), ((3, 37, 5, 32), False), ((1, 1, 2, 16), False),
                        ((2, 100, 3, 64), False), (serve_shape, True), ((3, 37, 5, 64), True),
                        ((1, 77, 3, 32), True), ((5, 19, 1, 16), True)):
        ins = inputs(*shape, hard=hard)
        got, want = wkv_scan_cuda(*ins), ref.reference_wkv(*ins)
        errs = [scan_err(g, w) for g, w in zip(got, want)]
        abs_err, err = max(e[0] for e in errs), max(e[1] for e in errs)
        worst = max(worst, err)
        decays = ("hard decays, dec up to +3 and rows of w = 1" if hard
                  else "w = exp(-exp(dec))")
        log("kernels", f"wkv_scan {shape} fp32, {decays}, nonzero s0, out and "
            f"s_T: max_abs_err={abs_err:.3e}, {err:.3e} of max(1, max|value|) (tol "
            f"{SCAN_RTOL:g}) "
            f"{'ok' if err <= SCAN_RTOL else 'FAIL'}")
        if err > SCAN_RTOL:
            raise RuntimeError(f"wkv_scan {shape} ({decays}): max_err {err} > {SCAN_RTOL}")
        if shape == serve_shape and not hard:
            serve_err, timed = (abs_err, err), ins
    t_kernel = time_ms(lambda: wkv_scan_cuda(*timed))
    t_plain = time_ms(lambda: ref.reference_wkv(*timed), iters=3, warmup=1)
    t_kernel2 = time_ms(lambda: wkv_scan_cuda(*timed))
    dev = sum(device_ms(lambda: wkv_scan_cuda(*timed)).values()) or None
    # what the function needs (cost_analysis.wkv_scan_cost)
    b = CA.wkv_scan_cost(*serve_shape).bound()
    bound, bound_by = b["bound_ms"], b["bound_by"]
    flops, nbytes, t_ops, t_bytes = b["gflop"] * 1e9, b["mbytes"] * 1e6, \
        b["ops_ms"] / 1e3, b["bytes_ms"] / 1e3
    log("kernels", f"wkv_scan serve shape {serve_shape} fp32: kernel {t_kernel:.4f} / "
        f"{t_kernel2:.4f} ms, plain {t_plain:.4f} ms, bound {bound:.4f} ms ({bound_by}: "
        f"{flops / 1e9:.2f} GFLOP -> {t_ops * 1e3:.4f} ms, {nbytes / 1e6:.1f} MB -> "
        f"{t_bytes * 1e3:.4f} ms), {bound / min(t_kernel, t_kernel2):.1%} of it; library: "
        f"none ({NO_LIBRARY}); worst case err {worst:.3e}; device time per call "
        f"(torch.profiler) {fmt_ms(dev)}")
    return dict(name="wkv_scan", **KERNELS["wkv_scan"], launches=0,
                max_abs_err=serve_err[0], max_rel_err=serve_err[1], ms=min(t_kernel, t_kernel2), plain_ms=t_plain, bound_ms=bound,
                bound_by=bound_by, library_ms=None, library_note=NO_LIBRARY, device_ms=dev)


def grads_err(got, want) -> tuple[float, float]:
    """Over a list of gradients: (max |got - want|, the worst of that over
    max(1, max |want|)), raising on a non-finite gradient."""
    errs = [scan_err(g, w) for g, w in zip(got, want)]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def check_lru_scan_bwd(gen) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.lru_scan import lru_scan_bwd_cuda, lru_scan_cuda
    from repro_torch.launch import cost_analysis as CA
    from repro_torch.launch.profile_kernels import device_ms

    def inputs(B, T, W):
        """a as the model's gates make it, u^r with u ~ U(0.9, 0.999) (the
        Griffin init) and r a sigmoid; x, h0 and the gradient gh normal."""
        r = torch.sigmoid(torch.randn(B, T, W, device="cuda", generator=gen))
        u = 0.9 + 0.099 * torch.rand(W, device="cuda", generator=gen)
        x, gh = (torch.randn(B, T, W, device="cuda", generator=gen) for _ in range(2))
        return u ** r, x, torch.randn(B, W, device="cuda", generator=gen), gh

    worst = 0.0
    # the training shape; T off the 128-step tiles and 16-step sub-chunks,
    # W off the 32 channels a CTA and the 16-byte copies; T = 1; gh0 not
    # asked for, as training never asks
    for shape, want_gh0 in ((LRU_TRAIN, True), (LRU_TRAIN, False), ((1, 129, 4093), True),
                            ((3, 17, 100), True), ((2, 1, 4096), True), ((1, 255, 37), False)):
        a, x, h0, gh = inputs(*shape)
        h = lru_scan_cuda(a, x, h0)
        got = lru_scan_bwd_cuda(a, h, h0, gh, want_gh0=want_gh0)
        leaves = [t.clone().requires_grad_() for t in (x, a, h0)]
        want = torch.autograd.grad(ref.reference_lru_scan(leaves[1], leaves[0], leaves[2]),
                                   leaves[:2 + want_gh0], gh)
        abs_err, err = grads_err(got[:2 + want_gh0], want)
        worst = max(worst, err)
        log("kernels", f"lru_scan_bwd {shape} fp32, gh0 {'asked' if want_gh0 else 'not asked'}"
            f": gx, ga{', gh0' if want_gh0 else ''} max_abs_err={abs_err:.3e}, {err:.3e} of "
            f"max(1, max|grad|) (tol {SCAN_BWD_RTOL:g}) {'ok' if err <= SCAN_BWD_RTOL else 'FAIL'}")
        if err > SCAN_BWD_RTOL or (got[2] is None) == want_gh0:
            raise RuntimeError(f"lru_scan_bwd {shape}: max_err {err} > {SCAN_BWD_RTOL}")
        again = lru_scan_bwd_cuda(a, h, h0, gh, want_gh0=want_gh0)
        if not all(g is None or torch.equal(g, g2) for g, g2 in zip(got, again)):
            raise RuntimeError(f"lru_scan_bwd {shape}: two calls on the same inputs differ")
        if shape == LRU_TRAIN and not want_gh0:
            train_err, timed = (abs_err, err), (a, x, h0, gh, h)
        del a, x, h0, gh, h, got, want, leaves, again
    log("kernels", "lru_scan_bwd: two calls on the same inputs give the same output, bit "
        "for bit, in every case above")
    a, x, h0, gh, h = timed
    run = lambda: lru_scan_bwd_cuda(a, h, h0, gh, want_gh0=False)    # noqa: E731
    leaves = [t.clone().requires_grad_() for t in (x, a)]
    hp = ref.reference_lru_scan(leaves[1], leaves[0], h0)
    plain = lambda: torch.autograd.grad(hp, leaves, gh, retain_graph=True)  # noqa: E731
    t_kernel = time_ms(run)
    t_plain = time_ms(plain, iters=3, warmup=1)
    t_kernel2 = time_ms(run)
    dev = sum(device_ms(run).values()) or None
    # a, h, gh in, gx, ga out (each once), h0 in
    cost = CA.lru_scan_bwd_cost(*a.shape, want_gh0=False)
    nbytes, bound = cost.nbytes, cost.bound()["bound_ms"]
    log("kernels", f"lru_scan_bwd training shape {LRU_TRAIN} fp32: kernel {t_kernel:.4f} / "
        f"{t_kernel2:.4f} ms, plain (autograd through the plain scan) {t_plain:.4f} ms, "
        f"bound {bound:.4f} ms (bytes, {nbytes / 1e6:.1f} MB), "
        f"{bound / min(t_kernel, t_kernel2):.1%} of it; library: none ({NO_LIBRARY}); "
        f"worst case err {worst:.3e}; device time per call (torch.profiler) {fmt_ms(dev)}")
    return dict(name="lru_scan_bwd", **KERNELS["lru_scan_bwd"], launches=0,
                max_abs_err=train_err[0], max_rel_err=train_err[1],
                ms=min(t_kernel, t_kernel2), plain_ms=t_plain, bound_ms=bound,
                bound_by="bytes", library_ms=None, library_note=NO_LIBRARY, device_ms=dev)


def check_wkv_scan_bwd(gen) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.wkv_scan import CHUNK, bwd_cluster, wkv_scan_bwd_cuda, wkv_scan_cuda
    from repro_torch.launch import cost_analysis as CA
    from repro_torch.launch.profile_kernels import device_profile

    def inputs(B, T, H, K, hard):
        """As check_wkv_scan's, plus the gradients of out and s_T."""
        r, k, v, gy = (torch.randn(B, T, H, K, device="cuda", generator=gen)
                       for _ in range(4))
        if hard:
            dec = torch.rand(B, T, H, K, device="cuda", generator=gen) * 12.0 - 9.0
        else:
            dec = -6.0 + 2.0 * torch.randn(B, T, H, K, device="cuda", generator=gen)
        w = torch.exp(-torch.exp(dec))
        if hard:
            w[:, 2::5] = 1.0
        u = 0.1 * torch.randn(H, K, device="cuda", generator=gen)
        s0, gs = (torch.randn(B, H, K, K, device="cuda", generator=gen) for _ in range(2))
        return [r, k, v, w, u, s0], gy, gs

    def kernel(ins, gy, gs, want_gs0):
        B, T, H, K = ins[0].shape
        ckpt = torch.empty((B, H, -(-T // CHUNK), K, K), device="cuda")
        wkv_scan_cuda(*ins, ckpt)
        return wkv_scan_bwd_cuda(*ins[:5], ckpt, gy, gs, want_gs0=want_gs0)

    worst = 0.0
    # the training shape (s_T's gradient None, s0's not asked, as training
    # does); hard decays; every head size; T off the 16-step chunks; T = 1;
    # a gradient of s_T given
    for shape, hard, with_gs in ((WKV_TRAIN, False, False), (WKV_TRAIN, True, False),
                                 ((3, 37, 5, 32), True, True), ((5, 19, 1, 16), True, False),
                                 ((1, 1, 2, 16), False, True), ((2, 33, 7, 64), False, True)):
        ins, gy, gs = inputs(*shape, hard)
        gs = gs if with_gs else None
        train = shape == WKV_TRAIN and not hard
        got = kernel(ins, gy, gs, want_gs0=not train)
        leaves = [t.clone().requires_grad_() for t in ins]
        out, s_t = ref.reference_wkv(*leaves)
        loss = (out * gy).sum() + ((s_t * gs).sum() if with_gs else 0.0)
        want = torch.autograd.grad(loss, leaves if not train else leaves[:5],
                                   allow_unused=True)
        want = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, want)]
        abs_err, err = grads_err(got[:len(want)], want)
        worst = max(worst, err)
        decays = "hard decays" if hard else "w = exp(-exp(dec))"
        log("kernels", f"wkv_scan_bwd {shape} fp32, {decays}, gradient of s_T "
            f"{'given' if with_gs else 'None'}: gr, gk, gv, gw, gu{'' if train else ', gs0'} "
            f"max_abs_err={abs_err:.3e}, {err:.3e} of max(1, max|grad|) (tol "
            f"{SCAN_BWD_RTOL:g}) {'ok' if err <= SCAN_BWD_RTOL else 'FAIL'}")
        if err > SCAN_BWD_RTOL:
            raise RuntimeError(f"wkv_scan_bwd {shape} ({decays}): max_err {err} > "
                               f"{SCAN_BWD_RTOL}")
        again = kernel(ins, gy, gs, want_gs0=not train)
        if not all(g is None or torch.equal(g, g2) for g, g2 in zip(got, again)):
            raise RuntimeError(f"wkv_scan_bwd {shape}: two calls on the same inputs differ")
        if train:
            train_err, timed = (abs_err, err), (ins, gy)
        del ins, gy, gs, got, again, leaves, out, s_t, loss, want
    log("kernels", "wkv_scan_bwd: two calls on the same inputs give the same output, bit "
        "for bit, in every case above")
    ins, gy = timed
    B, T, H, K = ins[0].shape
    ckpt = torch.empty((B, H, -(-T // CHUNK), K, K), device="cuda")
    wkv_scan_cuda(*ins, ckpt)
    run = lambda: wkv_scan_bwd_cuda(*ins[:5], ckpt, gy, None, want_gs0=False)  # noqa: E731
    leaves = [t.clone().requires_grad_() for t in ins[:5]]
    out, _ = ref.reference_wkv(*leaves, ins[5])
    plain = lambda: torch.autograd.grad(out, leaves, gy, retain_graph=True)  # noqa: E731
    t_kernel = time_ms(run)
    t_plain = time_ms(plain, iters=3, warmup=1)
    t_kernel2 = time_ms(run)
    prof = device_profile(run)
    dev = sum(v["ms"] for v in prof.values()) or None
    kernels = {n: v for n, v in prof.items() if "memset" not in n.lower()}
    log("kernels", f"wkv_scan_bwd training shape, per call (torch.profiler): "
        f"{sum(v['launches'] for v in kernels.values()):g} kernel launch(es), "
        + "; ".join(f"{n}: {v['launches']:g} x {v['ms']:.4f} ms" for n, v in prof.items()))
    # a model of the traffic, from the design (no counter reads it): each
    # of the P CTAs of a (b, h)'s cluster stages whole rows of r, k and w
    # (through L2; from device memory once) and its columns' slices of v
    # and gy, reads the checkpoints once and u (H, K) a CTA, and writes each
    # gradient once and its part of gu to the scratch (P, B, H, K), which
    # the last CTA of a head reads back
    n, P, nch = B * T * H * K, bwd_cluster(K), -(-T // CHUNK)
    ck_f, part_f = B * H * nch * K * K, P * B * H * K
    model = dict(read_once=4 * (5 * n + ck_f + H * K + part_f),
                 read_through_l2=4 * ((3 * P + 2) * n + ck_f + 2 * part_f),
                 written=4 * (4 * n + H * K + part_f))
    # what the function needs (cost_analysis.wkv_scan_bwd_cost)
    b = CA.wkv_scan_bwd_cost(B, T, H, K).bound()
    bound, bound_by = b["bound_ms"], b["bound_by"]
    flops, nbytes, t_ops, t_bytes = b["gflop"] * 1e9, b["mbytes"] * 1e6, \
        b["ops_ms"] / 1e3, b["bytes_ms"] / 1e3
    log("kernels", f"wkv_scan_bwd training shape {WKV_TRAIN} fp32: kernel {t_kernel:.4f} / "
        f"{t_kernel2:.4f} ms, plain (autograd through the plain recurrence) {t_plain:.4f} "
        f"ms, bound {bound:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP -> "
        f"{t_ops * 1e3:.4f} ms, {nbytes / 1e6:.1f} MB -> {t_bytes * 1e3:.4f} ms), "
        f"{bound / min(t_kernel, t_kernel2):.1%} of it; library: none ({NO_LIBRARY}); "
        f"worst case err {worst:.3e}; device time per call (torch.profiler, every "
        f"launch) {fmt_ms(dev)}")
    log("kernels", f"wkv_scan_bwd training shape, modelled traffic (an estimate from the "
        f"design, not measured): read {model['read_once'] / 1e6:.1f} MB once "
        f"({model['read_through_l2'] / 1e6:.1f} MB through L2), written "
        f"{model['written'] / 1e6:.1f} MB, against the function's {nbytes / 1e6:.1f} MB "
        f"(the checkpoints, {4 * ck_f / 1e6:.1f} MB, are the replay's)")
    return dict(name="wkv_scan_bwd", **KERNELS["wkv_scan_bwd"], launches=0,
                max_abs_err=train_err[0], max_rel_err=train_err[1],
                ms=min(t_kernel, t_kernel2), plain_ms=t_plain, bound_ms=bound,
                bound_by=bound_by, library_ms=None, library_note=NO_LIBRARY, device_ms=dev,
                device_launches={n: v["launches"] for n, v in prof.items()},
                device_ms_by_launch={n: v["ms"] for n, v in prof.items()})


@contextlib.contextmanager
def recorded_routes(replay: list | None = None):
    """Yields a list that collects each MoE layer's chosen experts (top_i,
    in the router's order) while the block runs.  With ``replay``, the
    routes another run collected, each layer takes that run's experts
    instead, weighted by its own router's probabilities as ``moe._route``
    weights its own choice."""
    from repro_torch.models import moe
    routes, route = [], moe._route
    pinned = iter(replay) if replay is not None else None

    def recording(params, xt, top_k):
        probs, top_p, top_i = route(params, xt, top_k)
        if pinned is not None:
            top_i = next(pinned)
            top_p = moe._renormalise(probs.gather(-1, top_i))
        routes.append(top_i)
        return probs, top_p, top_i

    moe._route = recording
    try:
        yield routes
    finally:
        moe._route = route


def serve(card: str, phase: str, arch: str, batch: int, prompt: int, context: int,
          per_prefill: dict[str, int], logit_atol: float,
          layers: int | None = None, overrides: dict | None = None) -> dict[str, int]:
    """One serve phase: the engine healthy and with a NIC failure, launch
    counts held to ``per_prefill`` times the two prefills (every other
    kernel at 0), then the prefill logits through the kernels against the
    plain versions of all of them.  ``layers`` cuts the depth (full width);
    ``overrides`` replaces config fields (deepseek-v3's ``mtp=False``).
    Returns the launch counts."""
    from repro_torch.core.failures import Failure, FailureType
    from repro_torch.kernels import ops
    from repro_torch.models import apply_model, get_config, init_caches, init_model
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.tree import leaves

    cfg = get_config(arch)
    depth = f"{cfg.num_layers} layers"
    if layers is not None:
        depth = f"{layers} of {cfg.num_layers} layers (full width, depth cut)"
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if overrides:
        depth += f", {overrides}"
        cfg = dataclasses.replace(cfg, **overrides)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    a = cfg.attention
    heads = (f"{a.num_heads}/{a.num_kv_heads} heads" if a
             else f"{cfg.d_model // cfg.rwkv.head_size} wkv heads")
    if a and a.kind == "mla":
        heads = (f"MLA, {a.num_heads} heads of {a.qk_nope_head_dim}+{a.qk_rope_head_dim} "
                 f"(v {a.v_head_dim}), q_lora {a.q_lora_rank}, kv_lora {a.kv_lora_rank}")
    n_params = sum(t.numel() for t in leaves(params))
    m = cfg.moe
    moe = (f", {m.num_experts} experts top {m.top_k} of d_ff {m.expert_d_ff}"
           + (f" + {m.num_shared_experts} shared" if m.num_shared_experts else "")
           + (f", {m.first_k_dense} dense lead layers" if m.first_k_dense else "")
           if m else "")
    log(phase, f"{arch}: {depth} {tuple(cfg.block_pattern)}, d_model "
        f"{cfg.d_model}, {heads}{moe}, {n_params / 1e6:.1f}M fp32 params "
        f"({4 * n_params / 1e9:.1f} GB), init {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, prompt) for _ in range(batch)]

    def requests(new=NEW_TOKENS):
        return [Request(prompt=p, max_new_tokens=new) for p in prompts]

    def engine():
        return ServingEngine(cfg, params, context_len=context, strategy="r2ccl",
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
    want = counts(**{k: n * prefills for k, n in per_prefill.items()})
    if launches != want:
        raise RuntimeError(f"launches {launches}, want {want} ({per_prefill} per "
                           f"prefill x {prefills} prefills)")
    log(phase, f"tokens identical healthy vs NIC failure at step {FAIL_STEP}; "
        f"failovers={failed[0].failovers}, hiccup {failing.last_recovery.total * 1e3:.4f} ms "
        f"(stages {failing.last_recovery.stages}); launches {launches} ({per_prefill} "
        f"per prefill, as predicted)")
    log(phase, f"healthy: TTFT {healthy[0].ttft * 1e3:.3f} ms, TPOT "
        f"{healthy[0].tpot * 1e3:.3f} ms; with failure: TTFT {failed[0].ttft * 1e3:.3f} ms, "
        f"TPOT {failed[0].tpot * 1e3:.3f} ms, total {failed[0].total_latency * 1e3:.3f} ms "
        f"[B={batch}, prompt {prompt}, {NEW_TOKENS} new tokens; {card}]")
    log(phase, f"first tokens of request 0: {healthy[0].tokens[:8]}")
    log(phase, share_text("TTFT", healthy[0].ttft, dry_bound(cfg, "prefill", batch, prompt,
                                                            context))
        + "; " + share_text("TPOT", healthy[0].tpot, dry_bound(cfg, "decode", batch, prompt,
                                                               context)) + f" [{card}]")

    # prefill logits through the kernels vs the same model with the plain
    # version of every kernel: with a float32 residual stream, where the gap
    # is the kernels' own error, and with the config's own dtype.  An MoE
    # router's top-k is a step function of its input, so an error of one
    # rounding can swap a token's k-th and (k+1)-th expert, and the token
    # then moves by a whole expert's share: the swaps are counted and the
    # logits without them printed, and the check holds the kernels with the
    # plain run pinned to the experts the kernels' run chose
    toks = torch.as_tensor(np.stack(prompts), device="cuda")
    runs = [("auto", "auto", None), ("reference", "reference", None)]
    if cfg.moe:
        runs.append(("pinned", "reference", "auto"))
    for dtype, tol in (("float32", LOGIT_ATOL_F32), (cfg.dtype, logit_atol)):
        c = dataclasses.replace(cfg, dtype=dtype)
        logits, routes = {}, {}
        for name, impl, replay in runs:
            with torch.no_grad(), recorded_routes(routes.get(replay)) as routes[name]:
                logits[name] = apply_model(
                    params, c, {"tokens": toks}, mode="prefill",
                    caches=init_caches(c, batch, context, dtype=torch.float32,
                                       device="cuda"),
                    kernel_impl=impl)[0][:, -1].float()
        if cfg.moe:
            flips = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                        for a, b in zip(routes["auto"], routes["reference"], strict=True))
            pairs = batch * prompt * len(routes["auto"])   # (token, MoE layer)
            limit = ROUTE_FLIP_LIMIT[phase][dtype]
            free = (logits["auto"] - logits["reference"]).abs().max().item()
            log(phase, f"MoE routing, {dtype} residual stream: {flips} of {pairs} "
                f"(token, layer) pairs ({flips / pairs:.2e}; limit "
                f"{limit:g}) choose another expert set through the "
                f"kernels than through the plain versions; prefill logits with each "
                f"run's own routing: max_abs_err={free:.3e}; the check below pins the "
                f"plain run to the kernels' experts")
            if flips > limit * pairs:
                raise RuntimeError(f"MoE routing, {dtype} residual: {flips} of {pairs} "
                                   f"pairs flip, over {limit:g}")
        a, b = logits["auto"], logits["pinned" if cfg.moe else "reference"]
        if not (torch.isfinite(a).all() and a.shape == (batch, cfg.vocab_size)):
            raise RuntimeError(f"prefill logits: shape {tuple(a.shape)} or non-finite")
        err = (a - b).abs().max().item()
        top2 = b.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > tol
        same = a.argmax(-1) == b.argmax(-1)
        log(phase, f"prefill logits through the kernels vs their plain versions, {dtype} "
            f"residual stream: max_abs_err={err:.3e} (tol {tol}; logits span "
            f"{b.min().item():.3f}..{b.max().item():.3f}), top-1 equal {same.tolist()}")
        if err > tol or not bool(same[decided].all()):
            raise RuntimeError(f"prefill logits kernel vs plain, {dtype} residual: "
                               f"max_abs_err {err}, top-1 equal {same.tolist()} "
                               f"(decided {decided.tolist()})")
    log(phase, f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        f"(torch.cuda.max_memory_allocated)")
    del params, failing, logits, routes, a, b
    torch.cuda.empty_cache()
    return launches


def rank_batch(cfg, rank: int, step: int, dev) -> dict:
    from repro_torch.data import make_batch
    b = make_batch(cfg, seq_len=SEQ, batch_size=WORLD * LOCAL_BATCH, step=step)
    return {k: torch.from_numpy(v[rank * LOCAL_BATCH:(rank + 1) * LOCAL_BATCH]).to(dev)
            for k, v in b.items()}


def synced_grads(cfg, rank: int, axis, dev) -> dict:
    """Step 0's gradients on this rank, synchronized both ways: fp32
    ``all_reduce_mean`` (what ``sync="xla"`` does) and the bf16 wire through
    the degraded R2CCL program (what ``sync="r2ccl"`` does); returns the
    worst leaf's ||g_r2ccl - g_xla|| / ||g_xla|| and its name, and the
    largest ||g_xla|| / ||g_local|| gap between leaves (how far this rank's
    own gradient is from the mean, for scale)."""
    from repro_torch.configs.base import CommConfig
    from repro_torch.core.collectives import all_reduce_mean, sync_gradients
    from repro_torch.models import init_model
    from repro_torch.training import compute_loss, param_grads
    from repro_torch.tree import leaves_with_path

    params = init_model(cfg, seed=0, device=dev)
    named = {"/".join(p): t.requires_grad_(True) for p, t in leaves_with_path(params)}
    total, _ = compute_loss(params, cfg, rank_batch(cfg, rank, 0, dev))
    grads = dict(zip(named, param_grads(total, list(named.values()))))
    xla = {n: all_reduce_mean(g, axis) for n, g in grads.items()}
    wire = sync_gradients({n: g.to(torch.bfloat16) for n, g in grads.items()}, axis,
                          mean=True, **CommConfig(**R2CCL_COMM).kwargs())
    rel = {n: float((wire[n].float() - xla[n]).norm() / xla[n].norm()) for n in grads}
    own = {n: float((grads[n] - xla[n]).norm() / xla[n].norm()) for n in grads}
    worst = max(rel, key=rel.get)
    return dict(worst=worst, rel=rel[worst], own=min(own.values()))


def parity_rank(rank: int, world: int, device: str, _unused) -> dict:
    """One rank of the xla-vs-r2ccl parity run: step 0's gradients synced
    both ways, then 4 steps of each from the same seed and data; returns
    losses, timings, launch counts, peak memory and (r2ccl) the largest
    param difference against the xla run."""
    from repro_torch.configs.base import CommConfig
    from repro_torch.core.collectives import DataAxis
    from repro_torch.kernels import ops
    from repro_torch.models import get_config, init_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import init_train_state, make_train_step
    from repro_torch.tree import leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(ARCH)
    dev = torch.device("cuda:0")
    axis = DataAxis()
    out, xla_params = {"grads": synced_grads(cfg, rank, axis, dev)}, None
    torch.cuda.empty_cache()
    for name, sync, comm in (("xla", "xla", None),
                             ("r2ccl", "r2ccl", CommConfig(**R2CCL_COMM))):
        state = init_train_state(init_model(cfg, seed=0, device=dev))
        step = make_train_step(cfg, AdamWConfig(lr=1e-3), sync=sync, comm=comm,
                               axis=axis, warmup_steps=1, total_steps=100)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        losses, stats = [], []
        for i in range(TRAIN_STEPS):
            st: dict[str, float] = {}
            t0 = time.perf_counter()
            state, m = step(state, rank_batch(cfg, rank, i, dev), stats=st)
            losses.append(float(m["loss"]))
            st["step_s"] = time.perf_counter() - t0
            stats.append(st)
        run = dict(losses=losses, stats=stats, launches=ops.launch_counts(),
                   max_memory_allocated=torch.cuda.max_memory_allocated(dev))
        if xla_params is None:
            xla_params = [p.detach().clone() for p in leaves(state.params)]
        else:
            run["param_diff"] = max(float((p.detach() - r).abs().max())
                                    for p, r in zip(leaves(state.params), xla_params))
        out[name] = run
        del state, step
        torch.cuda.empty_cache()
    return out


def layer_launches(cfg, steps: int = 1) -> dict[str, int]:
    """Kernel launches of ``steps`` training steps of ``cfg`` on one rank
    (chunk_combine apart): each layer's forward kernel once, twice under
    remat (the backward recomputes the layer), and its backward kernel once;
    attention layers run the flash kernels, rglru layers the LRU scan's,
    rwkv layers the WKV recurrence's."""
    remat = 2 if cfg.remat else 1
    n = {fam: steps * sum(k in kinds for k in cfg.pattern_layers)
         for fam, kinds in (("flash_attention", ("attn", "local_attn", "global_attn")),
                            ("lru_scan", ("rglru",)), ("wkv_scan", ("rwkv",)))}
    return {**{fam: remat * c for fam, c in n.items()},
            **{f"{fam}_bwd": c for fam, c in n.items()}}


@contextlib.contextmanager
def pinned_wkv(replay: list | None = None):
    """Yields a list that collects each ``ops.wkv_scan`` call's outputs
    (out, s_T) while the model runs.  With ``replay``, the outputs another
    run collected, each call returns that run's outputs as its value (no
    kernel is launched) and its backward is autograd through the plain
    recurrence on the call's own inputs: the plain run's forward pinned to
    the kernels' values, as ``recorded_routes`` pins an MoE run's experts."""
    from repro_torch.kernels import ops, ref
    calls, scan = [], ops.wkv_scan
    pinned = iter(replay) if replay is not None else None

    class Pinned(torch.autograd.Function):
        @staticmethod
        def forward(ctx, out, s_t, *ins):
            ctx.save_for_backward(*ins)
            return out.clone(), s_t.clone()

        @staticmethod
        def backward(ctx, g_out, g_s):
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            with torch.enable_grad():
                outs = ref.reference_wkv(*ins)
            used = [(o, g) for o, g in zip(outs, (g_out, g_s)) if g is not None]
            grads = torch.autograd.grad([o for o, _ in used], ins, [g for _, g in used],
                                        allow_unused=True)
            return (None, None, *grads)

    def recording(*ins, impl="auto"):
        if pinned is not None:
            return Pinned.apply(*next(pinned), *ins)
        outs = scan(*ins, impl=impl)
        calls.append(tuple(t.detach().clone() for t in outs))
        return outs

    ops.wkv_scan = recording
    try:
        yield calls
    finally:
        ops.wkv_scan = scan


@contextlib.contextmanager
def float64_wkv():
    """``ops.wkv_scan`` as the plain recurrence computed in float64 and
    rounded to float32: a perturbation of the plain version of the size of
    the kernel's own (its sums in another order), for the plain path's own
    sensitivity to one."""
    from repro_torch.kernels import ops
    scan = ops.wkv_scan

    def wide(r, k, v, w, u, s0, impl="auto"):
        r, k, v, w, u, s = (t.double() for t in (r, k, v, w, u, s0))
        outs = []
        for t in range(r.shape[1]):
            kv = k[:, t, :, :, None] * v[:, t, :, None, :]
            outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + u[None, :, :, None] * kv))
            s = w[:, t, :, :, None] * s + kv
        return torch.stack(outs, 1).float(), s.float()

    ops.wkv_scan = wide
    try:
        yield
    finally:
        ops.wkv_scan = scan


def grad_check(cfg, phase: str = "train") -> dict[str, int]:
    """One rank's full-width gradients with every kernel (attention, the
    scans and their backwards) against the same with the plain versions, on
    the card: with a float32 residual stream, and with the config's own
    (bfloat16).  The batch is the first LOCAL_BATCH rows of make_batch's
    SEQ-long global batch (for paligemma-3b 256 image patches and 256 text
    tokens).  For the configs of BF16_PINNED the bf16 comparison pins the
    plain run's scans to the kernels' forward values (``pinned_wkv``), and
    the unpinned gap is held to the plain path's own gap under a float64
    scan (``float64_wkv``).  Returns the kernels' launches over both runs
    through them."""
    from repro_torch.data import make_batch
    from repro_torch.kernels import ops
    from repro_torch.models import init_model
    from repro_torch.training import compute_loss, param_grads
    from repro_torch.tree import leaves, leaves_with_path

    params = init_model(cfg, seed=0, device="cuda")
    names = ["/".join(p) for p, _ in leaves_with_path(params)]
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    b = make_batch(cfg, seq_len=SEQ, batch_size=WORLD * LOCAL_BATCH, step=0)
    batch = {k: torch.from_numpy(v[:LOCAL_BATCH]).cuda() for k, v in b.items()}

    def run(c, impl):
        ops.reset_launch_counts()
        total, _ = compute_loss(params, c, batch, kernel_impl=impl)
        return total.item(), param_grads(total, flat), ops.launch_counts()

    def gaps(got, want) -> dict[str, float]:
        return {n: float((a - r).norm() / r.norm().clamp(min=1e-30))
                for n, a, r in zip(names, got, want)}

    launched = counts()
    for dtype in ("float32", cfg.dtype):
        c = dataclasses.replace(cfg, dtype=dtype)
        pin = dtype != "float32" and cfg.name in BF16_PINNED
        with pinned_wkv() if pin else contextlib.nullcontext() as calls:
            la, ga, ca = run(c, "auto")
        with pinned_wkv(replay=calls) if pin else contextlib.nullcontext():
            lr, gr, cr = run(c, "reference")
        if ca != counts(**layer_launches(cfg)) or cr != counts():
            raise RuntimeError(f"grad check launches: kernels {ca}, plain {cr}")
        launched = {k: launched[k] + ca[k] for k in launched}
        rel = gaps(ga, gr)
        del gr, calls
        worst = max(rel, key=rel.get)
        loss_tol, rel_tol = GRAD_TOL[dtype]
        if not (np.isfinite(la) and abs(la - lr) <= loss_tol
                and all(np.isfinite(list(rel.values()))) and rel[worst] <= rel_tol):
            raise RuntimeError(f"full-width gradients kernel vs plain, {dtype} residual: "
                               f"loss {la} vs {lr}, worst leaf {worst} rel err {rel[worst]}")
        log(phase, f"{cfg.name}: one rank's full-width gradients ({cfg.num_layers} layers), "
            f"{dtype} residual stream, kernels vs plain{' (pinned)' if pin else ''}: "
            f"loss {la:.6f} vs {lr:.6f} (tol {loss_tol}), "
            f"worst leaf {worst} ||diff||/||plain|| = {rel[worst]:.3e} (tol {rel_tol}); "
            f"launches {ca}")
        if pin:
            lu, gu, _ = run(c, "reference")
            free = gaps(ga, gu)
            with float64_wkv():
                l64, g64, _ = run(c, "reference")
            own = gaps(g64, gu)
            del gu, g64
            wf, wo = max(free, key=free.get), max(own, key=own.get)
            log(phase, f"{cfg.name}, {dtype} residual stream, unpinned: kernels vs plain "
                f"loss {la:.6f} vs {lu:.6f}, worst leaf {wf} {free[wf]:.3e}; the plain path "
                f"against itself with a float64 scan: loss {l64:.6f}, worst leaf {wo} "
                f"{own[wo]:.3e} (kernels' gap held to {BF16_UNPINNED_FACTOR}x it); by leaf "
                f"(kernels, float64 scan): "
                f"{ {n: (round(free[n], 4), round(own[n], 4)) for n in names} }")
            if not (np.isfinite(list(free.values())).all()
                    and free[wf] <= BF16_UNPINNED_FACTOR * own[wo]):
                raise RuntimeError(f"{cfg.name} unpinned {dtype} gradients: kernels' worst "
                                   f"leaf gap {free[wf]} against the plain path's own "
                                   f"{own[wo]} under a float64 scan")
        del ga
        torch.cuda.empty_cache()
    return launched


def split(stats: list[dict]) -> str:
    keys = ("step_s", "fwd_bwd_s", "sync_s", "wire_s", "stage_s", "merge_s", "opt_s")
    return ", ".join(f"{k[:-2]} {np.mean([s.get(k, 0.0) for s in stats]) * 1e3:.1f} ms"
                     for k in keys)

def dry_bound(cfg, mode: str, batch: int, length: int, context: int | None = None) -> dict:
    """The dry run's least time for one step on one card
    (``launch/dryrun.one_card_bound``: the step counted on the meta device,
    ``cost_analysis`` at the datasheet peaks), with the phases' fp32
    caches: the roofline terms."""
    from repro_torch.launch.dryrun import one_card_bound
    return one_card_bound(cfg, mode, batch, length, context_len=context,
                          cache_dtype=torch.float32)[1]


def share_text(name: str, seconds: float, terms: dict) -> str:
    return (f"{name} {seconds * 1e3:.3f} ms against the dry run's bound "
            f"{terms['bound_s'] * 1e3:.3f} ms ({terms['bottleneck']}): "
            f"{terms['bound_s'] / seconds:.1%} of it")


def roofline_rows() -> list[tuple]:
    """(label, arch, layers or None, overrides, mode, batch, positions,
    context) of every configuration the phases serve or train, each at its
    phase's shape; glm4-9b and paper-7b, which no phase serves, at smollm's.
    A training row is one rank's step (LOCAL_BATCH x SEQ)."""
    rows = [("serve", a, None, {}, "prefill", BATCH, PROMPT, CONTEXT)
            for a in (ARCH, "glm4-9b", "paper-7b")]
    rows += [("serve", a, None, {}, "prefill", b, p, c)
             for a, b, p, c, _ in RECURRENT.values()]
    rows += [("serve", a, n, {}, "prefill", b, p, c) for a, n, b, p, c, _ in GQA.values()]
    rows += [("serve", a, n, o, "prefill", b, p, c) for a, n, b, p, c, _, o in
             MLA_PHASES.values()]
    arch, b, text, _, c = PALIGEMMA
    rows.append(("serve", arch, None, {}, "prefill", b, 256 + text, c))
    rows.append(("serve", HUBERT[0], None, {}, "prefill", HUBERT[1], HUBERT[2], HUBERT[2]))
    for arch, layers in ((ARCH, None), (PALIGEMMA[0], None), (HUBERT[0], None),
                         (HUBERT[0], HUBERT_TRAIN_LAYERS), ("recurrentgemma-9b", RG_GRAD_LAYERS),
                         ("rwkv6-1.6b", None), ("rwkv6-1.6b", RWKV_TRAIN_LAYERS)):
        rows.append(("train", arch, layers, {}, "train", LOCAL_BATCH, SEQ, None))
    return rows


def roofline(card: str) -> dict[str, int]:
    """The dry run against the card: smollm-360m's serve prefill (BATCH x
    PROMPT, CONTEXT fp32 cache slots) and one training rank's step
    (LOCAL_BATCH x SEQ: forward, backward under remat, AdamW) counted on the
    meta device, then run on the card under ``FlopCounterMode`` with the
    kernels live: the FLOP totals must be equal (one formula a kernel,
    whatever runs it), the kernels launched as often as the meta run
    dispatched them, TTFT and the step time at most 1.05x faster than their
    bounds (a larger share means a count is wrong), and the bytes
    ``init_model``, ``init_caches`` and the batch request of the allocator
    equal to the predicted argument bytes (``memory_allocated``'s gain
    printed beside them, with the allocator's rounding).  Then the dry run's bounds for every
    configuration the phases serve or train.  Returns the launch counts of
    the two counted runs."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.cost_analysis import H100_SXM, roofline_terms
    from repro_torch.launch.mesh import MeshShape, rules_for
    from repro_torch.models import get_config, init_caches, init_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.serving.engine import make_prefill_fn
    from repro_torch.training import init_train_state, make_train_step
    from repro_torch.tree import leaves

    phase = "roofline"
    cfg = get_config(ARCH)
    shapes = {"prefill": InputShape("serve_prefill", PROMPT, BATCH, "prefill"),
              "train": InputShape("rank_step", SEQ, LOCAL_BATCH, "train")}
    meta = init_model(cfg, device="meta")
    traces = {"prefill": DR.trace_step(cfg, shapes["prefill"], params=meta,
                                       cache_dtype=torch.float32, context_len=CONTEXT),
              "train": DR.trace_step(cfg, shapes["train"], params=meta)}
    terms = {k: roofline_terms(flops_per_device=t.flops_by_class,
                               hbm_bytes_per_device=t.hbm_bytes,
                               wire_bytes_per_device=0.0, chips=1)
             for k, t in traces.items()}
    one_card = MeshShape(("data", "model"), {"data": 1, "model": 1})
    args = DR.argument_bytes(cfg, shapes["prefill"], one_card, rules_for(cfg), meta,
                             cache_dtype=torch.float32, context_len=CONTEXT)
    for k, t in traces.items():
        log(phase, f"dry run, {ARCH} {k} ({shapes[k].global_batch} x {shapes[k].seq_len}; "
            f"meta device, {t.seconds:.1f} s): {t.flops} FLOPs "
            f"{ {c: n for c, n in t.flops_by_class.items()} }, {t.hbm_bytes / 1e9:.3f} GB "
            f"unfused, kernels {t.kernel_calls}; bound {terms[k]['bound_s'] * 1e3:.3f} ms "
            f"({terms[k]['bottleneck']}; compute {terms[k]['compute_s'] * 1e3:.3f} ms, "
            f"memory {terms[k]['memory_s'] * 1e3:.3f} ms at {H100_SXM.name})")

    # the arguments: what init_model, init_caches and the batch allocate.
    # memory_allocated counts the caching allocator's blocks: each request
    # rounded up to 512 B, and a request served from a large segment whose
    # rest would be 1 MiB or less takes the whole rest (should_split in
    # CUDACachingAllocator.cpp); its requested_bytes stat counts the
    # requests themselves.  The requests must equal the prediction exactly
    # (but for the caches' int32 index, a Python int in the port), and the
    # blocks may exceed them by that rounding alone
    def stats() -> tuple[int, int]:
        torch.cuda.synchronize()
        m = torch.cuda.memory_stats()
        return m["allocated_bytes.all.current"], m["requested_bytes.all.current"]

    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    before = stats()
    params = init_model(cfg, seed=0, device="cuda")
    caches = init_caches(cfg, BATCH, CONTEXT, dtype=torch.float32, device="cuda")
    batch = DR.input_specs(cfg, shapes["prefill"], device="cuda")
    allocated, requested = (a - b for a, b in zip(stats(), before))
    tensors = (leaves(params) + [t for t in leaves(caches) if isinstance(t, torch.Tensor)]
               + list(batch.values()))
    index_bytes = args["cache_index"]
    predicted = args["total"]
    log(phase, f"arguments: the dry run predicts {predicted} B {args}; init_model, "
        f"init_caches and the batch requested {requested} B (+ {index_bytes} B of cache "
        f"indices the port keeps as ints), memory_allocated gained {allocated} B "
        f"({allocated - requested} B of the allocator's rounding over {len(tensors)} "
        f"tensors; 512 B a tensor would be {512 * len(tensors)} B)")
    if requested + index_bytes != predicted or not 0 <= allocated - requested:
        raise RuntimeError(f"argument bytes: requested {requested} + {index_bytes}, "
                           f"allocated {allocated}, predicted {predicted}")
    batch["tokens"].random_(0, cfg.vocab_size, generator=gen)

    def counted(name, step) -> dict[str, int]:
        """One run of ``step`` under FlopCounterMode, its FLOPs and the
        kernels' launches held to the meta run's."""
        ops.reset_launch_counts()
        with FlopCounterMode(display=False) as fc:
            step()
        torch.cuda.synchronize()
        got, launches = fc.get_total_flops(), ops.launch_counts()
        trace = traces[name]
        want = counts(**{k.removesuffix("_fwd"): n for k, n in trace.kernel_calls.items()})
        log(phase, f"{name} on the card under FlopCounterMode, kernels live: {got} FLOPs "
            f"(meta {trace.flops}: {'equal' if got == trace.flops else 'DIFFERENT'}); "
            f"launches {launches} (meta dispatches {trace.kernel_calls})")
        if got != trace.flops or launches != want:
            raise RuntimeError(f"{name}: card {got} FLOPs, launches {launches}; meta "
                               f"{trace.flops}, {want}")
        return launches

    def median_s(step, reps: int) -> float:
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    prefill = make_prefill_fn(cfg)
    do_prefill = lambda: prefill(params, batch, caches)  # noqa: E731
    do_prefill()                                             # warm-up
    total = counted("prefill", do_prefill)
    ttft = median_s(do_prefill, 5)

    state = {"s": init_train_state(params)}
    step = make_train_step(cfg, AdamWConfig())
    tb = DR.input_specs(cfg, shapes["train"], device="cuda")
    for k in ("tokens", "labels"):
        tb[k].random_(0, cfg.vocab_size, generator=gen)

    def do_step():
        state["s"], _ = step(state["s"], tb)

    do_step()                                                # warm-up
    for k, n in counted("train", do_step).items():
        total[k] += n
    step_s = median_s(do_step, 3)
    for name, seconds, key in (("TTFT", ttft, "prefill"), ("step", step_s, "train")):
        share = terms[key]["bound_s"] / seconds
        log(phase, f"{ARCH} {share_text(name, seconds, terms[key])} (limit 105%) [{card}]")
        if share > 1.05:
            raise RuntimeError(f"{name} {seconds} s beats its bound "
                               f"{terms[key]['bound_s']} s by more than 5%: a count is wrong")
    del params, caches, batch, state, tb
    torch.cuda.empty_cache()

    log(phase, f"the dry run's bounds of every configuration served or trained here "
        f"(one card, {H100_SXM.name} peaks; fp32 weights and caches as the phases hold "
        f"them; a train row is one rank's step, and the 4-rank phases put four on the card); "
        f"torch.cuda.get_device_properties(0).total_memory "
        f"{torch.cuda.get_device_properties(0).total_memory} B [{card}]")
    log(phase, "| path | arch | layers | batch x positions | prefill or step bound | "
        "decode bound | argument GB | fits |")
    for label, arch, layers, overrides, mode, b, length, context in roofline_rows():
        c = get_config(arch)
        c = dataclasses.replace(c, num_layers=layers or c.num_layers, **overrides)
        t0 = time.perf_counter()
        main = dry_bound(c, mode, b, length, context)
        dec = (dry_bound(c, "decode", b, length, context)
               if mode == "prefill" and not c.encoder_only else None)
        m = init_model(c, device="meta")
        shape = InputShape(label, length, b, mode)
        arg = DR.argument_bytes(c, shape, one_card, rules_for(c), m,
                                cache_dtype=torch.float32, context_len=context)["total"]
        fits = arg <= torch.cuda.get_device_properties(0).total_memory
        log(phase, f"| {label} | {arch} | {c.num_layers} | {b} x {length} | "
            f"{main['bound_s'] * 1e3:.3f} ms ({main['bottleneck']}) | "
            + (f"{dec['bound_s'] * 1e3:.3f} ms ({dec['bottleneck']})" if dec else "—")
            + f" | {arg / 1e9:.2f} | {'yes' if fits else 'no'} | "
            f"({time.perf_counter() - t0:.1f} s)")
    return total


def train(card: str) -> dict[str, int]:
    """The training phase; returns rank 0's launch counts of the CLI run."""
    from repro_torch.launch import ranks
    from repro_torch.launch import train as train_cli
    from repro_torch.models import get_config

    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    grad_check(cfg)
    torch.cuda.empty_cache()
    log("train", f"grad check {time.perf_counter() - t0:.1f} s")

    sizes = leaf_sizes()
    comms = train_comms()
    per_step = {k: len(planned_merges(sizes, c)) for k, c in comms.items()}
    log("train", f"{len(sizes)} gradient leaves, {sum(sizes) / 1e6:.1f}M elements; "
        f"chunk_combine launches per step per rank: {per_step}")

    # (a) sync="xla" vs sync="r2ccl" from one seed
    t0 = time.perf_counter()
    runs = ranks.run(parity_rank, WORLD, "cuda", args=(None,))
    xla, r2 = runs[0]["xla"], runs[0]["r2ccl"]
    g = max((r["grads"] for r in runs), key=lambda x: x["rel"])
    log("train", f"step 0's synced gradients, r2ccl (bf16 wire, degraded rank 1, lost "
        f"0.5, g 2) vs xla (fp32), worst leaf of {WORLD} ranks: {g['worst']} "
        f"||diff||/||g_xla|| = {g['rel']:.3e} (tol {SYNC_GRAD_TOL}); a rank's own "
        f"gradient is at least {min(r['grads']['own'] for r in runs):.3e} from the mean")
    if not g["rel"] <= SYNC_GRAD_TOL:
        raise RuntimeError(f"synced gradients r2ccl vs xla: {g}")
    d_loss = max(abs(a - b) for a, b in zip(xla["losses"], r2["losses"]))
    want = {"xla": counts(**layer_launches(cfg, TRAIN_STEPS)),
            "r2ccl": counts(**layer_launches(cfg, TRAIN_STEPS),
                            chunk_combine=per_step["parity"] * TRAIN_STEPS)}
    for name, run in (("xla", xla), ("r2ccl", r2)):
        if run["launches"] != want[name]:
            raise RuntimeError(f"{name} run launches {run['launches']} on rank 0, "
                               f"want {want[name]}")
        log("train", f"{name}: losses {[round(x, 6) for x in run['losses']]}; per step "
            f"(steps 1-{TRAIN_STEPS - 1}): {split(run['stats'][1:])}; launches on rank 0 "
            f"{run['launches']} (as predicted); peak memory per rank "
            f"{[round(r[name]['max_memory_allocated'] / 2**30, 2) for r in runs]} GiB")
    if not (np.isfinite(xla["losses"] + r2["losses"]).all() and d_loss <= PARITY_TOL
            and r2["param_diff"] <= PARITY_TOL):
        raise RuntimeError(f"xla vs r2ccl: loss diff {d_loss}, param diff "
                           f"{r2['param_diff']} (tol {PARITY_TOL})")
    log("train", f"xla vs r2ccl (degraded rank 1, lost 0.5, g 2): max loss diff "
        f"{d_loss:.2e}, max param diff {r2['param_diff']:.2e} (tol {PARITY_TOL}); "
        f"{time.perf_counter() - t0:.1f} s")

    # (b) the training CLI: ring, NIC failure on node 1 at step 2 -> degraded r2ccl
    t0 = time.perf_counter()
    res = train_cli.main([
        "--arch", ARCH, "--world-size", str(WORLD), "--seq-len", str(SEQ),
        "--batch", str(WORLD * LOCAL_BATCH), "--steps", str(TRAIN_STEPS),
        "--sync", "r2ccl", "--comm-mode", "ring", "--fail-at-step", str(FAIL_AT),
        "--fail-node", "1", "--nics-per-node", str(CLI_NICS), "--log-every", "1"])
    scheds = ["healthy"] * FAIL_AT + ["degraded"] * (TRAIN_STEPS - FAIL_AT)
    want_cli = counts(**layer_launches(cfg, TRAIN_STEPS),
                      chunk_combine=per_step["ring"] * FAIL_AT
                      + per_step["degraded"] * (TRAIN_STEPS - FAIL_AT))
    if res["scheds"] != scheds or res["located"] is None \
            or not np.isfinite(res["history"]).all():
        raise RuntimeError(f"failover run: schedules {res['scheds']}, located "
                           f"{res['located']}, losses {res['history']}")
    if res["launches"] != want_cli:
        raise RuntimeError(f"CLI run launches {res['launches']} on rank 0, want {want_cli}")
    st = res["stats"]
    log("train", f"CLI failover: schedules {res['scheds']}, failure located at "
        f"{res['located']}, losses {[round(x, 6) for x in res['history']]}; launches on "
        f"rank 0 {res['launches']} (as predicted)")
    log("train", f"CLI per step: ring (step 1) {split(st[1:FAIL_AT])}; degraded r2ccl "
        f"(step {TRAIN_STEPS - 1}) {split(st[-1:])}; peak memory per rank "
        f"{[round(r['max_memory_allocated'] / 2**30, 2) for r in res['ranks']]} GiB "
        f"[{WORLD} ranks on one card, {LOCAL_BATCH} x {SEQ} tokens each; {card}]")
    log("train", f"CLI run {time.perf_counter() - t0:.1f} s")
    return res["launches"]


def generate(params, cfg, batch: dict, new: int, context: int, impl: str,
             forced: torch.Tensor | None = None) -> dict:
    """``apply_model`` prefill over ``batch`` (patches and tokens), then
    ``new - 1`` greedy decode steps, each timed on the host clock after a
    synchronize.  With ``forced`` (B, new) tokens, decode is fed those
    instead of its own argmax (the plain run replays the kernels' run, so
    that every step's argmax can be compared).  Returns the tokens (B, new),
    each step's last-position float32 logits (B, new, V), TTFT, TPOT and the
    launch counts of the prefill and of the decode."""
    from repro_torch.kernels import ops
    from repro_torch.models import apply_model, init_caches
    B = batch["tokens"].shape[0]
    caches = init_caches(cfg, B, context, dtype=torch.float32, device="cuda")
    toks, logits = [], []
    with torch.no_grad():
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, caches, _ = apply_model(params, cfg, batch, mode="prefill", caches=caches,
                                     kernel_impl=impl)
        nxt = out[:, -1].argmax(-1)
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        prefill_launches = ops.launch_counts()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for i in range(new):
            toks.append(nxt)
            logits.append(out[:, -1].float())
            if i == new - 1:
                break
            feed = nxt if forced is None else forced[:, i]
            out, caches, _ = apply_model(params, cfg, {"tokens": feed[:, None]},
                                         mode="decode", caches=caches, kernel_impl=impl)
            nxt = out[:, -1].argmax(-1)
        torch.cuda.synchronize()
        tpot = (time.perf_counter() - t0) / max(new - 1, 1)
    return dict(tokens=torch.stack(toks, 1), logits=torch.stack(logits, 1), ttft=ttft,
                tpot=tpot, prefill_launches=prefill_launches,
                decode_launches=ops.launch_counts())


def serve_paligemma(card: str) -> dict[str, int]:
    """paligemma-3b at full width and depth: prefill over 256 image-patch
    embeddings and 256 text tokens, then greedy decode, through
    ``apply_model`` (the serving engine feeds tokens only, as the JAX
    package's).  Launches: one flash forward per layer per prefill, none in
    decode.  Kernels against their plain versions: with a float32 residual
    stream the plain run replays the kernels' tokens and its argmax must
    agree at every step whose top-2 margin exceeds LOGIT_ATOL_F32 (so a
    free greedy run gives the same tokens), and the prefill logits agree
    within LOGIT_ATOL_F32; with the config's bf16, the prefill logits
    within the phase's LOGIT_ATOL.  Returns the served run's launch
    counts (prefill and decode)."""
    from repro_torch.data import make_batch
    from repro_torch.models import get_config, init_model
    from repro_torch.tree import leaves

    phase = "serve_paligemma"
    arch, batch, text, new, context = PALIGEMMA
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    P = cfg.modality.num_prefix_tokens
    a = cfg.attention
    log(phase, f"{arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, {a.num_heads}/"
        f"{a.num_kv_heads} heads of {a.head_dim}, {P} image patches of "
        f"{cfg.modality.frontend_dim} as a bidirectional prefix, {n_params / 1e6:.1f}M fp32 "
        f"params ({4 * n_params / 1e9:.1f} GB), init {time.perf_counter() - t0:.2f} s")
    b = make_batch(cfg, seq_len=P + text, batch_size=batch, step=0)
    feed = {k: torch.from_numpy(b[k]).cuda() for k in ("patches", "tokens")}

    generate(params, cfg, feed, 2, context, "auto")      # warm-up
    run = generate(params, cfg, feed, new, context, "auto")
    want = counts(flash_attention=cfg.num_layers)
    if run["prefill_launches"] != want or run["decode_launches"] != counts():
        raise RuntimeError(f"launches: prefill {run['prefill_launches']} (want {want}), "
                           f"decode {run['decode_launches']} (want none)")
    toks = run["tokens"]
    if not (toks.shape == (batch, new) and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())):
        raise RuntimeError(f"bad tokens {toks.tolist()}")
    log(phase, f"TTFT {run['ttft'] * 1e3:.3f} ms, TPOT {run['tpot'] * 1e3:.3f} ms [B={batch}, "
        f"{P} patches + {text} text tokens, {new} new tokens, {cfg.dtype} residual "
        f"stream; {card}]; launches per prefill {run['prefill_launches']}, in decode "
        f"{run['decode_launches']} (as predicted); first tokens of request 0: "
        f"{toks[0, :8].tolist()}")
    log(phase, share_text("TTFT", run["ttft"], dry_bound(cfg, "prefill", batch, P + text,
                                                        context))
        + "; " + share_text("TPOT", run["tpot"], dry_bound(cfg, "decode", batch, P + text,
                                                           context)) + f" [{card}]")

    c32 = dataclasses.replace(cfg, dtype="float32")
    kern = generate(params, c32, feed, new, context, "auto")
    plain = generate(params, c32, feed, new, context, "reference", forced=kern["tokens"])
    top2 = plain["logits"].topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > LOGIT_ATOL_F32
    same = plain["logits"].argmax(-1) == kern["tokens"]
    err = (kern["logits"][:, 0] - plain["logits"][:, 0]).abs().max().item()
    log(phase, f"float32 residual stream, kernels vs plain: prefill logits "
        f"max_abs_err={err:.3e} (tol {LOGIT_ATOL_F32}); greedy tokens: the plain run "
        f"replaying the kernels' {new} tokens picks the same at {int(same.sum())} of "
        f"{same.numel()} steps (all steps whose top-2 margin exceeds {LOGIT_ATOL_F32}: "
        f"{bool(same[decided].all())}; {int((~decided).sum())} ties)")
    if err > LOGIT_ATOL_F32 or not bool(same[decided].all()):
        raise RuntimeError(f"{arch} kernels vs plain, float32: prefill logits err {err}, "
                           f"tokens {kern['tokens'].tolist()} vs plain argmax "
                           f"{plain['logits'].argmax(-1).tolist()}")
    del kern, plain
    tol = LOGIT_ATOL[phase]
    lk = generate(params, cfg, feed, 1, context, "auto")["logits"][:, 0]
    lp = generate(params, cfg, feed, 1, context, "reference")["logits"][:, 0]
    err = (lk - lp).abs().max().item()
    log(phase, f"{cfg.dtype} residual stream, kernels vs plain: prefill logits "
        f"max_abs_err={err:.3e} (tol {tol}; logits span {lp.min().item():.3f}.."
        f"{lp.max().item():.3f})")
    if not (torch.isfinite(lk).all() and err <= tol):
        raise RuntimeError(f"{arch} prefill logits kernel vs plain, {cfg.dtype}: {err}")
    log(phase, f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        f"(torch.cuda.max_memory_allocated)")
    del params, lk, lp
    torch.cuda.empty_cache()
    return {k: run["prefill_launches"][k] + run["decode_launches"][k] for k in KERNELS}


def serve_hubert(card: str) -> dict[str, int]:
    """hubert-xlarge at full width and depth: the encoder's forward
    (``apply_model`` in train mode under no_grad; the model is encoder-only)
    over 4 clips of 1024 frame embeddings, one flash forward per layer, its
    logits through the kernels against the plain versions with a float32
    residual stream (LOGIT_ATOL_F32) and the config's bf16 (the phase's
    LOGIT_ATOL).  Returns the launch counts of the timed forward."""
    from repro_torch.data import make_batch
    from repro_torch.kernels import ops
    from repro_torch.models import apply_model, get_config, init_model
    from repro_torch.tree import leaves

    phase = "serve_hubert"
    arch, batch, frames = HUBERT
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    a = cfg.attention
    log(phase, f"{arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, {a.num_heads} "
        f"heads of {a.head_dim}, non-causal, no rope, frames of {cfg.modality.frontend_dim}, "
        f"{n_params / 1e6:.1f}M fp32 params ({4 * n_params / 1e9:.1f} GB), init "
        f"{time.perf_counter() - t0:.2f} s")
    feed = {"frames": torch.from_numpy(
        make_batch(cfg, seq_len=frames, batch_size=batch, step=0)["frames"]).cuda()}

    def encode(c, impl):
        with torch.no_grad():
            return apply_model(params, c, feed, mode="train", kernel_impl=impl)[0].float()

    encode(cfg, "auto")                                   # warm-up
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = encode(cfg, "auto")
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    if launches != counts(flash_attention=cfg.num_layers):
        raise RuntimeError(f"launches {launches}, want {cfg.num_layers} flash_attention")
    log(phase, f"encoder forward {fwd_ms:.3f} ms [B={batch} clips of {frames} frames, "
        f"{cfg.dtype} residual stream; {card}]; launches {launches} (as predicted)")
    # the same forward counted on the meta device
    from repro_torch.launch.cost_analysis import roofline_terms
    from repro_torch.launch.dryrun import count
    meta, meta_feed = init_model(cfg, device="meta"), {
        k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in feed.items()}
    with torch.no_grad():
        tr = count(lambda: apply_model(meta, cfg, meta_feed, mode="train"))
    log(phase, share_text("encoder forward", fwd_ms / 1e3, roofline_terms(
        flops_per_device=tr.flops_by_class, hbm_bytes_per_device=tr.hbm_bytes,
        wire_bytes_per_device=0.0, chips=1)) + f" [{card}]")
    for dtype, tol in (("float32", LOGIT_ATOL_F32), (cfg.dtype, LOGIT_ATOL[phase])):
        c = dataclasses.replace(cfg, dtype=dtype)
        got, want = encode(c, "auto"), encode(c, "reference")
        if not (got.shape == (batch, frames, cfg.vocab_size) and torch.isfinite(got).all()):
            raise RuntimeError(f"{arch} logits: shape {tuple(got.shape)} or non-finite")
        err = (got - want).abs().max().item()
        log(phase, f"encoder logits through the kernels vs their plain versions, {dtype} "
            f"residual stream, all {batch * frames} frames: max_abs_err={err:.3e} (tol "
            f"{tol}; logits span {want.min().item():.3f}..{want.max().item():.3f})")
        if err > tol:
            raise RuntimeError(f"{arch} logits kernel vs plain, {dtype}: {err} > {tol}")
    log(phase, f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        f"(torch.cuda.max_memory_allocated)")
    del params, out, got, want
    torch.cuda.empty_cache()
    return launches


def r2ccl_rank(rank: int, world: int, device: str, arch: str, layers: int) -> dict:
    """One rank of a 4-rank R2CCL run of ``arch``: full width, ``layers``
    layers, the training CLI's two pre-built steps (a ring, then after a NIC
    failure on node 1 at step FAIL_AT the degraded R2CCL program of
    CLI_NICS NICs a node) with its optimizer and schedule (AdamW lr 1e-3,
    warmed up over 100 steps, so step 0's scale is 0), and the same batch
    every step (this rank's rows of step 0's), so that the losses compare.
    Returns losses, per-step stats, launches and peak memory."""
    from repro_torch.core.collectives import DataAxis
    from repro_torch.kernels import ops
    from repro_torch.models import get_config, init_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    dev = torch.device("cuda:0")
    axis = DataAxis()
    state = init_train_state(init_model(cfg, seed=0, device=dev))
    steps = {name: make_train_step(cfg, AdamWConfig(lr=1e-3), sync="r2ccl", comm=comm,
                                   axis=axis)
             for name, comm in train_comms().items() if name != "parity"}
    batch = rank_batch(cfg, rank, 0, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    losses, grad_norms, stats, scheds = [], [], [], []
    for i in range(TRAIN_STEPS):
        active = "ring" if i < FAIL_AT else "degraded"
        st: dict[str, float] = {}
        t0 = time.perf_counter()
        state, m = steps[active](state, batch, stats=st)
        losses.append(float(m["loss"]))
        grad_norms.append(float(m["grad_norm"]))
        st["step_s"] = time.perf_counter() - t0
        stats.append(st)
        scheds.append(active)
    return dict(losses=losses, grad_norms=grad_norms, stats=stats, scheds=scheds,
                launches=ops.launch_counts(),
                max_memory_allocated=torch.cuda.max_memory_allocated(dev))


def r2ccl_run(card: str, phase: str, arch: str, layers: int, rows: str) -> dict[str, int]:
    """``arch`` at full width and ``layers`` layers on WORLD ranks sharing
    the card (``r2ccl_rank``): a ring switched to the degraded R2CCL program
    after a NIC failure on node 1 at step FAIL_AT, the same batch every
    step.  Every loss and gradient norm must be finite and equal on every
    rank, the loss must fall, and rank 0's launches must be the plan's:
    the layers' kernels (``layer_launches``) and chunk_combine once a
    program step a gradient leaf.  Returns rank 0's launch counts."""
    from repro_torch.launch import ranks
    from repro_torch.models import get_config

    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    sizes = leaf_sizes(cfg)
    comms = train_comms()
    per_step = {k: len(planned_merges(sizes, comms[k])) for k in ("ring", "degraded")}
    t0 = time.perf_counter()
    runs = ranks.run(r2ccl_rank, WORLD, "cuda", args=(arch, layers))
    r0 = runs[0]
    want = counts(**layer_launches(cfg, TRAIN_STEPS),
                  chunk_combine=per_step["ring"] * FAIL_AT
                  + per_step["degraded"] * (TRAIN_STEPS - FAIL_AT))
    losses = r0["losses"]
    log(phase, f"{cfg.name}: {layers} of {get_config(arch).num_layers} layers (full width, "
        f"depth cut), {sum(sizes) / 1e6:.1f}M params in {len(sizes)} leaves, {WORLD} ranks "
        f"on one card, {LOCAL_BATCH} {rows} of {SEQ} each, the same batch every step; "
        f"schedules {r0['scheds']} (NIC failure on node 1 at step {FAIL_AT}, {CLI_NICS} NICs "
        f"a node); losses {[round(x, 6) for x in losses]}; gradient norms "
        f"{[round(x, 4) for x in r0['grad_norms']]}; launches on rank 0 {r0['launches']}")
    log(phase, f"per step: ring (step 1) {split(r0['stats'][1:FAIL_AT])}; degraded r2ccl "
        f"(step {TRAIN_STEPS - 1}) {split(r0['stats'][-1:])}; peak memory per rank "
        f"{[round(r['max_memory_allocated'] / 2**30, 2) for r in runs]} GiB [{card}]")
    if not (np.isfinite(losses + r0["grad_norms"]).all() and losses[-1] < losses[0]
            and all(r["losses"] == losses and r["grad_norms"] == r0["grad_norms"]
                    for r in runs)):
        raise RuntimeError(f"{cfg.name} r2ccl run: losses {[r['losses'] for r in runs]}, "
                           f"gradient norms {[r['grad_norms'] for r in runs]} (want finite, "
                           "the loss falling, equal on every rank)")
    if r0["launches"] != want:
        raise RuntimeError(f"{cfg.name} r2ccl run launches {r0['launches']} on rank 0, "
                           f"want {want}")
    log(phase, f"{cfg.name} r2ccl run {time.perf_counter() - t0:.1f} s; losses and "
        f"gradients finite, the loss falling, launches as predicted")
    return r0["launches"]


def train_frontends(card: str) -> dict[str, int]:
    """Full-depth gradient checks of paligemma-3b and hubert-xlarge (one
    rank, kernels vs plain, float32 and bf16 residual streams), then
    hubert-xlarge on 4 ranks sharing the card with R2CCL sync and a NIC
    failure: full width, HUBERT_TRAIN_LAYERS of its 48 layers (weights,
    gradients, two AdamW moments and a bf16 wire copy are ~18 bytes a
    parameter: 17 GB a rank at full depth, 68 GB for four).  Returns rank
    0's launch counts of the 4-rank run."""
    from repro_torch.models import get_config

    phase = "train_frontends"
    for arch in ("paligemma-3b", HUBERT[0]):
        t0 = time.perf_counter()
        grad_check(get_config(arch), phase)
        torch.cuda.empty_cache()
        log(phase, f"{arch} grad check {time.perf_counter() - t0:.1f} s")
    return r2ccl_run(card, phase, HUBERT[0], HUBERT_TRAIN_LAYERS, "clips")


def train_recurrent(card: str) -> dict[str, int]:
    """The recurrent families trained through the scans' forward and
    backward kernels: one rank's full-width gradients (kernels vs plain,
    float32 and bf16 residual streams) of recurrentgemma-9b at
    RG_GRAD_LAYERS layers and rwkv6-1.6b at full depth, then rwkv6-1.6b at
    full width and RWKV_TRAIN_LAYERS layers on 4 ranks sharing the card
    with R2CCL sync and a NIC failure.  Returns the launch counts of the
    kernel runs of both gradient checks and of rank 0 of the 4-rank run."""
    from repro_torch.models import get_config

    phase = "train_recurrent"
    launched = counts()
    for cfg in (dataclasses.replace(get_config("recurrentgemma-9b"),
                                    num_layers=RG_GRAD_LAYERS),
                get_config("rwkv6-1.6b")):
        t0 = time.perf_counter()
        got = grad_check(cfg, phase)
        launched = {k: launched[k] + got[k] for k in launched}
        torch.cuda.empty_cache()
        log(phase, f"{cfg.name} grad check ({cfg.num_layers} layers) "
            f"{time.perf_counter() - t0:.1f} s")
    got = r2ccl_run(card, phase, "rwkv6-1.6b", RWKV_TRAIN_LAYERS, "sequences")
    return {k: launched[k] + got[k] for k in launched}


#: the recovery_sim phase's co-simulated cluster: 4 nodes of 4 InfiniBand
#: NICs (50 GB/s each), a ring AllReduce of 1 GB, and the buffer each of
#: the 4 gloo ranks then reduces through the swapped-in program
RECOVERY_NODES, RECOVERY_RAILS, RECOVERY_PAYLOAD = 4, 4, 1e9
RECOVERY_ELEMS = 1 << 22           # fp32 elements a rank (16 MiB)
#: ``python -m repro_torch.analysis cost --corpus`` on the builder corpus:
#: every lockstep-uniform entry priced to the bit of the event engine's time
CORPUS_LINE = "210 entries, 182 lockstep-uniform (182 bit-exact)"
#: the paper's training-overhead job (2.7B parameters, 16-way data
#: parallel on two 8-GPU InfiniBand servers), 8 gradient syncs with one NIC
#: failure mid-campaign
PAPER_JOB = dict(params=2.7e9, dp=16, tp=1, pp=1, global_batch=256, seq_len=2048,
                 layers=32, hidden=2560, nic_stripe=3)


def recovery_data(world: int, elems: int) -> list[np.ndarray]:
    """Integer-valued fp32 buffers, one a rank, from seed 0: every sum of
    four is exact, so any order of reduction gives the same bits."""
    rng = np.random.default_rng(0)
    return [rng.integers(-64, 64, size=elems).astype(np.float32) for _ in range(world)]


def recovery_failures(failures, t_h: float) -> list:
    """A NIC of node 1 dies a tenth of the way into the collective, then the
    node's second NIC flaps four times; the third flap inside the window
    makes the control plane re-select the algorithm mid-collective, with
    node 1 at half its bandwidth."""
    return [failures.nic_down_at(1, 0, 0.1 * t_h),
            *failures.flap_sequence(1, 1, start=0.15 * t_h, period=0.12 * t_h,
                                    down_for=0.04 * t_h, count=4)]


def check_recovery_merges(gen, merges: list[tuple[int, int]]) -> None:
    """chunk_combine against its plain version at every (rows, M) the
    swapped-in programs merge, fp32, each (seg, acc) pair (tol 0: one fp32
    add); then the kernel's, the plain version's and in-place torch.add's
    time at the largest, beside its bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.chunk_combine import chunk_combine_cuda
    from repro_torch.launch import cost_analysis as CA
    from repro_torch.launch.profile_kernels import device_ms, host_ms

    for rows, M in sorted(set(merges)):
        for s, a in ((1, 1), (1, 0), (0, 1), (0, 0)):
            local = torch.randn(rows, M, device="cuda", generator=gen)
            recv = torch.randn(rows, M, device="cuda", generator=gen)
            want = ref.reference_chunk_combine(local, recv, [s] * rows, [a] * rows)
            got = chunk_combine_cuda(local, recv, [s] * rows, [a] * rows, out=local)
            if not torch.equal(got, want):
                raise RuntimeError(f"chunk_combine ({rows}, {M}) seg={s} acc={a}: max_abs_err "
                                   f"{(got - want).abs().max().item()} (tol 0)")
    rows, M = max(merges, key=lambda rm: rm[0] * rm[1])
    local = torch.randn(rows, M, device="cuda", generator=gen)
    recv = torch.randn(rows, M, device="cuda", generator=gen)
    seg = acc = [1] * rows
    t_kernel = time_ms(lambda: chunk_combine_cuda(local, recv, seg, acc, out=local))
    t_plain = time_ms(lambda: ref.reference_chunk_combine(local, recv, seg, acc))
    t_lib = time_ms(lambda: torch.add(local, recv, out=local))
    dev = {n: sum(device_ms(fn).values()) or None for n, fn in (
        ("kernel", lambda: chunk_combine_cuda(local, recv, seg, acc, out=local)),
        ("torch.add", lambda: torch.add(local, recv, out=local)))}
    host = host_ms(lambda: chunk_combine_cuda(local, recv, seg, acc, out=local))
    bound = CA.chunk_combine_cost((rows, M), torch.float32, seg, acc).bound()["bound_ms"]
    log("recovery_sim", f"chunk_combine at the swapped-in programs' {len(set(merges))} merge "
        f"shapes {sorted(set(merges))} fp32, every seg/acc pair: max_abs_err=0 (tol 0); at "
        f"the largest ({rows}, {M}): kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms, "
        f"in-place torch.add {t_lib:.4f} ms (events, back to back: the "
        f"{3 * rows * M * 4 / 1e6:.1f} MB stay in L2); device time per call "
        + ", ".join(f"{n} {fmt_ms(t)}" for n, t in dev.items())
        + f"; the kernel's host time per call {host:.4f} ms; bound {bound:.4f} ms (bytes)")


def recovery_rank(rank: int, world: int, device: str, programs: tuple, elems: int) -> dict:
    """One rank of the swapped-in programs' run: this rank's buffer of
    ``recovery_data`` through each program (``core.collectives``, every
    round merged by chunk_combine), held to ``executor_np``'s result for
    this rank.  Returns the mismatched elements, host seconds and launch
    counts."""
    from repro_torch.core import executor_np
    from repro_torch.core.collectives import DataAxis, execute_program
    from repro_torch.kernels import ops

    dev = torch.device("cuda:0")
    data = recovery_data(world, elems)
    axis = DataAxis()
    x = torch.from_numpy(data[rank]).to(dev)
    ops.reset_launch_counts()
    wrong, seconds = [], []
    for prog in programs:
        t0 = time.perf_counter()
        y = execute_program(x, prog, axis)
        torch.cuda.synchronize(dev)
        seconds.append(time.perf_counter() - t0)
        want = executor_np.execute_program(prog, data)[rank]
        wrong.append(int((y.cpu().numpy() != want).sum()))
    return dict(wrong=wrong, seconds=seconds, launches=ops.launch_counts())


def recovery_sim(card: str) -> dict[str, int]:
    """The framework-free recovery runtime on the card's machine, which has
    no JAX: the analysis gate and the cost conformance sweep; a ring
    AllReduce co-simulated through a mid-collective NIC failure with the
    control plane replanning (``score`` alpha_beta, then static) and its
    payloads held to ``all_reduce_oracle``; each program the control plane
    swapped in run on WORLD gloo ranks with the rank buffers on the card,
    every round merged by chunk_combine, equal to ``executor_np``; and the
    training-campaign overhead of the paper's job.  Returns rank 0's launch
    counts of the gloo run."""
    from repro_torch.analysis.__main__ import main as analysis
    from repro_torch.core import comm_sim, executor_np, failures, topology
    from repro_torch.core.event_sim import simulate_program
    from repro_torch.core.schedule import ring_program
    from repro_torch.launch import ranks
    from repro_torch.runtime import (ControlPlane, Scenario, run_scenario,
                                     training_campaign_report)

    phase = "recovery_sim"
    for argv in ([], ["cost", "--corpus", "--out",
                      str(REPO / "build" / "analysis" / "cost_report.json")]):
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = analysis(argv)
        lines = buf.getvalue().splitlines()
        shown = [ln for ln in lines if ln.startswith(("verified", "lint", "cost conformance"))]
        log(phase, f"python -m repro_torch.analysis {' '.join(argv[:2]) or '(verify, lint)'}: "
            f"exit {rc}; "
            f"{'; '.join(shown)}; {time.perf_counter() - t0:.2f} s on the host")
        if rc != 0 or not shown:
            raise RuntimeError(f"repro_torch.analysis {argv} exited {rc}:\n" + "\n".join(lines))
    if not any(CORPUS_LINE in ln for ln in shown):
        raise RuntimeError(f"cost --corpus: want {CORPUS_LINE!r}, got {shown}")

    n = RECOVERY_NODES
    cluster = topology.make_cluster(n, RECOVERY_RAILS, nic_bandwidth=topology.IB_NIC_BW)
    t_h = simulate_program(ring_program(list(range(n)), n), RECOVERY_PAYLOAD,
                           cluster=cluster).completion_time
    data = recovery_data(n, RECOVERY_ELEMS)
    oracle = executor_np.all_reduce_oracle(data)
    swapped = []
    for score in ("alpha_beta", "static"):
        t0 = time.perf_counter()
        cp = ControlPlane(cluster, payload_bytes=RECOVERY_PAYLOAD, replan=True, score=score)
        rep = run_scenario(Scenario("nic_down_then_flaps",
                                    tuple(recovery_failures(failures, t_h))),
                           cluster, RECOVERY_PAYLOAD, healthy_time=t_h, rank_data=data,
                           control_plane=cp, verify_replans=True)
        secs = time.perf_counter() - t0
        progs = [d.replan for d in rep.decisions if d.replan is not None]
        exact = all(np.array_equal(r, oracle) for r in rep.report.rank_data)
        log(phase, f"co-simulated ring AllReduce of {RECOVERY_PAYLOAD:.0e} B on {n} nodes x "
            f"{RECOVERY_RAILS} NICs, node 1's NIC 0 down at 0.1 of the healthy "
            f"{t_h * 1e3:.4f} ms, then 4 flaps of its NIC 1; replan=True score={score}: "
            f"{rep.report.replans} mid-collective replan(s) to "
            f"{[p.name for p in progs]} ({[len(p.segments) for p in progs]} segments), "
            f"ledger strategies {[e.strategy for e in rep.ledger.entries]}, completion "
            f"{rep.report.completion_time * 1e3:.4f} ms (overhead {rep.overhead:.4f}), "
            f"ledger total {rep.ledger.total_latency() * 1e3:.4f} ms, final state "
            f"{rep.final_state.value}; {RECOVERY_ELEMS} fp32 elements a rank equal "
            f"all_reduce_oracle: {exact}; {secs:.2f} s on the host")
        if not (progs and rep.report.replans >= 1 and exact):
            raise RuntimeError(f"co-simulation score={score}: replans {rep.report.replans}, "
                               f"swapped {progs}, payloads exact {exact}")
        swapped.append(progs[0])

    merges = [m for p in swapped for m in program_merges(p, RECOVERY_ELEMS)]
    check_recovery_merges(torch.Generator(device="cuda").manual_seed(1), merges)
    t0 = time.perf_counter()
    runs = ranks.run(recovery_rank, WORLD, "cuda", args=(tuple(swapped), RECOVERY_ELEMS))
    want = counts(chunk_combine=len(merges))
    r0 = runs[0]
    log(phase, f"the swapped-in programs {[p.name for p in swapped]} on {WORLD} gloo ranks, "
        f"{RECOVERY_ELEMS} fp32 elements a rank on the card (host-staged wire): elements "
        f"unequal to executor_np per rank {[r['wrong'] for r in runs]}; host seconds on "
        f"rank 0 {[round(s, 4) for s in r0['seconds']]}; launches on rank 0 "
        f"{r0['launches']} (planned chunk_combine {len(merges)}); "
        f"{time.perf_counter() - t0:.1f} s with the ranks' start [{card}]")
    if any(any(r["wrong"]) for r in runs):
        raise RuntimeError(f"swapped-in programs differ from executor_np: "
                           f"{[r['wrong'] for r in runs]}")
    if r0["launches"] != want:
        raise RuntimeError(f"gloo run launches {r0['launches']} on rank 0, want {want}")

    t0 = time.perf_counter()
    job = comm_sim.TrainJob(**PAPER_JOB, flops_per_chip=comm_sim.H100_BF16_FLOPS)
    res = training_campaign_report(
        job, topology.make_cluster(2, 8, nic_bandwidth=topology.IB_NIC_BW),
        failures.single_nic_failure(0, 0), iterations=8)
    log(phase, f"training_campaign_report (2.7B params, dp 16 on 2 x 8 GPUs, 8 syncs, one "
        f"NIC failure at sync 4): overhead {res.overhead:.6f}, recovery cost "
        f"{res.recovery_cost * 1e3:.4f} ms from the ledger, DP sync "
        f"{min(res.dp_comm_times) * 1e3:.4f}-{max(res.dp_comm_times) * 1e3:.4f} ms; "
        f"{time.perf_counter() - t0:.2f} s on the host")
    if not 0.0 < res.overhead < 0.01:
        raise RuntimeError(f"training campaign overhead {res.overhead}, want (0, 0.01)")
    return r0["launches"]


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
    from repro_torch.models import get_config

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
    t0 = time.perf_counter()
    rows = [check_flash_attention(gen), check_flash_attention_bwd(gen),
            check_chunk_combine(gen), check_lru_scan(gen), check_wkv_scan(gen),
            check_lru_scan_bwd(gen), check_wkv_scan_bwd(gen)]
    log("kernels", f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    by_path = {}
    t0 = time.perf_counter()
    by_path["serve"] = serve(card, "serve", ARCH, BATCH, PROMPT, CONTEXT,
                             dict(flash_attention=get_config(ARCH).num_layers),
                             LOGIT_ATOL["serve"])
    log("serve", f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["roofline"] = roofline(card)
    log("roofline", f"{time.perf_counter() - t0:.1f} s")
    for phase, (arch, batch, prompt, context, per_prefill) in RECURRENT.items():
        t0 = time.perf_counter()
        by_path[phase] = serve(card, phase, arch, batch, prompt, context, per_prefill,
                               LOGIT_ATOL[phase])
        log(phase, f"{time.perf_counter() - t0:.1f} s")
    for phase, (arch, layers, batch, prompt, context, per_prefill) in GQA.items():
        t0 = time.perf_counter()
        by_path[phase] = serve(card, phase, arch, batch, prompt, context, per_prefill,
                               LOGIT_ATOL[phase], layers=layers)
        log(phase, f"{time.perf_counter() - t0:.1f} s")
    for phase, (arch, layers, batch, prompt, context, per_prefill,
                overrides) in MLA_PHASES.items():
        t0 = time.perf_counter()
        by_path[phase] = serve(card, phase, arch, batch, prompt, context, per_prefill,
                               LOGIT_ATOL[phase], layers=layers, overrides=overrides)
        log(phase, f"{time.perf_counter() - t0:.1f} s")
    for phase, fn in (("serve_paligemma", serve_paligemma), ("serve_hubert", serve_hubert)):
        t0 = time.perf_counter()
        by_path[phase] = fn(card)
        log(phase, f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["train"] = train(card)
    log("train", f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["train_frontends"] = train_frontends(card)
    log("train_frontends", f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["train_recurrent"] = train_recurrent(card)
    log("train_recurrent", f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["recovery_sim"] = recovery_sim(card)
    log("recovery_sim", f"{time.perf_counter() - t0:.1f} s")
    for row in rows:
        row["launches_by_path"] = {p: c[row["name"]] for p, c in by_path.items()}
        row["launches"] = row["launches_by_path"][MAIN_PATH[row["name"]]]
    log("done", f"{time.perf_counter() - t_start:.1f} s in all")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
