"""Time layouts of the ``wkv_scan_bwd`` kernel against each other, on the card:

  PYTHONPATH=src python -m repro_torch.launch.sweep_wkv_scan_bwd

Each layout is ``csrc/wkv_scan_bwd.cu`` with its constants ``kCols`` (state
columns a CTA, so ``K / kCols`` CTAs a cluster), ``kCpt`` (columns a
thread), ``kSteps`` (steps whose partial sums are reduced over lanes at
once), ``kHist`` (steps whose states a thread holds in registers: the
chunk is replayed in ``16 / kHist`` parts), ``kExch`` (chunks whose
partials cross the cluster at once) and ``kMinBlocks`` (CTAs an SM that
the register budget must allow) replaced.  The copies are built in parallel under
``build/wkv_scan_bwd_sweep/`` and run at rwkv6-1.6b's training shape (2,
512, 32, 64) fp32, from the forward kernel's per-chunk states, as training
calls it (no gradient of s_T, none of s0 asked).  Each is checked against
``ref.reference_wkv_bwd`` there and at two small shapes with the other head
sizes, hard decays and a gradient of s_T (the largest error over max(1,
max |grad|), as ``chip_smoke.py``'s ``SCAN_BWD_RTOL`` reads it, and two
calls giving the same bits), and timed by CUDA events and by the profiler's
device time (every kernel of the call, the ticket's memset included), in two
rounds (the list, then the list reversed), so that drift over the call
shows.  One JSON line a layout, after the card's name and power limit, with
ptxas's registers and spills, its shared memory a CTA, the clusters the
card holds at once (``cudaOccupancyMaxActiveClusters``) and the time of one
(b, h) alone (B = H = 1: the latency of the walk, the card otherwise idle).
A layout whose launch the card refuses (shared memory, cluster) is printed
as refused, with its shared memory, and left out.

``ABLATIONS`` are the committed layout with one stage taken out (its
source text replaced), timed only: their gradients are wrong by design,
and what their time drops by is what that stage costs.  Needs ``nvcc``
and a CUDA device.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import reference_wkv_bwd
from repro_torch.kernels.wkv_scan import CHUNK, wkv_scan_cuda
from repro_torch.launch.profile_kernels import WKV_TRAIN, device_ms, events_ms

SWEEP_DIR = build.BUILD_DIR.parent / "wkv_scan_bwd_sweep"
#: (kCols, kCpt, kSteps, kHist, kExch, kMinBlocks); the first is the kernel
#: as committed; the last asks more shared memory than a CTA may have, and
#: shows the card's refusal
LAYOUTS = [(32, 8, 4, 16, 4, 1), (32, 8, 4, 16, 1, 1), (32, 8, 4, 16, 2, 1),
           (32, 8, 4, 8, 4, 1), (32, 4, 4, 16, 4, 1), (32, 4, 4, 8, 4, 1),
           (16, 4, 4, 16, 1, 2), (64, 8, 4, 8, 1, 1), (32, 8, 4, 16, 8, 1)]
#: the small shapes each layout is also checked at: (B, T, H, K), hard
#: decays, a gradient of s_T and of s0
SMALL = [(3, 37, 5, 32), (5, 19, 1, 16)]
#: one (b, h) at the training length: the walk's latency
ONE = (1, WKV_TRAIN[1], 1, WKV_TRAIN[3])
#: name: (old, new) source replacements, each found at least once
ABLATIONS = {
    "no_cluster_sum": [("cluster_sum<K>(", "if (false) cluster_sum<K>(")],
    "no_cluster": [("cluster_sum<K>(", "if (false) cluster_sum<K>("),
                   ("cluster_wait();", ";"), ("cluster_arrive();", ";"),
                   ("rpart[q] = mapa(mine, q);", "rpart[q] = mine;")],
    "relaxed_arrive": [("barrier.cluster.arrive.release.aligned",
                        "barrier.cluster.arrive.relaxed.aligned")],
    "no_reduce_scatter": [("reduce_scatter<3", "if (false) reduce_scatter<3"),
                          ("reduce_scatter<Sh::NQ", "if (false) reduce_scatter<Sh::NQ"),
                          ("butterfly<3", "if (false) butterfly<3"),
                          ("butterfly<QN", "if (false) butterfly<QN")],
    "no_chunk_sums": [("chunk_sums<K>(cs", "if (false) chunk_sums<K>(cs")],
    "no_gv_sum": [("j < (kChunk + SPP - 1) / SPP;", "j < 0;")],
}
_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _set_constant(src: str, name: str, value: int) -> str:
    pattern = rf"constexpr int {name} = \d+;"
    if len(re.findall(pattern, src)) != 1:
        raise RuntimeError(f"csrc/wkv_scan_bwd.cu: expected one {pattern!r}")
    return re.sub(pattern, f"constexpr int {name} = {value};", src)


#: appended to every copy: the K = 64 kernel's dynamic shared memory a CTA,
#: and how many of its clusters the card holds at once
_OCCUPANCY = """
extern "C" int repro_wkv_scan_bwd_smem() { return (int)Shape<64>::SMEM; }
extern "C" int repro_wkv_scan_bwd_max_clusters() {
  using Sh = Shape<64>;
  auto kernel = wkv_scan_bwd_kernel<64, true>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)Sh::SMEM) != cudaSuccess) return -1;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Sh::P, attr[0].val.clusterDim.y = 1, attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Sh::P * 64), cfg.blockDim = dim3(Sh::NT), cfg.dynamicSmemBytes = Sh::SMEM;
  cfg.attrs = attr, cfg.numAttrs = 1;
  int n = -1;
  return cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg) == cudaSuccess ? n : -2;
}
"""


def variant_source(cols: int, cpt: int, steps: int, hist: int, exch: int, min_blocks: int,
                   ablation: str | None = None) -> str:
    src = (build.CSRC / "wkv_scan_bwd.cu").read_text()
    for name, value in (("kCols", cols), ("kCpt", cpt), ("kSteps", steps), ("kHist", hist),
                        ("kExch", exch), ("kMinBlocks", min_blocks)):
        src = _set_constant(src, name, value)
    for old, new in ABLATIONS.get(ablation, []):
        if old not in src:
            raise RuntimeError(f"csrc/wkv_scan_bwd.cu: ablation {ablation}: no {old!r}")
        src = src.replace(old, new)
    return src + _OCCUPANCY


def build_layout(layout):
    d = SWEEP_DIR / "_".join(map(str, layout))
    d.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        (d / header.name).write_text(header.read_text())
    (d / "wkv_scan_bwd.cu").write_text(variant_source(*layout))
    out = d / "libwkv_scan_bwd.so"
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                           str(d / "wkv_scan_bwd.cu")], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on layout {layout}:\n{log}")
    lib = ctypes.CDLL(str(out))
    fn = lib.repro_wkv_scan_bwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    fn.max_clusters = lib.repro_wkv_scan_bwd_max_clusters()
    fn.smem = lib.repro_wkv_scan_bwd_smem()
    fn.cluster = lib.repro_wkv_scan_bwd_cluster
    fn.cluster.argtypes, fn.cluster.restype = [ctypes.c_int], ctypes.c_int
    # ptxas reports each instantiation (K = 16, 32, 64; two alignments)
    ptxas = sorted({m.group(0) for m in re.finditer(
        r"Used \d+ registers|\d+ bytes spill stores|\d+ bytes spill loads|"
        r"\d+ bytes stack frame", log)})
    fn.sass = sass_mix(out)
    return fn, ptxas


def sass_mix(lib) -> dict[str, int]:
    """Opcode counts of the K = 64 kernel (16-byte copies) in the library's
    SASS (``cuobjdump``; the text is kept beside the library as
    ``k64.sass``): the chunk loop is unrolled, so this is close to what a
    thread issues a chunk; {} when ``cuobjdump`` is missing."""
    tool = Path(build.find_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return {}
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True).stdout
    counts, inside, kept = {}, False, []
    for line in text.splitlines():
        if "Function :" in line:
            inside = "wkv_scan_bwd_kernel" in line and "ILi64ELb1E" in line
        elif inside:
            kept.append(line)
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m:
                op = m.group(1)
                counts[op] = counts.get(op, 0) + 1
    (Path(lib).parent / "k64.sass").write_text("\n".join(kept))
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def inputs(shape, hard: bool, gen):
    B, T, H, K = shape
    r, k, v, gy = (torch.randn(B, T, H, K, device="cuda", generator=gen) for _ in range(4))
    if hard:        # w down to exp(-e^3) ~ 2e-9, every fifth step's rows w = 1
        dec = torch.rand(B, T, H, K, device="cuda", generator=gen) * 12.0 - 9.0
    else:
        dec = -6.0 + 2.0 * torch.randn(B, T, H, K, device="cuda", generator=gen)
    w = torch.exp(-torch.exp(dec))
    if hard:
        w[:, 2::5] = 1.0
    u = 0.1 * torch.randn(H, K, device="cuda", generator=gen)
    s0, gs = (torch.randn(B, H, K, K, device="cuda", generator=gen) for _ in range(2))
    ckpt = torch.empty((B, H, -(-T // CHUNK), K, K), device="cuda")
    wkv_scan_cuda(r, k, v, w, u, s0, ckpt)
    return (r, k, v, w, u, s0), ckpt, gy, gs


class Call:
    """One layout's entry point on fixed inputs and outputs."""

    def __init__(self, ins, ckpt, gy, gs, want_gs0: bool):
        self.ins, self.ckpt, self.gy, self.gs = ins, ckpt, gy, gs
        B, T, H, K = ins[0].shape
        self.shape = (B, T, H, K)
        self.outs = [torch.empty_like(ins[0]) for _ in range(4)] + [torch.empty_like(ins[4])]
        self.gs0 = torch.empty_like(ins[5]) if want_gs0 else None
        self.gu_part = {}     # u's gradient scratch by the layout's cluster size
        self.ticket = torch.empty((H,), dtype=torch.int32, device="cuda")

    def __call__(self, fn) -> list[torch.Tensor]:
        r, k, v, w, u, _ = self.ins
        B, _, H, K = self.shape
        P = fn.cluster(K)
        if P not in self.gu_part:
            self.gu_part[P] = torch.empty((P, B, H, K), device="cuda")
        ptr = lambda t: None if t is None else t.data_ptr()     # noqa: E731
        err = fn(*(ptr(t) for t in (r, k, v, w, u, self.ckpt, self.gy, self.gs)),
                 *(ptr(t) for t in self.outs), ptr(self.gs0), ptr(self.gu_part[P]),
                 ptr(self.ticket), *self.shape, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"wkv_scan_bwd launch failed: cudaError_t {err}")
        return self.outs + ([] if self.gs0 is None else [self.gs0])


def rel_err(got, want) -> float:
    return max((g - x).abs().max().item() / max(1.0, x.abs().max().item())
               for g, x in zip(got, want))


def main() -> list[dict]:
    if not torch.cuda.is_available():
        raise SystemExit("sweep_wkv_scan_bwd: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    variants = [(*layout, None) for layout in LAYOUTS] + [(*LAYOUTS[0], a) for a in ABLATIONS]
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = dict(zip(variants, pool.map(build_layout, variants)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    train_ins, ckpt, gy, _ = inputs(WKV_TRAIN, False, gen)
    train = Call(train_ins, ckpt, gy, None, want_gs0=False)
    want_train = reference_wkv_bwd(*train_ins, gy)[:5]
    one_ins, one_ckpt, one_gy, _ = inputs(ONE, False, gen)
    one = Call(one_ins, one_ckpt, one_gy, None, want_gs0=False)
    small = []
    for shape in SMALL:
        ins, ck, g, gs = inputs(shape, True, gen)
        small.append((Call(ins, ck, g, gs, want_gs0=True), reference_wkv_bwd(*ins, g, gs)))

    checks = {}
    for var in list(variants):     # checked first: a faulty layout stops the sweep early
        fn = built[var][0]
        try:
            first = [t.clone() for t in train(fn)]
        except RuntimeError as e:  # refused before it launched (shared memory, cluster)
            print(f"refused {var} ({built[var][0].smem} bytes of shared memory a CTA): {e}",
                  flush=True)
            variants.remove(var)
            continue
        same = all(torch.equal(a, b) for a, b in zip(first, train(fn)))
        small_err = []
        for call, want in small:
            got = [t.clone() for t in call(fn)]
            same = same and all(torch.equal(a, b) for a, b in zip(got, call(fn)))
            small_err.append(rel_err(got, want))
        torch.cuda.synchronize()
        checks[var] = dict(rel_err=rel_err(first, want_train), small_rel_err=small_err,
                           same_bits=same)
        print(f"checked {var}: {checks[var]}", flush=True)
    times = {var: dict(events_ms=[], device_ms=[], one_bh_events_ms=[]) for var in variants}
    for order in (variants, variants[::-1]):
        for var in order:
            run = lambda: train(built[var][0])       # noqa: E731
            times[var]["events_ms"].append(events_ms(run))
            times[var]["device_ms"].append(sum(device_ms(run).values()))
            times[var]["one_bh_events_ms"].append(events_ms(lambda: one(built[var][0])))
    rows = []
    K = WKV_TRAIN[3]
    for var in variants:
        fn, ptxas = built[var]
        cols, cpt, steps, hist, exch, min_blocks, ablation = var
        rows.append(dict(cols=cols, cpt=cpt, steps=steps, hist=hist, exch=exch,
                         min_blocks=min_blocks,
                         ablation=ablation, cluster=fn.cluster(K),
                         threads=K * K // (fn.cluster(K) * cpt),
                         smem=fn.smem, max_active_clusters=fn.max_clusters, **checks[var], ptxas=ptxas,
                         sass=fn.sass,
                         per_kernel_device_ms=device_ms(lambda: train(fn)), **times[var]))
        print(json.dumps(rows[-1]))
    return rows


if __name__ == "__main__":
    main()
