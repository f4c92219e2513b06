"""Time layouts of the ``lru_scan`` kernel against each other, on the card:

  PYTHONPATH=src python -m repro_torch.launch.sweep_lru_scan

Each layout is ``csrc/lru_scan.cu`` with its constants ``kTile`` (time steps
a tile), ``kWarps`` (warps a CTA) and ``kStages`` (tiles in the ``cp.async``
ring) replaced, and optionally a floor under the dynamic shared memory a CTA
asks for: a floor above half of an SM's 228 KB holds the layout to one CTA
an SM whatever its ring needs.  The copies are built in parallel under
``build/lru_scan_sweep/`` and run at recurrentgemma-9b's prefill shape (2,
2304, 4096) fp32 with a nonzero h0.  Each is checked against
``ref.reference_lru_scan`` (the largest error over max(1, max |h|), as
``chip_smoke.py``'s ``SCAN_RTOL`` reads it) and timed by CUDA
events and by the profiler's device time, in two rounds (the list, then the
list reversed), so that drift over the call shows.  One JSON line a layout,
after the card's name and power limit.  Needs ``nvcc`` and a CUDA device.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import subprocess

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import reference_lru_scan
from repro_torch.launch.profile_kernels import LRU_SHAPE, device_ms, events_ms

SWEEP_DIR = build.BUILD_DIR.parent / "lru_scan_sweep"
SMEM_PER_SM = 228 * 1024          # H100; each CTA also holds 1 KB reserved
#: (tile, warps, stages, floor KB); the first is the kernel as committed
LAYOUTS = [(128, 8, 4, 0), (128, 8, 3, 0), (128, 8, 3, 120), (128, 8, 2, 120),
           (160, 8, 3, 0), (128, 8, 5, 0), (192, 8, 3, 0), (256, 16, 2, 0),
           (128, 4, 4, 0), (128, 16, 4, 0)]
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _replace_once(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"csrc/lru_scan.cu: expected {old!r} once")
    return src.replace(old, new)


def variant_source(tile: int, warps: int, stages: int, floor_kb: int) -> str:
    src = (build.CSRC / "lru_scan.cu").read_text()
    src = _replace_once(src, "kWarps = 8;", f"kWarps = {warps};")
    src = _replace_once(src, "kTile = 128;", f"kTile = {tile};")
    src = _replace_once(src, "kStages = 4;", f"kStages = {stages};")
    # the ring's own size, then the layout's floor over it
    src = _replace_once(src, "constexpr size_t smem_bytes() {",
                        f"constexpr size_t ring_bytes();\n"
                        f"constexpr size_t smem_bytes() {{ return ring_bytes() > {floor_kb * 1024}"
                        f" ? ring_bytes() : {floor_kb * 1024}; }}\n"
                        f"constexpr size_t ring_bytes() {{")
    return src


def smem_bytes(tile: int, warps: int, stages: int, floor_kb: int) -> int:
    ring = 4 * (stages * 2 * tile * 32 + 2 * warps * 32 + 2 * 32)
    return max(ring, floor_kb * 1024)


def build_layout(layout):
    d = SWEEP_DIR / "_".join(map(str, layout))
    d.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        (d / header.name).write_text(header.read_text())
    (d / "lru_scan.cu").write_text(variant_source(*layout))
    out = d / "liblru_scan.so"
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                           str(d / "lru_scan.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on layout {layout}:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(out)).repro_lru_scan
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def main() -> list[dict]:
    if not torch.cuda.is_available():
        raise SystemExit("sweep_lru_scan: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    with concurrent.futures.ThreadPoolExecutor(len(LAYOUTS)) as pool:
        fns = dict(zip(LAYOUTS, pool.map(build_layout, LAYOUTS)))
    B, T, W = LRU_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    # decays in the model's range, as profile_kernels draws them
    a = (0.9 + 0.099 * torch.rand(W, device="cuda", generator=gen)) ** torch.rand(
        B, T, W, device="cuda", generator=gen)
    x = torch.randn(B, T, W, device="cuda", generator=gen)
    h0 = torch.randn(B, W, device="cuda", generator=gen)
    want = reference_lru_scan(a, x, h0)
    out = torch.empty_like(a)
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn):
        err = fn(a.data_ptr(), x.data_ptr(), h0.data_ptr(), out.data_ptr(), B, T, W, stream)
        if err:
            raise RuntimeError(f"lru_scan launch failed: cudaError_t {err}")

    times = {layout: dict(events_ms=[], device_ms=[]) for layout in LAYOUTS}
    for order in (LAYOUTS, LAYOUTS[::-1]):
        for layout in order:
            run = lambda: call(fns[layout])
            times[layout]["events_ms"].append(events_ms(run))
            times[layout]["device_ms"].append(sum(device_ms(run).values()))
    rows = []
    for layout in LAYOUTS:
        call(fns[layout])
        err = (out - want).abs().max().item() / max(1.0, want.abs().max().item())
        smem = smem_bytes(*layout)
        rows.append(dict(tile=layout[0], warps=layout[1], stages=layout[2], floor_kb=layout[3],
                         smem_bytes=smem, ctas_per_sm=min(SMEM_PER_SM // (smem + 1024),
                                                          2048 // (32 * layout[1])),
                         rel_err=err, **times[layout]))
        print(json.dumps(rows[-1]))
    return rows


if __name__ == "__main__":
    main()
