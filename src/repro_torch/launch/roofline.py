"""Roofline report: reads ``experiments/dryrun_torch/*.json`` (written by
``launch/dryrun.py``) and prints three tables: the single-pod roofline of
every arch x shape on H100s, the multi-pod matrix, and one note a pair on
what bounds it.  The counterpart of the JAX package's ``launch/roofline.py``,
with the H100's peaks and 80 GB (``cost_analysis.H100_SXM``, datasheet
numbers: a bound, not a measurement).

  PYTHONPATH=src python -m repro_torch.launch.roofline [--dir experiments/dryrun_torch]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from .cost_analysis import H100_SXM
from .dryrun import OUT_DIR

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(dir_: str) -> list[dict]:
    out = []
    for p in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(p) as f:
            out.append(json.load(f))
    return out


def fmt_s(v: float) -> str:
    if v >= 1.0:
        return f"{v:.2f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.1f}ms"
    return f"{v * 1e6:.0f}us"


def fmt_b(v: float) -> str:
    for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if v >= div:
            return f"{v / div:.1f}{unit}"
    return f"{v:.0f}B"


def baseline_table(results: list[dict]) -> str:
    rows = [r for r in results if r["mesh"] == "16x16" and r.get("sync") in ("xla", "n/a")]
    rows.sort(key=lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"])))
    gb = H100_SXM.hbm_bytes / 1e9
    lines = [
        "| arch | shape | mode | compute | memory | collective | bottleneck "
        f"| useful FLOPs | bytes/chip | fits {gb:.0f}GB |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if "skipped" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | "
                         f"SKIP ({r['skipped'][:38]}) | — | — | — |")
            continue
        if "error" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | FAIL | — | — | — |")
            continue
        t = r["roofline"]
        per_chip = r["memory_analysis"]["total_bytes"]
        fits = "yes" if per_chip <= H100_SXM.hbm_bytes else f"no ({fmt_b(per_chip)})"
        useful = r.get("useful_flops_ratio")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mode']} "
            f"| {fmt_s(t['compute_s'])} | {fmt_s(t['memory_s'])} "
            f"| {fmt_s(t['collective_s'])} | **{t['bottleneck']}** "
            f"| {'—' if useful is None else f'{useful:.2f}'} | {fmt_b(per_chip)} | {fits} |")
    return "\n".join(lines)


def multipod_matrix(results: list[dict]) -> str:
    lines = ["| arch | " + " | ".join(SHAPE_ORDER) + " |",
             "|---|" + "---|" * len(SHAPE_ORDER)]
    by = {(r["arch"], r["shape"]): r for r in results if r["mesh"] == "2x16x16"}
    for a in sorted({r["arch"] for r in results}):
        cells = []
        for s in SHAPE_ORDER:
            r = by.get((a, s))
            if r is None:
                cells.append("—")
            elif "error" in r:
                cells.append("FAIL")
            elif "skipped" in r:
                cells.append("skip")
            else:
                cells.append(f"ok ({fmt_s(r['roofline']['bound_s'])}, "
                             f"{r['roofline']['bottleneck']})")
        lines.append(f"| {a} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def bottleneck_notes(results: list[dict]) -> str:
    """One sentence per (arch, shape): what moves the dominant term down."""
    suggestions = {
        ("collective", "train"): "shard params over data (ZeRO) or bucket and overlap the "
                                 "gradient ring with the backward",
        ("collective", "prefill"): "sequence-shard activations to cut the model axis' gathers",
        ("collective", "decode"): "keep the KV cache resident per model shard",
        ("memory", "train"): "fuse the elementwise chains (norm, rope, gates) and drop remat "
                             "on cheap layers",
        ("memory", "prefill"): "fuse the elementwise ops around the GEMMs; bf16 cache writes",
        ("memory", "decode"): "decode streams the weights and the cache: batch more "
                              "sequences per card or store fewer bits",
        ("compute", "train"): "compute-bound: bf16 GEMMs (fp32 runs at the CUDA cores' 66.9 "
                              "TFLOP/s, bf16 on the tensor cores at 989.4)",
        ("compute", "prefill"): "compute-bound: bf16 GEMMs on the tensor cores",
        ("compute", "decode"): "unusual; look for repeated work",
    }
    lines = []
    for r in results:
        if r["mesh"] != "16x16" or "skipped" in r or "error" in r:
            continue
        t = r["roofline"]
        lines.append(f"- **{r['arch']} x {r['shape']}** -> {t['bottleneck']}-bound "
                     f"({fmt_s(t['bound_s'])}); "
                     f"{suggestions.get((t['bottleneck'], r['mode']), '')}")
    return "\n".join(sorted(lines))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    results = load(args.dir)
    print(f"## Single-pod (16x16 = 256 H100s) roofline, {H100_SXM.name}\n")
    print(baseline_table(results))
    print("\n## Multi-pod (2x16x16 = 512 H100s): bound and bottleneck\n")
    print(multipod_matrix(results))
    print("\n## Per-pair bottleneck notes\n")
    print(bottleneck_notes(results))


if __name__ == "__main__":
    main()
