"""The prefill's share of the card's fp32 peak (66.9 TFLOP/s), in %: the
analytic FLOPs of the real prompt tokens (``formulas.prefill_flops``; padding
not counted, so padding lowers it) over the prefills' clock time."""

from r2bench.formulas import PEAK_FLOPS


def read(records: dict):
    s = records.get("serve")
    if not s or not s["prefill_s"]:
        return None
    return 100.0 * s["prefill_flops"] / sum(s["prefill_s"]) / PEAK_FLOPS["fp32"]
