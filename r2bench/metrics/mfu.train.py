"""The whole step's share of the card's fp32 peak (66.9 TFLOP/s, the CUDA
cores: the products run in float32 with TF32 off), in %: the analytic model
FLOPs of the window's steps (``formulas.train_flops``) over the window."""

from r2bench.formulas import PEAK_FLOPS


def read(records: dict):
    t = records.get("train")
    if not t or not t["steps"]:
        return None
    return 100.0 * t["model_flops"] / t["window_s"] / PEAK_FLOPS["fp32"]
