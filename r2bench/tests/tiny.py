"""Tiny cells for the CPU tests: the real traffic mixes and drivers at sizes
a test run holds."""

import json
from pathlib import Path

from r2bench import harness

BENCH = Path(__file__).resolve().parents[1]

TINY = {"registry": "smollm-360m", "num_hidden_layers": 2, "hidden_size": 64,
        "intermediate_size": 96, "num_attention_heads": 4, "num_key_value_heads": 2,
        "head_dim": 16, "vocab_size": 256, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
        "tie_word_embeddings": True, "remat": True,
        "precision": {"residual": "bfloat16", "products": "float32",
                      "gradient_wire": "bfloat16", "cache": "float32"}}

#: limits of the tiny cells, from their CPU readings (test_r2bench_control.py)
TRAIN_LIMITS = {"loss_gap": 5e-6, "grad_norm_gap": 2e-3, "grad_sample_gap": 2e-2,
                "update_norm_gap": 1e-3, "update_sample_gap": 1e-2}
TRAIN_LIMITS.update({f"after_{k}": v for k, v in TRAIN_LIMITS.items()})
SERVE_LIMITS = {"logit_gap": 1e-3}


def train_cell(traffic: str = "dp4-ring") -> harness.Cell:
    mix = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    mix.update(seq_len=16)
    return harness.Cell("tiny-train", dict(TINY), mix, "train", 1, dict(TRAIN_LIMITS))


def serve_cell() -> harness.Cell:
    cfg = dict(TINY, registry="deepseek-67b", tie_word_embeddings=False)
    mix = json.loads((BENCH / "traffic" / "short-open-loop.json").read_text())
    mix.update(rate=4.0, prompt={"median": 12, "sigma": 0.5, "min": 4, "max": 24},
               output={"min": 3, "max": 6}, max_batch=4, context_len=32, check_requests=4,
               drain_seconds=10)
    return harness.Cell("tiny-serve", cfg, mix, "serve", 1, dict(SERVE_LIMITS))
