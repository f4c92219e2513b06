"""The DeepSeek-V3 serving cell's driver at a tiny size on the CPU, the
chip look skipped: sound, it is correct; with each fault planted in the
program (``faults_deepseek_v3.py``) ``correct`` comes out false."""

import copy
import json
import time

import pytest
import torch

from r2bench import harness
from r2bench.drivers import serve_deepseek_v3 as driver
from faults_deepseek_v3 import PROGRAM_FAULTS

#: the cell's configuration at a tiny size: every key the driver reads, the
#: published router's shape in small (32 experts in 4 groups, 2 kept, top-4),
#: 8 held; widths cut
TINY_SIZES = {"hidden_size": 64, "intermediate_size": 96, "moe_intermediate_size": 32,
              "num_attention_heads": 4, "num_key_value_heads": 4, "q_lora_rank": 24,
              "kv_lora_rank": 16, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
              "v_head_dim": 16, "vocab_size": 256, "num_hidden_layers": 4,
              "first_k_dense_replace": 1, "n_routed_experts_published": 32,
              "n_routed_experts": 8, "first_held_expert": 8, "n_group": 4, "topk_group": 2,
              "num_experts_per_tok": 4}
#: from the sound runs' and the faults' CPU readings
TINY_LIMITS = {"logit_gap": 1e-3, "route_flip_share": 0.01}


def tiny_cell() -> harness.Cell:
    c = dict(harness.load("configs", "deepseek-v3-10l-ep32"), **TINY_SIZES)
    c["rope_scaling"] = dict(c["rope_scaling"], original_max_position_embeddings=16)
    mix = json.loads((harness.BENCH / "traffic" / "long-decode-open-loop.json").read_text())
    mix.update(rate=4.0, prompt={"median": 12, "sigma": 0.5, "min": 4, "max": 24},
               output={"min": 3, "max": 8}, max_batch=4, context_len=40, check_requests=4,
               drain_seconds=10)
    return harness.Cell("tiny-dsv3", c, mix, "serve_deepseek_v3", 1, dict(TINY_LIMITS))


@pytest.fixture(autouse=True)
def float32_products():
    yield
    torch.set_float32_matmul_precision("highest")


def run(cell, fault=None, seed=2**31 + 11):
    ctx = harness.Context(cell=cell, seed=seed, seconds=1.5, trace=False, t_process=time.time(),
                          device="cpu",
                          fault=fault and f"faults_deepseek_v3:{fault}")
    out = driver.run(ctx)
    line, lines = harness.result(ctx, out)
    assert list(line)[-1] == "checks" and len(lines) == len(out["checks"])
    return line


@pytest.mark.parametrize("seed", [2**31 + 11, 5])
def test_sound_run_is_correct(seed):
    line = run(tiny_cell(), seed=seed)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == {"logit_gap", "route_flip_share", "moe_dropped_slots",
                                   "precision_departures"}


@pytest.mark.parametrize("fault", PROGRAM_FAULTS)
def test_fault_is_caught(fault):
    line = run(tiny_cell(), fault)
    assert not line["correct"], (fault, line["checks"])


def test_the_parent_fails_at_once_on_an_unknown_key():
    """A configuration stating what the program cannot run raises before
    any weight is made."""
    c = copy.deepcopy(tiny_cell().config)
    c["scoring_func"] = "softmax"
    with pytest.raises(ValueError, match="scoring_func"):
        driver.port_config(c)


def test_decode_counts_read_the_route_log():
    """A batch of 3 rows, 2 decode steps over 2 MoE layers, replayed in a
    4-row graph after a call the log kept from before: tokens and held
    slots of the 3 real rows of the last 4 calls alone, every held expert
    on each of the graph's 4 rows."""
    g = torch.Generator().manual_seed(0)
    dec = torch.randint(0, 32, (5, 4, 2), generator=g, dtype=torch.int32)
    dec[:, 3] = 8                                    # the padded row: all held
    b = {"requests": [None] * 3, "stamps": [0.0] * (2 + 2 * 2)}
    real = dec[1:, :3]
    held = int(((real >= 8) & (real < 16)).sum())
    assert driver.decode_counts([b], [([None, None], dec)], (8, 8), lambda B: 4) == {
        "moe.tokens": 4 * 3, "moe.held_slots": held, "moe.expert_rows": 4 * 8 * 4}
