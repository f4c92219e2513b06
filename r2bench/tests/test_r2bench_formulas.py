"""The frozen yardstick against ``repro_torch``'s own formulas, and the model
FLOP count against the configuration by hand."""

import dataclasses

import pytest
import torch

from r2bench import formulas, harness
from repro_torch.launch import cost_analysis as CA

FLASH = [((4, 512, 8, 8, 128), (4, 512, 8, 128), {}),
         ((2, 512, 5, 3, 64), (2, 512, 5, 64), {}),
         ((1, 1024, 8, 8, 128), (1, 1024, 8, 128), {"window": 256}),
         ((2, 300, 1, 8, 256), (2, 300, 1, 256), {"prefix_len": 100}),
         ((3, 1, 8, 8, 128), (3, 700, 8, 128), {"q_offset": 600, "k_valid_len": 601})]


@pytest.mark.parametrize("q,k,kw", FLASH)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_fwd_cost_is_the_programs(q, k, kw, dtype):
    ours = formulas.flash_fwd_cost(q, k, dtype, **kw)
    theirs = CA.flash_fwd_cost(q, k, getattr(torch, dtype), **kw)
    assert (ours.flops, ours.nbytes, ours.peak) == (theirs.flops, theirs.nbytes, theirs.peak)
    assert ours.bound_s() * 1e3 == pytest.approx(theirs.bound()["bound_ms"], rel=1e-12)


@pytest.mark.parametrize("shape,seg,acc", [
    ((4, 1000), [1, 0, 1, 1], [1, 1, 0, 0]),
    ((3, 7), [0, 0, 0], [0, 0, 0]),
    ((1, 23592960), [1], [1]),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_combine_cost_is_the_programs(shape, seg, acc, dtype):
    for in_place in (True, False):
        ours = formulas.chunk_combine_cost(shape, dtype, seg, acc, in_place=in_place)
        theirs = CA.chunk_combine_cost(shape, getattr(torch, dtype), seg, acc, in_place=in_place)
        assert (ours.flops, ours.nbytes) == (theirs.flops, theirs.nbytes)
        assert ours.bound_s() * 1e3 == pytest.approx(theirs.bound()["bound_ms"], rel=1e-12)


def test_visible_pairs_causal_closed_form():
    for T in (1, 2, 17, 512):
        assert formulas.visible_pairs(T, T) == T * (T + 1) // 2


def test_peaks_are_the_programs():
    assert formulas.PEAK_FLOPS == dict(CA.H100_SXM.peak_flops)
    assert formulas.HBM_BW == CA.H100_SXM.hbm_bw


@pytest.mark.parametrize("name", ["smollm-360m", "deepseek-67b-8l"])
def test_model_flops_by_hand(name):
    c = harness.load("configs", name)
    d, F, L, V = c["hidden_size"], c["intermediate_size"], c["num_hidden_layers"], c["vocab_size"]
    H, KVH, D = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    body = L * (d * H * D * 2 + d * KVH * D * 2 + 3 * d * F)
    assert formulas.body_params(c) == body
    # the program's parameter count less the embedding (and the norms it leaves out)
    from repro_torch.models import get_config
    cfg = dataclasses.replace(get_config(c["registry"]), num_layers=L)
    embed = V * d * (1 if c["tie_word_embeddings"] else 2)
    assert cfg.param_count() - embed == body
    T = 512
    attn = L * 4 * D * H * T * (T + 1) // 2
    assert formulas.train_flops(c, [T, T]) == 6 * (body + V * d) * 2 * T + 3 * 2 * attn
    assert formulas.prefill_flops(c, [T]) == 2 * body * T + 2 * V * d + attn


def test_smollm_step_flops_near_the_issue_estimate():
    c = harness.load("configs", "smollm-360m")
    per_token = formulas.train_flops(c, [512] * 8) / 4096
    assert per_token == pytest.approx(2.27e9, rel=0.05)
