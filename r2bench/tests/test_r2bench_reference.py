"""The plain reference against hand-worked cases, and against the program's
model at a tiny size on the CPU (where the program runs its kernels' plain
versions)."""

import math

import numpy as np
import pytest
import torch

from r2bench.reference import llama
from r2bench.reference import train as ref_train
from r2bench.weights import flatten, make_weights
from tiny import TINY

F32 = llama.Precision(residual="float32")


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -12, -(1 + 3 * 2 ** -11), 3.0])
    assert llama.to_tf32(x).tolist() == [1.0, 1 + 2 ** -10, 1.0, -(1 + 2 * 2 ** -10), 3.0]
    a = torch.tensor([[1 + 2 ** -12]])
    assert llama.mm(a, a, llama.Precision("tf32")).item() == 1.0
    assert llama.mm(a, a, F32).item() == pytest.approx((1 + 2 ** -12) ** 2, rel=1e-7)


def test_rmsnorm_by_hand():
    y = llama.rmsnorm(torch.tensor([[3.0, 4.0]]), torch.tensor([0.0, 1.0]), 0.0, F32)
    r = math.sqrt(12.5)
    assert y[0].tolist() == pytest.approx([3 / r, 2 * 4 / r])
    assert llama.rmsnorm(torch.ones(1, 4), torch.zeros(4), 0.0, llama.Precision()).dtype == torch.bfloat16


def test_float8_residual_rounding():
    p = llama.Precision(residual="float8_e4m3fn")
    x = torch.tensor([[448.0, 1.0, 1.0625, 0.5, -3.3]], requires_grad=True)
    y = llama.to_residual(x, p)
    assert y.dtype == torch.float32
    assert y.detach()[0].tolist() == [448.0, 1.0, 1.0, 0.5, -3.25]   # 3 mantissa bits
    y.sum().backward()
    assert x.grad.tolist() == [[1.0] * 5]
    z = llama.add(torch.tensor([[1.0, 2.0]]).bfloat16(), torch.tensor([[2 ** -9, 0.0]]), llama.Precision())
    assert z.dtype == torch.bfloat16 and z.tolist() == [[1.0, 2.0]]


def test_rope_by_hand():
    x = torch.tensor([1.0, 0.0, 0.0, 1.0]).repeat(1, 2, 1, 1)          # (1, T=2, H=1, D=4)
    y = llama.rope(x, theta=100.0)
    assert y[0, 0, 0].tolist() == [1.0, 0.0, 0.0, 1.0]                   # position 0
    # position 1: pair i turns by 1 / 100^(2i/4): (1, 0) by 1 rad, (0, 1) by 0.1 rad
    c0, s0, c1, s1 = math.cos(1), math.sin(1), math.cos(0.1), math.sin(0.1)
    assert y[0, 1, 0].tolist() == pytest.approx([c0, -s1, s0, c1], abs=1e-6)


def test_attention_by_hand():
    q = torch.tensor([[1.0, 0.0], [0.0, 2.0]]).view(1, 2, 1, 2)
    k = torch.tensor([[2.0, 0.0], [0.0, 1.0]]).view(1, 2, 1, 2)
    v = torch.tensor([[1.0, 10.0], [3.0, 20.0]]).view(1, 2, 1, 2)
    out = llama.attention(q, k, v, F32)[0, :, 0]
    assert out[0].tolist() == pytest.approx([1.0, 10.0])                 # sees key 0 only
    w = torch.softmax(torch.tensor([0.0, 2.0]) / math.sqrt(2), 0)        # scores 0, 2
    assert out[1].tolist() == pytest.approx((w[0] * v[0, 0, 0] + w[1] * v[0, 1, 0]).tolist())


def test_gqa_groups_query_heads_by_kv_head():
    torch.manual_seed(0)
    q = torch.randn(1, 3, 4, 8)
    k, v = torch.randn(1, 3, 2, 8), torch.randn(1, 3, 2, 8)
    out = llama.attention(q, k, v, F32)
    for h in range(4):
        one = llama.attention(q[:, :, h:h + 1], k[:, :, h // 2:h // 2 + 1],
                              v[:, :, h // 2:h // 2 + 1], F32)
        assert torch.allclose(out[:, :, h:h + 1], one)


def test_uniform_logits_give_log_vocab():
    c = dict(TINY, num_hidden_layers=1)
    p = make_weights(c, 1, "cpu")
    p["embed"]["embedding"].zero_()
    loss = llama.loss(p, c, torch.zeros(1, 5, dtype=torch.long), torch.ones(1, 5, dtype=torch.long), F32)
    assert float(loss) == pytest.approx(math.log(c["vocab_size"]), rel=1e-6)


def test_lr_schedule_by_hand():
    assert ref_train.lr_scale(0, 100, 10000) == 0.0
    assert ref_train.lr_scale(1, 100, 10000) == pytest.approx(0.01)
    assert ref_train.lr_scale(100, 100, 10000) == pytest.approx(1.0)
    assert ref_train.lr_scale(10000, 100, 10000) == pytest.approx(0.1)
    from repro_torch.optim.schedules import cosine_with_warmup
    for s in (0, 1, 2, 50, 100, 5000, 9999):
        assert ref_train.lr_scale(s, 100, 10000) == pytest.approx(
            float(cosine_with_warmup(s, warmup_steps=100, total_steps=10000)), rel=1e-6)


def test_adamw_step_by_hand():
    """Two steps on a scalar, gradient 1 then -1, lr 0.5, weight decay 0.1:
    step 1 has m = 0.1, v = 0.05, bias-corrected 1 and 1; step 2 has m = -0.01,
    v = 0.0975, corrected -0.01 / 0.19 and 0.0975 / 0.0975."""
    opt = {"b1": 0.9, "b2": 0.95, "eps": 0.0, "weight_decay": 0.1}
    p, m, v = torch.tensor([3.0]), torch.zeros(1), torch.zeros(1)
    ref_train.adamw(p, torch.tensor([1.0]), m, v, 1, 0.5, opt)
    assert p.item() == pytest.approx(3.0 - 0.5 * (1.0 + 0.3))
    q = p.item()
    ref_train.adamw(p, torch.tensor([-1.0]), m, v, 2, 0.5, opt)
    assert (m.item(), v.item()) == (pytest.approx(-0.01), pytest.approx(0.0975))
    step = (-0.01 / 0.19) / math.sqrt(0.0975 / (1 - 0.95 ** 2))
    assert p.item() == pytest.approx(q - 0.5 * (step + 0.1 * q))


def test_wire_precisions():
    g = torch.tensor([1 + 2 ** -9, 1e-4, -3.0])
    assert ref_train.through_wire(g, "bfloat16").tolist() == [1.0, pytest.approx(1e-4, rel=4e-3), -3.0]
    f8 = ref_train.through_wire(g, "float8_e4m3fn")
    assert f8[2].item() == -3.0 and f8[0].item() == pytest.approx(1.0, rel=0.07)
    with pytest.raises(ValueError):
        ref_train.through_wire(g, "int4")


def test_mean_over_ranks_is_the_global_mean():
    """Two ranks of one row each take the step one rank of both rows takes, up
    to the wire's rounding."""
    c = dict(TINY, num_hidden_layers=1)
    opt = {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
           "grad_clip_norm": 1.0, "warmup_steps": 0, "total_steps": 10}
    g = torch.Generator().manual_seed(0)
    tok = torch.randint(0, c["vocab_size"], (2, 9), generator=g)
    x, y = tok[:, :-1], tok[:, 1:]
    a = flatten(make_weights(c, 3, "cpu"))
    b = {n: t.clone() for n, t in a.items()}
    la = ref_train.steps(a, c, opt, [[(x[:1], y[:1]), (x[1:], y[1:])]], precision=F32)
    lb = ref_train.steps(b, c, opt, [[(x, y)]], precision=F32)
    assert la[0] == pytest.approx(lb[0], rel=1e-6)
    for n in a:
        assert torch.allclose(a[n], b[n], atol=2e-5, rtol=0)


def test_reference_is_the_programs_model_on_the_cpu():
    """The port's ``apply_model`` on the CPU runs its kernels' plain versions:
    the same function, so its logits and loss agree to float32 rounding."""
    from r2bench.drivers.common import port_config
    from repro_torch.models import apply_model
    from repro_torch.training.losses import task_loss

    for c in (dict(TINY), dict(TINY, registry="deepseek-67b", tie_word_embeddings=False)):
        params = make_weights(c, 5, "cpu")
        cfg = port_config(c)
        tok = torch.from_numpy(np.random.default_rng(1).integers(0, c["vocab_size"], (2, 12)))
        logits, _, _ = apply_model(params, cfg, {"tokens": tok}, mode="train")
        ref = llama.logits(params, c, llama.hidden(params, c, tok, llama.Precision()),
                           llama.Precision())
        assert (logits - ref).abs().max().item() < 2e-2
        loss = float(task_loss(cfg, logits, {"labels": tok}))
        assert loss == pytest.approx(float(llama.loss(params, c, tok, tok, llama.Precision())),
                                     rel=1e-4)
