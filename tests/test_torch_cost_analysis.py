"""The port's cost model (``launch/cost_analysis.py``) and its kernels as
dispatcher ops (``kernels/library.py``).

* ``visible_pairs``' closed form equals the count of the plain mask
  (``ref.attention_mask``) on every mask of the menu, exactly.
* The kernels' formulas give ``PERF.md`` section 6's "bound ms" column at its
  listed shapes within 0.5% (the column's numbers are rounded to four
  decimals and were taken at the peaks 495/3, 67 and 3.35; the formulas use
  the datasheet's 494.7/3, 66.9 and 3.35).
* ``roofline_terms`` with a ``Hardware`` holding the JAX package's four v5e
  constants is JAX's ``roofline_terms`` (exactly: one op class), and
  ``model_flops`` is JAX's for every arch.
* Each op's fake gives the shapes and dtypes of its plain version; the
  op's CPU implementation is the plain version, bit for bit; the plain
  flash backward is autograd's through the plain forward (fp32 rounding:
  1e-5); ``FlopCounterMode`` counts each op by its formula.
"""

import itertools

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.launch import hlo_analysis as jhlo
from repro.models import get_config as jax_get_config
from repro.models import list_architectures
from repro_torch.core.collectives import program_for
from repro_torch.kernels import ops, ref
from repro_torch.kernels.wkv_scan import CHUNK
from repro_torch.launch import cost_analysis as CA
from repro_torch.models import get_config


def _brute_pairs(Tq, Tk, **kw):
    q_off = kw.pop("q_offset", 0)
    m = ref.attention_mask(q_off + torch.arange(Tq), torch.arange(Tk), k_len=Tk,
                           k_valid_len=kw.pop("k_valid_len", None), **kw)
    return int(m.expand(Tq, Tk).sum())


MASKS = [dict(causal=c, window=w, prefix_len=p)
         for c, w, p in itertools.product((True, False), (None, 1, 7, 64), (None, 5, 40))]


@pytest.mark.parametrize("mask", MASKS, ids=lambda m: "-".join(f"{k}{v}" for k, v in m.items()))
def test_visible_pairs_closed_form_equals_the_plain_mask(mask):
    rng = np.random.default_rng(0)
    cases = [(1, 1, 0, None), (37, 37, 0, None), (50, 120, 0, None), (120, 50, 0, None),
             (16, 200, 100, 150), (1, 96, 95, None), (64, 64, 0, 10)]
    cases += [(int(rng.integers(1, 90)), int(rng.integers(1, 90)),
               int(rng.integers(0, 40)), None) for _ in range(6)]
    for Tq, Tk, q_off, kvl in cases:
        want = _brute_pairs(Tq, Tk, q_offset=q_off, k_valid_len=kvl, **mask)
        got = CA.visible_pairs(Tq, Tk, q_offset=q_off, k_valid_len=kvl, **mask)
        assert got == want, (Tq, Tk, q_off, kvl, mask)


def test_visible_pairs_at_prefill_32k_without_a_mask():
    """1.07e9 (query, key) entries: counted in closed form, not built."""
    T = 32_768
    assert CA.visible_pairs(T, T) == T * (T + 1) // 2
    assert CA.visible_pairs(T, T, window=4096) == sum(min(q + 1, 4096) for q in range(T))


F32, BF16 = torch.float32, torch.bfloat16
# (name, cost, PERF.md section 6's bound ms)
PERF_BOUNDS = [
    ("flash fwd smollm", CA.flash_fwd_cost((4, 512, 5, 3, 64), (4, 512, 5, 64), F32), 0.0122),
    ("flash fwd head_dim 256", CA.flash_fwd_cost((2, 2304, 1, 16, 256), (2, 2304, 1, 256),
                                                 F32, window=2048), 0.5208),
    ("flash fwd gemma2", CA.flash_fwd_cost((2, 4352, 16, 2, 128), (2, 4352, 16, 128), F32,
                                           window=4096), 1.8746),
    ("flash fwd mla", CA.flash_fwd_cost((4, 512, 128, 1, 192), (4, 512, 128, 192), F32),
     0.3130),
    ("flash fwd paligemma", CA.flash_fwd_cost((4, 512, 1, 8, 256), (4, 512, 1, 256), F32,
                                              prefix_len=256), 0.0326),
    ("flash fwd hubert", CA.flash_fwd_cost((4, 1024, 16, 1, 80), (4, 1024, 16, 80), F32,
                                           causal=False), 0.1302),
    ("flash bwd smollm", CA.flash_bwd_cost((2, 512, 5, 3, 64), (2, 512, 5, 64), F32), 0.0153),
    ("flash bwd paligemma", CA.flash_bwd_cost((2, 512, 1, 8, 256), (2, 512, 1, 256), F32,
                                              prefix_len=256), 0.0407),
    ("flash bwd hubert", CA.flash_bwd_cost((2, 512, 16, 1, 80), (2, 512, 16, 80), F32,
                                           causal=False), 0.0407),
    ("flash bwd mla", CA.flash_bwd_cost((4, 512, 128, 1, 192), (4, 512, 128, 192), F32),
     0.7824),
    ("chunk_combine", CA.chunk_combine_cost((3, 13426888), BF16, [1] * 3, [1] * 3), 0.0721),
    ("lru_scan", CA.lru_scan_cost(2, 2304, 4096), 0.0676),
    ("wkv_scan", CA.wkv_scan_cost(4, 512, 32, 64), 0.0263),
    ("lru_scan_bwd", CA.lru_scan_bwd_cost(2, 512, 4096, want_gh0=False), 0.0251),
    ("wkv_scan_bwd", CA.wkv_scan_bwd_cost(2, 512, 32, 64), 0.0280),
]


@pytest.mark.parametrize("name,cost,want", PERF_BOUNDS, ids=[p[0] for p in PERF_BOUNDS])
def test_kernel_formulas_give_the_perf_bound_column(name, cost, want):
    got = cost.bound()["bound_ms"]
    assert abs(got - want) <= 0.005 * want, (name, got, want)


def test_roofline_terms_with_v5e_constants_are_jax_s():
    v5e = CA.Hardware(name="v5e", peak_flops={"bf16": jhlo.PEAK_FLOPS},
                      hbm_bw=jhlo.HBM_BW, hbm_bytes=jhlo.HBM_PER_CHIP, nic_bw=jhlo.ICI_BW)
    rng = np.random.default_rng(1)
    for _ in range(20):
        f, b, w = (float(x) for x in rng.uniform(0, 1e13, 3))
        kw = dict(flops_per_device=f, hbm_bytes_per_device=b, wire_bytes_per_device=w,
                  chips=256)
        assert CA.roofline_terms(**kw, hw=v5e) == jhlo.roofline_terms(**kw)
    # by class: each class at its own peak
    t = CA.roofline_terms(flops_per_device={"fp32": 66.9e12, "bf16": 989.4e12},
                          hbm_bytes_per_device=0.0, wire_bytes_per_device=0.0, chips=1)
    assert t["compute_s"] == pytest.approx(2.0, rel=1e-12)


@pytest.mark.parametrize("arch", list_architectures())
def test_model_flops_is_jax_s(arch):
    for tokens, mode in ((4096 * 256, "train"), (32768 * 32, "infer"), (128, "infer")):
        assert CA.model_flops(get_config(arch), tokens, mode) == \
            jhlo.model_flops(jax_get_config(arch), tokens, mode)


def test_program_wire_bytes_counts_each_step_s_payload():
    """A ring all-reduce on n ranks moves 2 (n - 1) chunks of 1/n of the
    padded payload; a payload splits over an r2ccl program's segments."""
    ring = program_for(8, mode="ring")
    assert CA.program_wire_bytes(ring, 2 * 8000, "bfloat16") == 2 * 7 * 1000 * 2
    assert CA.program_wire_bytes(ring, 2 * 8001, "bfloat16") == 2 * 7 * 1001 * 2
    r2 = program_for(8, mode="r2ccl", degraded=2, lost_fraction=0.5)
    assert len(r2.segments) > 1
    parts = CA.program_wire_bytes(r2, 4 * 10_000, "float32")
    assert parts > CA.program_wire_bytes(ring, 4 * 10_000, "float32") * 0.5
    assert CA.all_reduce_wire_bytes(1000.0, 4) == 1500.0
    assert CA.all_reduce_wire_bytes(1000.0, 1) == 0.0


def test_chunk_combine_cost_counts_what_each_row_moves():
    c = CA.chunk_combine_cost((4, 10), F32, [0, 1, 1, 0], [0, 1, 0, 1])
    assert (c.flops, c.nbytes) == (10, (3 + 2) * 10 * 4)           # in place
    c = CA.chunk_combine_cost((4, 10), F32, [0, 1, 1, 0], [0, 1, 0, 1], in_place=False)
    assert c.nbytes == (2 + 3 + 2 + 2) * 10 * 4


# ---------------------------------------------------------------------------
# the ops: fakes, CPU implementations, formulas
# ---------------------------------------------------------------------------

def _t(rng, *shape, dtype=F32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _op_cases():
    """(name, args of torch.ops.repro_torch.<name>, the plain version's
    outputs) on small CPU tensors."""
    rng = np.random.default_rng(2)
    q, k, v = _t(rng, 2, 9, 2, 3, 8), _t(rng, 2, 11, 2, 8), _t(rng, 2, 11, 2, 8)
    kw = dict(causal=True, window=5, prefix_len=2, logit_cap=20.0, scale=None)
    out = ref.reference_attention(q, k, v, **kw)
    lse = torch.empty(2, 9, 2, 3)
    do = _t(rng, 2, 9, 2, 3, 8)
    a = torch.from_numpy(rng.uniform(0.5, 1, (2, 13, 6)).astype(np.float32))
    x, h0, gh = _t(rng, 2, 13, 6), _t(rng, 2, 6), _t(rng, 2, 13, 6)
    h = ref.reference_lru_scan(a, x, h0)
    B, T, H, K = 2, 21, 2, 4
    r, kk, vv = (_t(rng, B, T, H, K) for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.5, 1, (B, T, H, K)).astype(np.float32))
    u, s0, gy = _t(rng, H, K), _t(rng, B, H, K, K), _t(rng, B, T, H, K)
    ckpt = torch.empty(B, H, -(-T // CHUNK), K, K)
    local, recv = _t(rng, 4, 7, dtype=BF16), _t(rng, 4, 7, dtype=BF16)
    seg, acc = [False, True, True, False], [False, True, False, True]
    attn = tuple(kw.values())
    xm, wm = _t(rng, 3, 5, 12, dtype=BF16), _t(rng, 3, 12, 8)
    return [
        ("flash_attention_fwd", (q, k, v, lse, *attn, 0, None), out),
        ("flash_attention_bwd", (q, k, v, out, do, lse, *attn),
         ref.reference_attention_bwd(q, k, v, do, **kw)),
        ("chunk_combine", (local, recv, seg, acc, local.clone()), None),
        ("lru_scan", (a, x, h0), h),
        ("lru_scan_bwd", (a, h, h0, gh, True), ref.reference_lru_scan_bwd(a, h, h0, gh)),
        ("wkv_scan", (r, kk, vv, w, u, s0, ckpt), ref.reference_wkv(r, kk, vv, w, u, s0)),
        ("wkv_scan_bwd", (r, kk, vv, w, u, ckpt, gy, None, True),
         ref.reference_wkv_bwd(r, kk, vv, w, u, s0, gy)),
        ("small_mm", (xm, wm), torch.bmm(xm.float(), wm)),
    ]


def _meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    return x


def _flat(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


@pytest.mark.parametrize("case", _op_cases(), ids=lambda c: c[0])
def test_op_fake_and_cpu_implementation_match_the_plain_version(case):
    name, args, want = case
    op = getattr(torch.ops.repro_torch, name)
    got = op(*args)                                  # the CPU implementation
    fake = op(*map(_meta, args))
    if name == "chunk_combine":
        assert got is None and fake is None
        torch.testing.assert_close(args[4], ref.reference_chunk_combine(*args[:4]),
                                   rtol=0, atol=0)
        return
    if name == "wkv_scan":                           # the states at each chunk's start
        s = args[5]
        for c in range(args[6].shape[2]):
            torch.testing.assert_close(args[6][:, :, c], s, rtol=1e-6, atol=1e-6)
            sl = slice(c * CHUNK, (c + 1) * CHUNK)
            _, s = ref.reference_wkv(*(t[:, sl] for t in args[:4]), args[4], s)
    for g, f, w in zip(_flat(got), _flat(fake), _flat(want), strict=True):
        assert (f.device.type, f.shape, f.dtype) == ("meta", w.shape, w.dtype)
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", _op_cases(), ids=lambda c: c[0])
def test_flop_counter_counts_each_op_by_its_formula(case):
    name, args, _ = case
    op = getattr(torch.ops.repro_torch, name)
    for dev_args in (args, tuple(map(_meta, args))):
        with FlopCounterMode(display=False) as fc, CA.CostCounter() as cc:
            op(*dev_args)
        cost = CA.KERNEL_COSTS[name](*dev_args)
        assert fc.get_total_flops() == cost.flops == cc.total_flops
        assert cc.nbytes == cost.nbytes and cc.kernel_calls == {name: 1}


def test_plain_attention_backward_is_autograd_s():
    rng = np.random.default_rng(3)
    for kw in (dict(), dict(causal=False), dict(window=4, logit_cap=5.0),
               dict(prefix_len=3, scale=0.3)):
        q, k, v = _t(rng, 2, 7, 2, 2, 4), _t(rng, 2, 7, 2, 4), _t(rng, 2, 7, 2, 4)
        do = _t(rng, 2, 7, 2, 2, 4)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(ref.reference_attention(*leaves, **kw), leaves, do)
        for g, w in zip(ref.reference_attention_bwd(q, k, v, do, **kw), want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        lse = ref.reference_attention_lse(q, k, **kw)
        s = torch.einsum("bqhgd,bkhd->bqhgk", q * (kw.get("scale") or 4 ** -0.5), k)
        if "logit_cap" in kw:
            s = torch.tanh(s / kw["logit_cap"]) * kw["logit_cap"]
        mask = ref.attention_mask(torch.arange(7), torch.arange(7), causal=kw.get("causal", True),
                                  window=kw.get("window"), prefix_len=kw.get("prefix_len"),
                                  k_valid_len=None, k_len=7).expand(7, 7)
        want_lse = torch.logsumexp(s.masked_fill(~mask[None, :, None, None], -torch.inf), -1)
        torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)


def test_ops_route_meta_to_the_fake_and_count_no_launch():
    """A meta tensor goes to the op: no kernel launches, no plain loop."""
    ops.reset_launch_counts()
    q = torch.empty(1, 4096, 1, 2, 64, device="meta")
    k = torch.empty(1, 4096, 1, 64, device="meta")
    out = ops.flash_attention(q, k, k, window=128)
    h = ops.lru_scan(*(torch.empty(2, 100_000, 8, device="meta") for _ in range(2)),
                     torch.empty(2, 8, device="meta"))
    assert out.shape == q.shape and h.shape == (2, 100_000, 8)
    assert not any(ops.launch_counts().values())


def test_cost_counter_moves_no_bytes_for_views():
    x = torch.empty(64, 64, device="meta")
    with CA.CostCounter() as cc:
        x.view(4096).reshape(64, 64).t()
    assert cc.nbytes == 0
    with CA.CostCounter() as cc:
        x @ x
    assert cc.nbytes == 3 * 64 * 64 * 4 and cc.flops == {"fp32": 2 * 64 ** 3}
