"""The port's recurrent blocks, ``rglru_block`` (RecurrentGemma) and
``rwkv_block`` (RWKV-6), held against the JAX package's blocks on the same
numpy inputs, with weights from the JAX ``init_*_block`` carried across by
``params_from_jax``: train, prefill (from a zero state, then continuing
from the state it left) and decode, outputs and every state tensor, plus
the train-mode gradients against ``jax.grad``.

Tolerances.  Both blocks compute in float32 after their input projections
(a bfloat16 input is exactly representable there), so float32 outputs and
states agree to 1e-5 of max(1, |value|): sums over d, W or K taken in
another order.  A bfloat16 block output is the float32 result rounded to
bfloat16, where one ulp is 2^-8 relative, so it is held to 1e-2 of
max(1, |value|).  Gradients: 1e-4 of max(1, |grad|), since they sum over
every token and through the T-step recurrence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as JRG
from repro.models import rwkv6 as JRW
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv6 as RW
from repro_torch.models.convert import params_from_jax

B, D = 2, 32
LRU_W, CONV_W = 24, 4
HEAD, DECAY_LORA, TS_LORA = 8, 8, 4
F32_TOL, BF16_TOL, GRAD_TOL = 1e-5, 1e-2, 1e-4
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


def _states_close(got, want, names):
    for n in names:
        _close(getattr(got, n), getattr(want, n), F32_TOL, n)


FAMILIES = {
    "rglru": dict(
        init=lambda: JRG.init_rglru_block(jax.random.PRNGKey(0), D, LRU_W, CONV_W)[0],
        jax_block=jax.jit(lambda p, x, state=None, mode="train": JRG.rglru_block(
            p, x, conv_width=CONV_W, state=state, mode=mode), static_argnames="mode"),
        block=lambda p, x, **kw: RG.rglru_block(p, x, conv_width=CONV_W, **kw),
        jax_state=lambda: JRG.init_rglru_state(B, LRU_W, CONV_W),
        state=lambda: RG.init_rglru_state(B, LRU_W, CONV_W, device="cpu"),
        fields=("h", "conv_tail")),
    "rwkv": dict(
        init=lambda: JRW.init_rwkv_block(jax.random.PRNGKey(0), D, HEAD, DECAY_LORA,
                                         TS_LORA)[0],
        jax_block=jax.jit(lambda p, x, state=None, mode="train": JRW.rwkv_block(
            p, x, head_size=HEAD, state=state, mode=mode), static_argnames="mode"),
        block=lambda p, x, **kw: RW.rwkv_block(p, x, head_size=HEAD, **kw),
        jax_state=lambda: JRW.init_rwkv_state(B, D, HEAD),
        state=lambda: RW.init_rwkv_state(B, D, HEAD, device="cpu"),
        fields=("s", "shift_tm", "shift_cm")),
}


def _setup(name):
    fam = FAMILIES[name]
    jp = fam["init"]()
    return fam, jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _x(t, seed, dtype):
    a = np.random.default_rng(seed).standard_normal((B, t, D)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["rglru", "rwkv"])
def test_block_train_prefill_decode_match_jax(name, dtype):
    """Train over 9 tokens; prefill 7 tokens from a zero state, prefill 5
    more continuing from it, then 3 decode steps: outputs in the input's
    dtype and every state tensor, against the JAX block."""
    fam, jp, tp = _setup(name)
    tol = BF16_TOL if dtype == "bf16" else F32_TOL
    jx, tx = _x(9, 0, dtype)
    jy, js = fam["jax_block"](jp, jx, mode="train")
    ty, ts = fam["block"](tp, tx, mode="train")
    assert ts is None and ty.dtype == tx.dtype and ty.shape == tx.shape
    _close(ty, jy, tol, "train")

    jstate, tstate = fam["jax_state"](), fam["state"]()
    for step, (t, mode) in enumerate([(7, "prefill"), (5, "prefill"), (1, "decode"),
                                      (1, "decode"), (1, "decode")]):
        jx, tx = _x(t, 10 + step, dtype)
        jy, jstate = fam["jax_block"](jp, jx, state=jstate, mode=mode)
        ty, out_state = fam["block"](tp, tx, state=tstate, mode=mode)
        assert out_state is tstate           # updated in place
        _close(ty, jy, tol, f"{mode} step {step}")
        _states_close(tstate, jstate, fam["fields"])


@pytest.mark.parametrize("name", ["rglru", "rwkv"])
def test_block_train_gradients_match_jax(name):
    """On the CPU the plain scans keep the blocks differentiable: gradients
    of sum(y * c) with respect to every weight and the input, against
    ``jax.grad`` of the JAX block."""
    fam, jp, tp = _setup(name)
    jx, tx = _x(9, 1, "f32")
    cot = np.random.default_rng(2).standard_normal((B, 9, D)).astype(np.float32)

    def jloss(p, x):
        return (fam["jax_block"](p, x, mode="train")[0] * cot).sum()
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jx)

    names = sorted(tp)
    leaves = [tp[n].clone().requires_grad_() for n in names] + [tx.clone().requires_grad_()]
    y, _ = fam["block"](dict(zip(names, leaves)), leaves[-1], mode="train")
    grads = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), leaves)
    for n, g in zip(names + ["x"], grads):
        _close(g, jgx if n == "x" else jgp[n], GRAD_TOL, n)


@pytest.mark.parametrize("name", ["rglru", "rwkv"])
def test_block_needs_state_outside_train(name):
    fam, _, tp = _setup(name)
    _, tx = _x(3, 0, "f32")
    with pytest.raises(ValueError, match="state"):
        fam["block"](tp, tx, mode="prefill")
    with pytest.raises(ValueError, match="mode"):
        fam["block"](tp, tx, mode="bogus")
    with pytest.raises(ValueError, match="one token"):
        fam["block"](tp, tx, state=fam["state"](), mode="decode")


def test_init_distributions():
    """``init_rglru_block``'s decay init (Griffin's: a = exp(-8 softplus(lam))
    spread over (0.9, 0.999)) and ``init_rwkv_block``'s constants and
    uniform / normal draws follow the JAX package's distributions (the
    draws differ: a torch.Generator is not a JAX key)."""
    gen = torch.Generator().manual_seed(0)
    p = RG.init_rglru_block(gen, 64, 1024, CONV_W)
    jp = JRG.init_rglru_block(jax.random.PRNGKey(0), 64, 1024, CONV_W)[0]
    # a is uniform on (0.9, 0.999): mean 0.9495, standard error 0.0009 here
    for lam in (p["lam"], torch.tensor(np.asarray(jp["lam"]))):
        a = torch.exp(-RG.C_CONST * torch.nn.functional.softplus(lam))
        assert 0.9 <= float(a.min()) and float(a.max()) <= 0.999
        assert abs(float(a.mean()) - 0.9495) < 0.004
    for k in ("conv_w", "w_rg"):
        assert abs(float(p[k].std()) - float(jnp.std(jp[k]))) < 0.05 * float(jnp.std(jp[k]))
    q = RW.init_rwkv_block(gen, 256, 64, 16, 8)
    jq = JRW.init_rwkv_block(jax.random.PRNGKey(0), 256, 64, 16, 8)[0]
    assert {k: tuple(v.shape) for k, v in q.items()} == {k: v.shape for k, v in jq.items()}
    torch.testing.assert_close(q["decay_base"], torch.full((256,), -6.0))
    torch.testing.assert_close(q["ln_x_scale"], torch.ones(256))
    assert 0.0 <= float(q["mu"].min()) and float(q["mu"].max()) < 1.0
    assert abs(float(q["mu"].mean()) - 0.5) < 0.05
    assert abs(float(q["u"].std()) - 0.1) < 0.02
