"""The port's RWKV-6 WKV recurrence held against the JAX package: its Pallas
kernel run in interpret mode through ``repro.kernels.ops.wkv_scan`` (as
``tests/test_kernels.py`` runs it), the kernel oracle ``ref.reference_wkv``
and the model's scan ``models/rwkv6.py::wkv_scan_ref``.

The port works in the model's layout, r/k/v/w (B, T, H, K) with u (H, K)
shared over the batch; the Pallas kernel takes (BH, T, K) rows with a u per
row, so a (BH, T, K) case is the port's B = 1, H = BH.  The Pallas kernel
starts from S = 0 and returns no final state, so nonzero starting states
and s_T are held to the model's scan.  On the CPU ``ops.wkv_scan`` takes
the kernel's plain version; the CUDA kernel itself is checked against it in
``test_torch_cuda.py``.  Tolerance: fp32 atol and rtol 1e-5 (the JAX
test's): each output sums K products, in another order in each framework.
The backward kernel's layout sweep (``launch/sweep_wkv_scan_bwd.py``) is
checked here for what it can be on the CPU: the sources it builds.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.rwkv6 import wkv_scan_ref as jax_model_scan
from repro_torch.kernels import ops
from repro_torch.launch import sweep_wkv_scan_bwd

TOL = 1e-5


def _inputs(shape_rkw, v_dim, u_shape, seed):
    rng = np.random.default_rng(seed)
    r, k = ((rng.standard_normal(shape_rkw) * 0.3).astype(np.float32) for _ in range(2))
    v = (rng.standard_normal(shape_rkw[:-1] + (v_dim,)) * 0.3).astype(np.float32)
    w = rng.uniform(0.5, 0.99, shape_rkw).astype(np.float32)
    u = (rng.standard_normal(u_shape) * 0.1).astype(np.float32)
    return r, k, v, w, u


def _port(r, k, v, w, u, s0):
    out, s_t = ops.wkv_scan(*(torch.from_numpy(a) for a in (r, k, v, w, u, s0)))
    return out.numpy(), s_t.numpy()


@pytest.mark.parametrize("bh,t,kd,vd", [(2, 32, 8, 8), (1, 100, 16, 16)])
def test_wkv_scan_shapes(bh, t, kd, vd):
    """The port of ``test_wkv_scan_shapes``: (BH, T, K) rows as B = 1,
    H = BH, against the Pallas kernel (ragged T padded by the JAX wrapper)
    and the oracle."""
    r, k, v, w, u = _inputs((bh, t, kd), vd, (bh, kd), seed=bh * t)
    want = np.asarray(jops.wkv_scan(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                                    time_tile=16))
    oracle = np.asarray(jref.reference_wkv(r, k, v, w, u))

    def model(a):
        return a.transpose(1, 0, 2)[None]            # (BH,T,K) -> (1,T,BH,K)
    out, s_t = _port(model(r), model(k), model(v), model(w), u,
                     np.zeros((1, bh, kd, vd), np.float32))
    assert out.shape == (1, t, bh, vd) and s_t.shape == (1, bh, kd, vd)
    got = out[0].transpose(1, 0, 2)                   # back to (BH,T,V)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, oracle, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("zero_state", [True, False])
def test_wkv_matches_model_scan(zero_state):
    """The port of ``test_wkv_matches_model_scan``: output and final state
    against the RWKV-6 model's scan, from S = 0 and from a nonzero S_0."""
    B, T, H, K = 2, 24, 3, 8
    r, k, v, w, u = _inputs((B, T, H, K), K, (H, K), seed=0)
    s0 = np.zeros((B, H, K, K), np.float32) if zero_state else \
        (np.random.default_rng(1).standard_normal((B, H, K, K)) * 0.5).astype(np.float32)
    want_out, want_s = jax_model_scan(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    out, s_t = _port(r, k, v, w, u, s0)
    np.testing.assert_allclose(out, np.asarray(want_out), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(s_t, np.asarray(want_s), atol=TOL, rtol=TOL)


def test_wkv_scan_dispatch_and_gradient_on_cpu():
    """``ops.use("reference")`` is the CPU path itself, and so is the op's
    CPU implementation (``ops.use("op")``); an unknown impl raises; a meta tensor
    goes to the op's fake; on the CPU the plain recurrence is
    differentiable, with the gradients of ``jax.grad`` through the model's
    scan (of output and final state)."""
    B, T, H, K = 1, 4, 2, 3
    ins = _inputs((B, T, H, K), K, (H, K), seed=5)
    s0 = np.random.default_rng(6).standard_normal((B, H, K, K)).astype(np.float32)
    ts = [torch.from_numpy(a) for a in (*ins, s0)]
    with ops.use("reference"):
        b = ops.wkv_scan(*ts)
    for x, y in zip(ops.wkv_scan(*ts), b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    with pytest.raises(ValueError, match="impl"), ops.use("pallas"):
        ops.wkv_scan(*ts)
    with ops.use("op"):
        through_op = ops.wkv_scan(*ts)
    for x, y in zip(through_op, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    fake = ops.wkv_scan(*(t.to("meta") for t in ts))
    assert [(t.device.type, t.shape) for t in fake] == [("meta", y.shape) for y in b]
    rng = np.random.default_rng(7)
    c_out = rng.standard_normal((B, T, H, K)).astype(np.float32)
    c_s = rng.standard_normal((B, H, K, K)).astype(np.float32)
    leaves = [t.clone().requires_grad_() for t in ts]
    out, s_t = ops.wkv_scan(*leaves)
    loss = (out * torch.from_numpy(c_out)).sum() + (s_t * torch.from_numpy(c_s)).sum()
    got = torch.autograd.grad(loss, leaves)

    def jloss(*v):
        o, s = jax_model_scan(*v)
        return (o * c_out).sum() + (s * c_s).sum()
    want = jax.grad(jloss, argnums=tuple(range(6)))(*(jnp.asarray(t.numpy()) for t in ts))
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=TOL, rtol=TOL)


GRAD_TOL = 1e-4        # of max(1, max |grad|), the CPU block gradient tests' bound


@pytest.mark.parametrize("b,t,h,k,decays,with_gs", [
    (2, 37, 3, 8, "uniform", False),
    (2, 37, 3, 8, "uniform", True),
    (1, 1, 2, 16, "uniform", True),                 # T = 1
    (2, 33, 2, 16, "hard", False),                  # off the kernel's 16-step chunks
    (1, 20, 3, 8, "hard", True),
])
def test_wkv_plain_backward_matches_autograd_and_jax(b, t, h, k, decays, with_gs):
    """``ref.reference_wkv_bwd``, the reverse walk the backward kernel runs
    (from the forward's inputs, the gradient of its output and, or not,
    that of its final state), against autograd through ``reference_wkv``
    and ``jax.grad`` of the JAX model's ``wkv_scan_ref`` (a ``lax.scan``) on
    the same numpy inputs, nonzero s0: the gradients of r, k, v, w, u and
    s0, fp32, within 1e-4 of max(1, max |grad|).  ``hard``: the decays
    ``test_wkv_scan_kernel_matches_plain_at_hard_decays`` uses on the card,
    w = exp(-exp(dec)) with dec up to +3 (w down to ~2e-9) and every fifth
    step's rows w = 1."""
    from repro_torch.kernels import ref
    r, kk, v, w, u = _inputs((b, t, h, k), k, (h, k), seed=t * h + k)
    rng = np.random.default_rng(t)
    if decays == "hard":
        dec = np.clip(3.0 * rng.standard_normal((b, t, h, k)), -9.0, 3.0)
        w = np.exp(-np.exp(dec)).astype(np.float32)
        w[:, 2::5] = 1.0
    s0 = (rng.standard_normal((b, h, k, k)) * 0.5).astype(np.float32)
    gy = rng.standard_normal((b, t, h, k)).astype(np.float32)
    gs = rng.standard_normal((b, h, k, k)).astype(np.float32) if with_gs else None
    ins = [torch.from_numpy(a).requires_grad_() for a in (r, kk, v, w, u, s0)]
    out, s_t = ref.reference_wkv(*ins)
    loss = (out * torch.from_numpy(gy)).sum()
    if with_gs:
        loss = loss + (s_t * torch.from_numpy(gs)).sum()
    auto = torch.autograd.grad(loss, ins)
    got = ref.reference_wkv_bwd(*(x.detach() for x in ins), torch.from_numpy(gy),
                                None if gs is None else torch.from_numpy(gs))

    def jloss(*args):
        o, s = jax_model_scan(*args)
        return (o * gy).sum() + ((s * gs).sum() if with_gs else 0.0)
    jgrads = jax.grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in (r, kk, v, w, u, s0)))
    for name, g, want_auto, want_jax in zip(("gr", "gk", "gv", "gw", "gu", "gs0"),
                                            got, auto, jgrads):
        for want in (want_auto.numpy(), np.asarray(want_jax)):
            tol = GRAD_TOL * max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=tol, err_msg=name)


def test_wkv_scan_bwd_wrapper_refuses_what_its_kernel_does_not_take():
    """The backward kernel's wrapper raises on CPU tensors (no fallback),
    without the forward's per-chunk states, on a checkpoint of the wrong
    shape and on a head size with no kernel instantiation."""
    from repro_torch.kernels.wkv_scan import CHUNK, wkv_scan_bwd_cuda
    B, T, H, K = 1, 20, 2, 16
    r, k, v, w, u = (torch.from_numpy(a) for a in _inputs((B, T, H, K), K, (H, K), seed=5))
    ckpt = torch.zeros(B, H, -(-T // CHUNK), K, K)
    with pytest.raises(ValueError, match="CUDA"):
        wkv_scan_bwd_cuda(r, k, v, w, u, ckpt, v)
    with pytest.raises(ValueError, match="ckpt"):
        wkv_scan_bwd_cuda(r, k, v, w, u, None, v)
    with pytest.raises(ValueError, match="ckpt"):
        wkv_scan_bwd_cuda(r, k, v, w, u, ckpt[:, :, :1], v)
    r8, k8, v8, w8, u8 = (torch.from_numpy(a) for a in _inputs((B, T, H, 8), 8, (H, 8), seed=5))
    with pytest.raises(ValueError, match="head sizes"):
        wkv_scan_bwd_cuda(r8, k8, v8, w8, u8, ckpt[..., :8, :8].contiguous(), v8)


_CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"
_CONSTS = ("kCols", "kCpt", "kSteps", "kHist", "kExch", "kMinBlocks")


@pytest.mark.parametrize("layout", sweep_wkv_scan_bwd.LAYOUTS,
                         ids=lambda l: "_".join(map(str, l)))
def test_sweep_wkv_scan_bwd_rewrites_the_kernels_layout(layout):
    """Each layout the sweep times is the backward kernel's source with its
    columns a CTA and a thread, steps a reduction, states held, chunks an
    exchange and CTAs an SM replaced; the first is the kernel as committed."""
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);",
                             sweep_wkv_scan_bwd.variant_source(*layout)))
    assert tuple(int(consts[n]) for n in _CONSTS) == layout
    kept = dict(re.findall(r"constexpr int (k\w+) = (\d+);",
                           (_CSRC / "wkv_scan_bwd.cu").read_text()))
    assert sweep_wkv_scan_bwd.LAYOUTS[0] == tuple(int(kept[n]) for n in _CONSTS)


@pytest.mark.parametrize("ablation", sorted(sweep_wkv_scan_bwd.ABLATIONS))
def test_sweep_wkv_scan_bwd_ablations_cut_their_stage(ablation, tmp_path, monkeypatch):
    """An ablation replaces its stage's text everywhere it occurs in the
    source, beside the layout's constants, and the sweep refuses a source
    that lacks the text.  Held on a stand-in source, not the kernel's own
    text, which the ablations need only on the card."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "CSRC", tmp_path)
    consts = "".join(f"constexpr int {n} = 1;\n" for n in _CONSTS)
    src = tmp_path / "wkv_scan_bwd.cu"
    src.write_text(consts)
    first = sweep_wkv_scan_bwd.ABLATIONS[ablation][0][0]
    with pytest.raises(RuntimeError, match=re.escape(repr(first))):
        sweep_wkv_scan_bwd.variant_source(*sweep_wkv_scan_bwd.LAYOUTS[0], ablation)
    src.write_text(consts + "".join(f"{old} a;\n{old} b;\n"
                                    for old, _ in sweep_wkv_scan_bwd.ABLATIONS[ablation]))
    cut = sweep_wkv_scan_bwd.variant_source(*sweep_wkv_scan_bwd.LAYOUTS[0], ablation)
    for old, new in sweep_wkv_scan_bwd.ABLATIONS[ablation]:
        assert f"{new} a;\n" in cut and f"{new} b;\n" in cut
    assert dict(re.findall(r"constexpr int (k\w+) = (\d+);", cut)) == {
        n: str(x) for n, x in zip(_CONSTS, sweep_wkv_scan_bwd.LAYOUTS[0])}
