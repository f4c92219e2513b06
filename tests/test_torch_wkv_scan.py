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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.rwkv6 import wkv_scan_ref as jax_model_scan
from repro_torch.kernels import ops

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
    """``impl="reference"`` is the CPU path itself; an unknown impl or a
    device with no kernel raises; on the CPU the plain recurrence is
    differentiable, with the gradients of ``jax.grad`` through the model's
    scan (of output and final state)."""
    B, T, H, K = 1, 4, 2, 3
    ins = _inputs((B, T, H, K), K, (H, K), seed=5)
    s0 = np.random.default_rng(6).standard_normal((B, H, K, K)).astype(np.float32)
    ts = [torch.from_numpy(a) for a in (*ins, s0)]
    a, b = ops.wkv_scan(*ts), ops.wkv_scan(*ts, impl="reference")
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    with pytest.raises(ValueError, match="impl"):
        ops.wkv_scan(*ts, impl="pallas")
    with pytest.raises(ValueError, match="device"):
        ops.wkv_scan(*(t.to("meta") for t in ts))
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
