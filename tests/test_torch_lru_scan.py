"""The port's RG-LRU scan held against the JAX package: its Pallas kernel run
in interpret mode through ``repro.kernels.ops.lru_scan`` (as
``tests/test_kernels.py`` runs it), the kernel oracle
``ref.reference_lru_scan`` and the model's associative scan
``models/rglru.py::lru_scan_ref``.

On the CPU ``ops.lru_scan`` takes the kernel's plain version; the CUDA
kernel itself is checked against it in ``test_torch_cuda.py``.  The Pallas
kernel starts from h0 = 0, so nonzero starting states are held to the two
jnp scans.  Tolerances (fp32 throughout): against the sequential oracle,
which adds in the same order, atol 1e-6; against the log-depth scans
(the Pallas kernel's in-tile combine, the model's ``associative_scan``),
which reassociate the products, 1e-5 of max(1, |h|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.rglru import lru_scan_ref as jax_model_scan
from repro_torch.kernels import ops

SEQ_ATOL = 1e-6
SCAN_TOL = 1e-5


def _inputs(b, t, w, seed, lo=0.3, hi=0.999):
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, hi, (b, t, w)).astype(np.float32)
    x = rng.standard_normal((b, t, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    return a, x, h0


def _port(a, x, h0):
    return ops.lru_scan(torch.from_numpy(a), torch.from_numpy(x),
                        torch.from_numpy(h0)).numpy()


def _close_to_scan(got, want):
    want = np.asarray(want)
    tol = SCAN_TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("b,t,w", [(1, 64, 32), (2, 128, 64), (3, 100, 50)])
def test_lru_scan_shapes(b, t, w):
    """The port of ``test_lru_scan_shapes``: from h0 = 0 against the Pallas
    kernel (ragged T, W and B padded by the JAX wrapper) and the oracle;
    from a nonzero h0 against the oracle."""
    a, x, h0 = _inputs(b, t, w, seed=b * t + w)
    zero = np.zeros_like(h0)
    got = _port(a, x, zero)
    assert got.shape == (b, t, w) and got.dtype == np.float32
    _close_to_scan(got, jops.lru_scan(jnp.asarray(a), jnp.asarray(x), time_tile=32,
                                      width_tile=32, batch_tile=2))
    np.testing.assert_allclose(got, jref.reference_lru_scan(a, x, zero),
                               rtol=0, atol=SEQ_ATOL)
    np.testing.assert_allclose(_port(a, x, h0), jref.reference_lru_scan(a, x, h0),
                               rtol=0, atol=SEQ_ATOL)


@settings(max_examples=10, deadline=None)
@given(t=st.integers(2, 200), seed=st.integers(0, 20))
def test_lru_scan_property(t, seed):
    """The port of ``test_lru_scan_property``, with a nonzero h0 held to the
    model's associative scan."""
    a, x, h0 = _inputs(1, t, 16, seed, lo=0.1, hi=0.99)
    _close_to_scan(_port(a, x, np.zeros_like(h0)),
                   jops.lru_scan(jnp.asarray(a), jnp.asarray(x), time_tile=64,
                                 width_tile=16, batch_tile=1))
    _close_to_scan(_port(a, x, h0), jax_model_scan(jnp.asarray(a), jnp.asarray(x),
                                                   jnp.asarray(h0)))


def test_lru_matches_model_scan():
    """The port of ``test_lru_matches_model_scan``: the plain scan equals the
    RG-LRU model's associative scan, from zero and from a nonzero h0."""
    a, x, h0 = _inputs(2, 37, 8, seed=0, lo=0.2, hi=0.98)
    for start in (np.zeros_like(h0), h0):
        _close_to_scan(_port(a, x, start),
                       jax_model_scan(jnp.asarray(a), jnp.asarray(x), jnp.asarray(start)))


def test_lru_scan_dispatch_and_gradient_on_cpu():
    """``impl="reference"`` is the CPU path itself; an unknown impl or a
    device with no kernel raises; on the CPU the plain scan is
    differentiable, with the gradients of ``jax.grad`` through the model's
    scan."""
    a, x, h0 = (torch.from_numpy(v) for v in _inputs(2, 9, 4, seed=3))
    torch.testing.assert_close(ops.lru_scan(a, x, h0),
                               ops.lru_scan(a, x, h0, impl="reference"), rtol=0, atol=0)
    with pytest.raises(ValueError, match="impl"):
        ops.lru_scan(a, x, h0, impl="pallas")
    with pytest.raises(ValueError, match="device"):
        ops.lru_scan(a.to("meta"), x.to("meta"), h0.to("meta"))
    cot = np.random.default_rng(4).standard_normal(a.shape).astype(np.float32)
    leaves = [t.clone().requires_grad_() for t in (a, x, h0)]
    got = torch.autograd.grad((ops.lru_scan(*leaves) * torch.from_numpy(cot)).sum(), leaves)
    want = jax.grad(lambda *v: (jax_model_scan(*v) * cot).sum(), argnums=(0, 1, 2))(
        *(jnp.asarray(t.numpy()) for t in (a, x, h0)))
    for g, j in zip(got, want):
        _close_to_scan(g.numpy(), j)
