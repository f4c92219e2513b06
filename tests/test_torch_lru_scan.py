"""The port's RG-LRU scan held against the JAX package: its Pallas kernel run
in interpret mode through ``repro.kernels.ops.lru_scan`` (as
``tests/test_kernels.py`` runs it), the kernel oracle
``ref.reference_lru_scan`` and the model's associative scan
``models/rglru.py::lru_scan_ref``.

On the CPU ``ops.lru_scan`` takes the kernel's plain version; the CUDA
kernel itself is checked against it in ``test_torch_cuda.py``, and its
tiled walk (``lru_scan_tiled``, the kernel's arithmetic in plain torch) is
held here to the same JAX functions.  The Pallas
kernel starts from h0 = 0, so nonzero starting states are held to the two
jnp scans.  Tolerances (fp32 throughout): against the sequential oracle,
which adds in the same order, atol 1e-6; against the log-depth scans
(the Pallas kernel's in-tile combine, the model's ``associative_scan``),
which reassociate the products, 1e-5 of max(1, |h|).
"""

import re
from pathlib import Path

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
from repro_torch.kernels.lru_scan import TILE, WARPS, lru_scan_tiled
from repro_torch.launch import sweep_lru_scan

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
    """``ops.use("reference")`` is the CPU path itself, and so is the op's
    CPU implementation (``ops.use("op")``); an unknown impl raises; a meta tensor
    goes to the op's fake (shapes and dtypes, no time loop); on the CPU the
    plain scan is differentiable, with the gradients of ``jax.grad`` through
    the model's scan."""
    a, x, h0 = (torch.from_numpy(v) for v in _inputs(2, 9, 4, seed=3))
    with ops.use("reference"):
        plain = ops.lru_scan(a, x, h0)
    torch.testing.assert_close(ops.lru_scan(a, x, h0), plain, rtol=0, atol=0)
    with pytest.raises(ValueError, match="impl"), ops.use("pallas"):
        ops.lru_scan(a, x, h0)
    with ops.use("op"):
        through_op = ops.lru_scan(a, x, h0)
    torch.testing.assert_close(through_op, ops.lru_scan(a, x, h0), rtol=0, atol=0)
    fake = ops.lru_scan(a.to("meta"), x.to("meta"), h0.to("meta"))
    assert (fake.device.type, fake.shape, fake.dtype) == ("meta", a.shape, torch.float32)
    cot = np.random.default_rng(4).standard_normal(a.shape).astype(np.float32)
    leaves = [t.clone().requires_grad_() for t in (a, x, h0)]
    got = torch.autograd.grad((ops.lru_scan(*leaves) * torch.from_numpy(cot)).sum(), leaves)
    want = jax.grad(lambda *v: (jax_model_scan(*v) * cot).sum(), argnums=(0, 1, 2))(
        *(jnp.asarray(t.numpy()) for t in (a, x, h0)))
    for g, j in zip(got, want):
        _close_to_scan(g.numpy(), j)


#: decays at the ends of what the kernel may see, and the model's own:
#: a = u ** sigmoid(z) with u in the Griffin init's (0.9, 0.999) per channel
DECAYS = ["zero", "1e-30", "half", "gates", "one"]


def _decayed_inputs(b, t, w, decay, seed):
    rng = np.random.default_rng(seed)
    if decay == "gates":
        u = rng.uniform(0.9, 0.999, w)
        r = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, t, w))))
        a = (u ** r).astype(np.float32)
    else:
        value = {"zero": 0.0, "1e-30": 1e-30, "half": 0.5, "one": 1.0}[decay]
        a = np.full((b, t, w), value, np.float32)
    x = rng.standard_normal((b, t, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    return a, x, h0


def _edge_lengths(tile, warps):
    """T = 1, a sub-chunk and a tile each +-1, and three tiles and a bit."""
    sub = tile // warps
    return sorted({1, sub - 1, sub, sub + 1, tile - 1, tile, tile + 1,
                   2 * tile + sub + 1} - {0})


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("tile,warps,t", [(TILE, WARPS, t) for t in _edge_lengths(TILE, WARPS)]
                         + [(8, 4, t) for t in _edge_lengths(8, 4)])
def test_lru_scan_tiled_matches_jax(tile, warps, t, decay):
    """The kernel's tiled walk (its own tile and warps, and a small tile
    that puts many tiles in a short T) against the Pallas kernel in
    interpret mode from h0 = 0 and against the JAX oracle from a nonzero
    h0; W = 50, off the kernel's 32 channels a CTA.  Tolerance 1e-5 of
    max(1, |h|), at every decay: with a = 1, h is a running sum."""
    a, x, h0 = _decayed_inputs(2, t, 50, decay, seed=t * 7 + DECAYS.index(decay))
    tiled = lambda start: lru_scan_tiled(torch.from_numpy(a), torch.from_numpy(x),
                                         torch.from_numpy(start), tile=tile,
                                         warps=warps).numpy()
    got = tiled(np.zeros_like(h0))
    assert got.shape == (2, t, 50) and got.dtype == np.float32
    _close_to_scan(got, jops.lru_scan(jnp.asarray(a), jnp.asarray(x), time_tile=32,
                                      width_tile=32, batch_tile=2))
    _close_to_scan(tiled(h0), jref.reference_lru_scan(a, x, h0))


def test_lru_scan_tiled_walks_the_kernels_tiles():
    """The mirror's default tile and warps are the CUDA kernel's, and a tile
    that does not split into whole sub-chunks is refused."""
    src = (Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc/lru_scan.cu"
           ).read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kTile"]), int(consts["kWarps"])) == (TILE, WARPS)
    a = torch.ones(1, 4, 3)
    with pytest.raises(ValueError, match="multiple"):
        lru_scan_tiled(a, a, a[:, 0], tile=6, warps=4)


@pytest.mark.parametrize("layout", sweep_lru_scan.LAYOUTS, ids=lambda l: "_".join(map(str, l)))
def test_sweep_lru_scan_rewrites_the_kernels_layout(layout):
    """Each layout the sweep times is the kernel's source with its tile,
    warps, stages and shared-memory floor replaced; the first is the kernel
    as committed."""
    tile, warps, stages, floor_kb = layout
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);",
                             sweep_lru_scan.variant_source(*layout)))
    assert (int(consts["kTile"]), int(consts["kWarps"]), int(consts["kStages"])) == (
        tile, warps, stages)
    assert f"ring_bytes() > {floor_kb * 1024}" in sweep_lru_scan.variant_source(*layout)
    assert sweep_lru_scan.smem_bytes(*layout) >= floor_kb * 1024
    src = (Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc/lru_scan.cu"
           ).read_text()
    kept = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert sweep_lru_scan.LAYOUTS[0] == (int(kept["kTile"]), int(kept["kWarps"]),
                                         int(kept["kStages"]), 0)


GRAD_TOL = 1e-4        # of max(1, max |grad|), the CPU block gradient tests' bound


@pytest.mark.parametrize("b,t,w,lo,hi", [
    (2, 37, 24, 0.3, 0.999),
    (1, 1, 5, 0.3, 0.999),                  # T = 1: gh0 = a_0 gh_0
    (2, 129, 16, 0.9, 0.999),               # the model's decays, past a 128-step tile
    (1, 40, 8, 0.0, 1e-3),                  # a near 0: each h almost its x
    (1, 40, 8, 0.999, 1.0),                 # a near 1: a running sum
])
def test_lru_scan_plain_backward_matches_autograd_and_jax(b, t, w, lo, hi):
    """``ref.reference_lru_scan_bwd``, the reverse recurrence the backward
    kernel runs (from the forward's a, h, h0 and the gradient of h), against
    autograd through ``reference_lru_scan`` and ``jax.grad`` of the JAX
    model's ``lru_scan_ref`` (an associative scan) on the same numpy inputs:
    gx, ga and gh0, fp32, within 1e-4 of max(1, max |grad|)."""
    from repro_torch.kernels import ref
    a, x, h0 = _inputs(b, t, w, seed=t * w, lo=lo, hi=hi)
    gh = np.random.default_rng(t).standard_normal((b, t, w)).astype(np.float32)
    ta, tx, th0 = (torch.from_numpy(v).requires_grad_() for v in (a, x, h0))
    h = ref.reference_lru_scan(ta, tx, th0)
    auto = torch.autograd.grad(h, (tx, ta, th0), torch.from_numpy(gh))
    got = ref.reference_lru_scan_bwd(ta.detach(), h.detach(), th0.detach(),
                                     torch.from_numpy(gh))
    jgrads = jax.grad(lambda a_, x_, h0_: (jax_model_scan(a_, x_, h0_) * gh).sum(),
                      argnums=(1, 0, 2))(jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0))
    for name, g, want_auto, want_jax in zip(("gx", "ga", "gh0"), got, auto, jgrads):
        for want in (want_auto.numpy(), np.asarray(want_jax)):
            tol = GRAD_TOL * max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=tol, err_msg=name)


def test_lru_scan_bwd_wrapper_refuses_what_its_kernel_does_not_take():
    """The backward kernel's wrapper raises on CPU tensors (no fallback to
    the plain version), on mismatched shapes and on other dtypes; the
    kernel itself is checked on the card (``test_torch_cuda.py``)."""
    from repro_torch.kernels.lru_scan import lru_scan_bwd_cuda
    a, x, h0 = (torch.from_numpy(v) for v in _inputs(2, 9, 4, seed=3))
    with pytest.raises(ValueError, match="CUDA"):
        lru_scan_bwd_cuda(a, x, h0, x)
    with pytest.raises(ValueError, match="want"):
        lru_scan_bwd_cuda(a, x[:, :3], h0, x)
    with pytest.raises(TypeError, match="float32"):
        lru_scan_bwd_cuda(a.double(), x, h0, x)
