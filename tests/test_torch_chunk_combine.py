"""The port's chunk_combine (the R2CCL stage-2 merge) held against the JAX
package's Pallas kernel, run in interpret mode through
``repro.kernels.ops.chunk_combine`` as ``tests/test_kernels.py`` runs it.

On the CPU ``ops.chunk_combine`` takes the kernel's plain version; the CUDA
kernel itself is checked against it in ``test_torch_cuda.py``.  Tolerance:
fp32 atol 1e-6 (the JAX test's); bf16 exact, since both add in fp32 and
round once to bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref
from repro_torch.kernels.chunk_combine import chunk_combine_cuda


def _inputs(c, m, seed):
    rng = np.random.default_rng(seed)
    local = rng.normal(size=(c, m)).astype(np.float32)
    recv = rng.normal(size=(c, m)).astype(np.float32)
    seg = rng.integers(0, 2, c).astype(np.int32)
    acc = rng.integers(0, 2, c).astype(np.int32)
    return local, recv, seg, acc


def _jax(local, recv, seg, acc, dtype):
    out = jops.chunk_combine(jnp.asarray(local, dtype), jnp.asarray(recv, dtype),
                             jnp.asarray(seg), jnp.asarray(acc), tile=128)
    return np.asarray(out.astype(jnp.float32))


@settings(max_examples=15, deadline=None)
@given(c=st.integers(1, 12), m=st.integers(1, 700), seed=st.integers(0, 99))
def test_chunk_combine_property_fp32(c, m, seed):
    local, recv, seg, acc = _inputs(c, m, seed)
    want = _jax(local, recv, seg, acc, jnp.float32)
    out = ops.chunk_combine(torch.from_numpy(local), torch.from_numpy(recv),
                            torch.from_numpy(seg), torch.from_numpy(acc))
    np.testing.assert_allclose(out.numpy(), want, atol=1e-6)


@settings(max_examples=15, deadline=None)
@given(c=st.integers(1, 12), m=st.integers(1, 700), seed=st.integers(0, 99))
def test_chunk_combine_property_bf16_in_place(c, m, seed):
    """bf16, merged in place (``out=local``), as the collectives call it."""
    local, recv, seg, acc = _inputs(c, m, seed)
    want = _jax(local, recv, seg, acc, jnp.bfloat16)
    tl = torch.from_numpy(local).to(torch.bfloat16)
    tr = torch.from_numpy(recv).to(torch.bfloat16)
    out = ops.chunk_combine(tl, tr, seg.astype(bool), acc.astype(bool), out=tl)
    assert out is tl and tl.dtype == torch.bfloat16
    np.testing.assert_array_equal(tl.float().numpy(), want)


def test_every_seg_acc_pair():
    local = torch.arange(8, dtype=torch.float32).view(4, 2)
    recv = torch.full((4, 2), 100.0)
    out = ops.chunk_combine(local, recv, [0, 0, 1, 1], [0, 1, 0, 1])
    assert out.tolist() == [[0, 1], [2, 3], [100, 100], [106, 107]]
    assert local.tolist() == [[0, 1], [2, 3], [4, 5], [6, 7]]     # not in place


def test_cpu_takes_plain_path_without_counting():
    local, recv, seg, acc = (torch.from_numpy(a) for a in _inputs(3, 9, 0))
    ops.reset_launch_counts()
    out = ops.chunk_combine(local, recv, seg, acc)
    assert not any(ops.launch_counts().values())
    torch.testing.assert_close(out, ref.reference_chunk_combine(local, recv, seg, acc),
                               rtol=0, atol=0)


def test_kernel_wrapper_refuses_what_it_does_not_take():
    local, recv = torch.zeros(2, 5), torch.zeros(2, 5)
    with pytest.raises(ValueError, match="CUDA"):
        chunk_combine_cuda(local, recv, [1, 1], [1, 1])
    with pytest.raises(TypeError):
        chunk_combine_cuda(local.double(), recv.double(), [1, 1], [1, 1])
    with pytest.raises(TypeError):
        chunk_combine_cuda(local, recv.bfloat16(), [1, 1], [1, 1])
    with pytest.raises(ValueError, match="C, M"):
        chunk_combine_cuda(local, torch.zeros(2, 6), [1, 1], [1, 1])
    # a meta tensor goes to the op's fake: the output's shape, no values
    assert ops.chunk_combine(local.to("meta"), recv.to("meta"), [1, 1], [1, 1]).shape == (2, 5)
