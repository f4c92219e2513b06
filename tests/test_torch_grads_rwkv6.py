"""Train-mode loss and every gradient of the port's rwkv6-1.6b smoke config
(rwkv layers through the plain WKV recurrence and its autograd) against
``jax.value_and_grad`` of the JAX package's ``compute_loss`` (check and
tolerances: ``_torch_grad_parity.py``)."""

import pytest

from _torch_grad_parity import check_loss_and_grads


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat):
    check_loss_and_grads("rwkv6-1.6b", remat)
