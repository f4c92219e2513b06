"""Train-mode loss and gradients of the port's glm4-9b smoke config against
``jax.value_and_grad`` (check and tolerances: ``_torch_grad_parity.py``)."""

import pytest

from _torch_grad_parity import check_loss_and_grads


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat):
    check_loss_and_grads("glm4-9b", remat)
