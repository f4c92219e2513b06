"""Train-mode loss, router aux loss included, and gradients of the port's
dbrx-132b smoke config (the MoE feed-forward) against ``jax.value_and_grad``
(check and tolerances: ``_torch_grad_parity.py``)."""

import pytest

from _torch_grad_parity import check_loss_and_grads


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat):
    check_loss_and_grads("dbrx-132b", remat)
