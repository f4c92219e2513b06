"""Train-mode loss and every gradient of the port's recurrentgemma-9b smoke
config (rglru layers through the plain LRU scan and its autograd, and
local-attention layers) against ``jax.value_and_grad`` of the JAX package's
``compute_loss`` (check and tolerances: ``_torch_grad_parity.py``)."""

import pytest

from _torch_grad_parity import check_loss_and_grads


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat):
    check_loss_and_grads("recurrentgemma-9b", remat)
