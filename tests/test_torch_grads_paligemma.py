"""Train-mode loss and every gradient of the port's paligemma-3b smoke
config (the vision_text frontend: projected patches as a bidirectional
prefix, the loss over the text positions after it) against
``jax.value_and_grad`` of the JAX package's ``compute_loss`` (check and
tolerances: ``_torch_grad_parity.py``).  On the card the same step runs the
flash backward at paligemma-3b's head_dim of 256 (``chip_smoke.py``)."""

import pytest

from _torch_grad_parity import check_loss_and_grads


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat):
    check_loss_and_grads("paligemma-3b", remat)
