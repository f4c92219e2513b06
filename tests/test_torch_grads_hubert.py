"""Train-mode loss and every gradient of the port's hubert-xlarge smoke
config (the audio_frames frontend, a non-causal encoder without rope, the
cross-entropy masked by ``loss_mask``) against ``jax.value_and_grad`` of
the JAX package's ``compute_loss`` (check and tolerances:
``_torch_grad_parity.py``)."""

import pytest

from _torch_grad_parity import check_loss_and_grads


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat):
    check_loss_and_grads("hubert-xlarge", remat)
