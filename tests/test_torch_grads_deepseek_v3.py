"""Train-mode loss, router aux loss, the MTP head's loss and every gradient
of the port's deepseek-v3-671b smoke config (MLA, a shared expert, one
leading dense layer, the MTP head) against ``jax.value_and_grad`` of the JAX
package's ``compute_loss`` (check and tolerances: ``_torch_grad_parity.py``).
On the CPU attention runs its plain version, which autograd differentiates
at MLA's head_dim of 48; on the card the backward kernel's 192-wide template
takes deepseek-v3's head_dim (``test_torch_cuda.py``)."""

import pytest

from _torch_grad_parity import check_loss_and_grads


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat):
    metrics = check_loss_and_grads("deepseek-v3-671b", remat)
    assert metrics["mtp_loss"].item() > 0 and metrics["aux_loss"].item() > 0
