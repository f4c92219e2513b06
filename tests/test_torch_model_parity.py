"""Prefill + decode parity of the port's model with the JAX package's on
paper-7b-smoke and glm4-smoke (smollm-smoke: ``test_torch_model.py``; the
check and its tolerance: ``_torch_model_parity.py``)."""

import pytest

from _torch_model_parity import check_prefill_and_decode


@pytest.mark.parametrize("arch", ["paper-7b", "glm4-9b"])
def test_prefill_and_decode_match_jax(arch):
    check_prefill_and_decode(arch)
