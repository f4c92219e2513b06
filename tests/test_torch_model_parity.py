"""Prefill + decode parity of the port's model with the JAX package's on
paper-7b-smoke, glm4-smoke and the two recurrent smoke configs
(smollm-smoke: ``test_torch_model.py``; the check and its tolerance:
``_torch_model_parity.py``).  recurrentgemma-smoke prefills 20 tokens, more
than its local-attention window of 16, so that its ring buffer wraps."""

import pytest

from _torch_model_parity import check_prefill_and_decode


@pytest.mark.parametrize("arch,prompt", [("paper-7b", 10), ("glm4-9b", 10),
                                         ("recurrentgemma-9b", 20), ("rwkv6-1.6b", 10)])
def test_prefill_and_decode_match_jax(arch, prompt):
    check_prefill_and_decode(arch, prompt)
