"""Prefill + decode parity of the port's model with the JAX package's on
paper-7b-smoke, glm4-smoke, deepseek-67b-smoke, gemma2-smoke, dbrx-smoke
(also with one leading dense layer, ``first_k_dense=1``), deepseek-v3-smoke
(MLA, a shared expert, one leading dense layer; prefill and decode do not
run its MTP head) and the two recurrent smoke configs (smollm-smoke: ``test_torch_model.py``; the check
and its tolerance: ``_torch_model_parity.py``).  recurrentgemma-smoke and
gemma2-smoke prefill 20 tokens, more than their local-attention window of
16, so that the ring buffer wraps and gemma2's global layers see keys its
local layers do not."""

import pytest

from _torch_model_parity import check_prefill_and_decode


@pytest.mark.parametrize("arch,prompt", [("paper-7b", 10), ("glm4-9b", 10),
                                         ("recurrentgemma-9b", 20), ("rwkv6-1.6b", 10),
                                         ("gemma2-27b", 20), ("deepseek-67b", 10),
                                         ("dbrx-132b", 10), ("deepseek-v3-671b", 10)])
def test_prefill_and_decode_match_jax(arch, prompt):
    check_prefill_and_decode(arch, prompt)


def test_prefill_and_decode_match_jax_first_k_dense():
    """dbrx-smoke with its first layer dense (``params["lead"]``) and the
    other MoE, as DeepSeek-style configs lay them out."""
    check_prefill_and_decode("dbrx-132b", 10, first_k_dense=1)


@pytest.mark.parametrize("arch", ["gemma2-27b", "deepseek-67b"])
def test_prefill_and_decode_match_jax_window_override(arch):
    """``window_override=8``: gemma2's global layers and deepseek's ``attn``
    layers attend over the last 8 keys, from 8-slot ring-buffer caches."""
    check_prefill_and_decode(arch, 20, window_override=8)
