"""The port's models in PyTorch: GQA transformers (dense, local/global, MoE) and
the recurrent families (RG-LRU, RWKV-6)."""

from .registry import ARCHITECTURES, get_config, get_smoke_config, list_architectures  # noqa: F401
from .transformer import (apply_model, cache_rows, init_caches, init_model,  # noqa: F401
                          model_axes, reset_caches)
