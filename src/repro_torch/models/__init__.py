"""Dense llama-family models in PyTorch."""

from .registry import ARCHITECTURES, get_config, get_smoke_config, list_architectures  # noqa: F401
from .transformer import apply_model, init_caches, init_model  # noqa: F401
