from .synthetic import SyntheticConfig, SyntheticTokens, make_batch  # noqa: F401
