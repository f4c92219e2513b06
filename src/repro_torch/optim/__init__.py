from .adamw import AdamWConfig, adamw_update, clip_by_global_norm, global_norm, init_opt_state  # noqa: F401
from .schedules import cosine_with_warmup  # noqa: F401
