"""Learning-rate schedules (pure functions of the step counter).

The port of the JAX package's ``optim/schedules.py``, computed in float32
as the JAX package computes it.  Step 0 has scale 0, also with
``warmup_steps=0``: the warm-up factor is ``step / max(warmup_steps, 1)``.
"""

from __future__ import annotations

import numpy as np


def cosine_with_warmup(step, *, warmup_steps: int, total_steps: int,
                       min_ratio: float = 0.1) -> np.float32:
    f = np.float32
    step = f(step)
    warm = np.minimum(step / f(max(warmup_steps, 1)), f(1.0))
    progress = np.clip((step - f(warmup_steps)) /
                       f(max(total_steps - warmup_steps, 1)), f(0.0), f(1.0))
    cos = f(0.5) * (f(1.0) + np.cos(f(np.pi) * progress))
    return f(warm * (f(min_ratio) + (f(1.0) - f(min_ratio)) * cos))
