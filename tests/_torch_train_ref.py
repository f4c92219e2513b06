"""The JAX package's ``sync="xla"`` training (jitted, one process, global
batch) as the reference for the port's training tests."""

import jax
import jax.numpy as jnp
import numpy as np

from _torch_model_parity import converted_params
from repro.data import make_batch as jax_make_batch
from repro.optim import AdamWConfig as JAdamWConfig
from repro.training import init_train_state as jax_init_train_state
from repro.training import make_train_step as jax_make_train_step


def jax_losses_and_params(arch: str, *, steps: int, seq_len: int, batch: int,
                          lr: float = 1e-3, warmup: int = 1, total: int = 100):
    """(losses, final params as float32 numpy leaves in JAX order)."""
    cfg, jp, _ = converted_params(arch)
    state = jax_init_train_state(jp)
    step = jax.jit(jax_make_train_step(cfg, JAdamWConfig(lr=lr), sync="xla",
                                       warmup_steps=warmup, total_steps=total))
    losses = []
    for i in range(steps):
        b = jax_make_batch(cfg, seq_len=seq_len, batch_size=batch, step=i)
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(state.params)]
