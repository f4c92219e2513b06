"""Shared check: the port's train-mode loss and every gradient against
``jax.value_and_grad`` of the JAX package's ``compute_loss``, from the same
weights (JAX ``init_model``) and batch, with ``cfg.remat`` off and on.

The JAX side runs op by op (``jax.disable_jit``), as the model parity tests
do: the residual stream is bf16, and compiled XLA keeps excess precision
there.  Tolerances: loss (and, apart, the MoE router's aux loss and the
MTP head's loss) atol 1e-3; each gradient leaf within 2e-2 of its own norm
(``||g_port - g_jax|| / ||g_jax||``).  Both come from bf16 roundings of the
residual stream that land differently in the two frameworks (measured at
most 8.5e-5 and 3.9e-3 on the smoke configs); a wrong gradient is off by
order one.  Split over test files so each stays short under
``--dist loadfile``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_model_parity import converted_params
from repro.training.train_step import compute_loss as jax_compute_loss
from repro_torch.data import make_batch
from repro_torch.models import get_smoke_config
from repro_torch.training import compute_loss, param_grads
from repro_torch.tree import leaves_with_path, unflatten

LOSS_ATOL, GRAD_RTOL = 1e-3, 2e-2


def check_loss_and_grads(arch: str, remat: bool) -> dict:
    """Returns the port's metrics."""
    cfg, jp, tp = converted_params(arch)
    jcfg = dataclasses.replace(cfg, remat=remat)
    tcfg = dataclasses.replace(get_smoke_config(arch), remat=remat)
    batch = make_batch(tcfg, seq_len=16, batch_size=2, step=0)

    def jloss(p):
        return jax_compute_loss(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})

    with jax.disable_jit():
        (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    paths, flat = zip(*leaves_with_path(tp))
    flat = [t.detach().clone().requires_grad_() for t in flat]
    params = unflatten(tp, flat)        # fresh leaves: the cached weights stay as they are
    tl, tm = compute_loss(params, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    tg = param_grads(tl, flat)

    assert set(tm) == set(jm) == {"loss", "aux_loss", "mtp_loss"}
    assert abs(tl.item() - float(jl)) <= LOSS_ATOL
    assert abs(tm["aux_loss"].item() - float(jm["aux_loss"])) <= LOSS_ATOL
    assert abs(tm["mtp_loss"].item() - float(jm["mtp_loss"])) <= LOSS_ATOL
    jflat = jax.tree_util.tree_leaves(jg)
    assert len(jflat) == len(tg)
    for path, a, b in zip(paths, tg, jflat):
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        assert a.shape == b.shape, path
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert rel <= GRAD_RTOL, ("/".join(path), rel)
    return tm

